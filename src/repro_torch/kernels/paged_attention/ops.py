"""Paged-attention entry point: default page and padding of the cache.

The JAX package's ``planned_page`` (its page from ``core.planner.plan_kv_pages``)
is not ported.  The planner is (``core/planner.py``), but under the H100's
figures ``plan_kv_pages`` finds no feasible page for any KV width above 56
bytes a token: its budget, an eighth of a CTA's shared memory (29,056 bytes),
must hold four double-buffered pages of at least 128 tokens.  gemma-2b's one
KV head of 256 bf16 values is 512 bytes a token.  The default page is
``min(S, 128)``, as in the JAX entry point.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.paged_attention.paged_attention import (
    LATENT_DIMS, latent_decode, paged_attention, paged_attention_int8)


def _paged(q: torch.Tensor, caches, lengths: torch.Tensor, page: Optional[int]):
    """(caches, page): on the CPU each cache padded on S to a page multiple
    (masked by lengths) for the plain version, which walks pages; the kernel
    takes any S, so a CUDA tensor is never copied."""
    s = caches[0].shape[1]
    page = page or min(s, 128)
    pad = (-s) % page
    if pad and runtime.on_cpu(q, lengths, *caches):
        caches = [F.pad(c, (0, 0, 0, 0, 0, pad)) for c in caches]
    return caches, page


def remop_paged_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor, page: Optional[int] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q: [B, KV, G, hd]; caches [B, S, KV, hd]; lengths [B]; scores capped,
    ``tanh(s / softcap) * softcap``, when ``softcap > 0``.
    """
    (k_cache, v_cache), page = _paged(q, (k_cache, v_cache), lengths, page)
    return paged_attention(q, k_cache, v_cache, lengths.to(torch.int32), page=page,
                           softcap=softcap)


def remop_paged_attention_int8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                               k_scale: torch.Tensor, v_scale: torch.Tensor,
                               lengths: torch.Tensor, page: Optional[int] = None,
                               softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over ``repro``'s int8 KV cache: int8 k_q/v_q [B, S,
    KV, hd], bf16 scales [B, S, KV, 1] (:func:`paged_attention_int8`)."""
    caches, page = _paged(q, (k_q, v_q, k_scale, v_scale), lengths, page)
    return paged_attention_int8(q, *caches, lengths.to(torch.int32), page=page, softcap=softcap)


def remop_latent_decode(q: torch.Tensor, latent: torch.Tensor, lengths: torch.Tensor,
                        scale: float, v_dim: int = LATENT_DIMS[1]) -> torch.Tensor:
    """MLA's absorbed decode over the latent cache: q [B, H, D], latent
    [B, S, D], lengths [B] -> [B, H, v_dim], the values the rows' first
    ``v_dim`` columns (:func:`latent_decode`; any S, the cache never copied)."""
    return latent_decode(q, latent, lengths.to(torch.int32), scale, v_dim)
