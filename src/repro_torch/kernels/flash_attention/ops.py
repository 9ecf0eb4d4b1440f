"""Flash-attention entry point with REMOP block planning for Hopper."""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_BLOCK,
    SMEM_LIMIT,
    TC_BLOCKS,
    TC_HEAD_PAIRS,
    flash_attention,
    route,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.flash_attention_bwd import FlashAttentionFn

# Shared memory one CTA may use on an H100 (227 KB of the SM's 256 KB).
HOPPER_SMEM_BYTES = SMEM_LIMIT
# The TPU planner's candidates (128 .. 1024) scaled to what one CTA holds,
# per route: the CUDA-core kernel keeps bq rows of the accumulator in 256
# threads' registers, so its blocks stop at 64; the tensor-core kernel
# takes wgmma's 64 rows a warpgroup.
BLOCK_CANDIDATES = {"simt": (16, 32, MAX_BLOCK), "tc": TC_BLOCKS}


def default_route(hd: int, dtype_bytes: int, hd_v: Optional[int] = None) -> str:
    """The route a TMA-aligned call of these head widths and dtype takes."""
    pair = (hd, hd if hd_v is None else hd_v)
    return "tc" if dtype_bytes == 2 and pair in TC_HEAD_PAIRS else "simt"


@functools.lru_cache(maxsize=None)
def plan_blocks(s: int, t: int, hd: int, dtype_bytes: int = 2,
                smem_budget: Optional[int] = None,
                path: Optional[str] = None, hd_v: Optional[int] = None) -> Tuple[int, int]:
    """(bq, bk) minimizing KV staging rounds under the shared-memory budget.

    Rounds ~ ceil(S/bq) * ceil(T/bk) (each round stages one KV block); the
    working set is :func:`smem_bytes` of ``path`` (by default the route an
    aligned call of these head widths and dtype takes; ``hd_v`` defaults to
    ``hd``), over that route's candidates.  Ties keep the smaller blocks, as the TPU planner's
    ascending scan does; when nothing fits, the smallest.  The kernels mask
    ragged ends, so unlike the TPU planner no candidate has to divide S or T.
    Plans depend on the arguments alone and are memoised (a prefill plans
    once per layer).
    """
    smem_budget = smem_budget or HOPPER_SMEM_BYTES
    path = path or default_route(hd, dtype_bytes, hd_v)
    candidates = BLOCK_CANDIDATES[path]
    best = (candidates[0], candidates[0])
    best_rounds = math.inf
    for bq in candidates:
        for bk in candidates:
            if smem_bytes(bq, bk, hd, dtype_bytes, path, hd_v) > smem_budget:
                continue
            rounds = math.ceil(s / bq) * math.ceil(t / bk)
            if rounds < best_rounds:
                best_rounds = rounds
                best = (bq, bk)
    return best


def remop_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bq: Optional[int] = None,
                          bk: Optional[int] = None,
                          scale: Optional[float] = None,
                          window: int = 0, prefix: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """q: [B, H, S, hd]; k: [B, KV, T, hd]; v: [B, KV, T, hd_v]; causal with
    offset T - S, and with ``window > 0`` each query sees its last ``window``
    keys only, with ``prefix > 0`` also every key below ``prefix`` (all of
    them at ``prefix >= T``); ``scale`` defaults to ``1 / sqrt(hd)``; with
    ``softcap > 0`` the scaled scores are capped, ``tanh(s / softcap) *
    softcap``.  Blocks are planned as without a window, a prefix or a cap,
    as ``repro``'s planner has none of them.

    Blocks not given are planned for the route the call takes; on the
    CUDA-core route they are cut to S and T (its threads cover bq x bk).
    Under grad (grad enabled and q, k or v requiring it) the call goes
    through :class:`FlashAttentionFn`, whose backward is the flash
    backward kernel; otherwise the kernel is called directly and no graph
    is built.
    """
    s, hd = q.shape[2], q.shape[3]
    t, hd_v = k.shape[2], v.shape[3]
    path = route(q, k, v)
    if bq is None or bk is None:
        pbq, pbk = plan_blocks(s, t, hd, q.element_size(), path=path, hd_v=hd_v)
        bq, bk = bq or pbq, bk or pbk
    if path == "simt":
        bq, bk = min(bq, s), min(bk, t)
    if runtime.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, bq, bk, scale, window, prefix, softcap)
    return flash_attention(q, k, v, bq=bq, bk=bk, scale=scale, window=window, prefix=prefix,
                           softcap=softcap)
