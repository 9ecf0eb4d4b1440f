"""Paged decode attention (flash-decoding) as a CUDA kernel for Hopper.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``paged_attention`` of the JAX package's
``kernels/paged_attention/paged_attention.py``: ``q [B, KV, G, hd]``,
caches ``[B, S, KV, hd]``, ``lengths [B]`` int32; the cache is walked one
page at a time with an online f32 softmax and positions ``>= lengths[b]``
masked.  One CTA serves up to 8 query heads of one (batch, KV head), so a
KV head's G heads take ``ceil(G / 8)`` CTAs (any G); each stops at the last
page that holds an unmasked position.

Beside the wrapper is its plain PyTorch version, the same page-by-page
online softmax; a CPU tensor takes it, a CUDA tensor launches the kernel
or raises.  :func:`check_shape` is the wrapper's pre-launch check of what
the kernel takes, callable on the host without a card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def check_shape(g: int, hd: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch for G query heads
    per KV head at head width ``hd``: any ``G >= 1``, ``hd`` in ``HEAD_DIMS``."""
    if g < 1:
        raise ValueError(f"G={g} query heads per KV head; need at least 1")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} must be in {HEAD_DIMS}")


def _check(q, k_cache, v_cache, lengths, page: int) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be [B,KV,G,hd] and caches [B,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, kv, _, hd = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (b, kv, hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} {tuple(lengths.shape)}")
    if page < 1 or k_cache.shape[1] % page:
        raise ValueError(f"page={page} must divide S={k_cache.shape[1]}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q and caches must share one dtype of {sorted(map(str, _DTYPES))}")


def paged_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor, page: int = 128) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: online softmax page by page.

    Every page is taken; a page past a row's length is fully masked and
    adds exactly 0 to that row.
    """
    b, kv, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, kv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for p0 in range(0, k_cache.shape[1], page):
        kp = k_cache[:, p0:p0 + page].float()
        vp = v_cache[:, p0:p0 + page].float()
        sc = torch.einsum("bkgd,btkd->bkgt", qf, kp) * scale
        pos = torch.arange(p0, p0 + kp.shape[1], device=q.device)
        masked = pos[None, :] >= lengths[:, None]  # [B, page]
        sc = sc.masked_fill(masked[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgt,btkd->bkgd", p, vp)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, page: int = 128) -> torch.Tensor:
    """q: [B, KV, G, hd]; k/v_cache: [B, S, KV, hd]; lengths: [B] int32 in [1, S].

    On a CUDA tensor all four must be contiguous and pass
    :func:`check_shape`.
    """
    _check(q, k_cache, v_cache, lengths, page)
    if runtime.on_cpu(q, k_cache, v_cache, lengths):
        return paged_attention_plain(q, k_cache, v_cache, lengths, page)
    b, kv, g, hd = q.shape
    check_shape(g, hd)
    tensors = (q, k_cache, v_cache, lengths)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, the caches and lengths must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors[:3]):
        raise ValueError("q and the caches must start on a 16-byte boundary")
    out = torch.empty_like(q)
    lib = runtime.library("paged_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"remop_paged_attention_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, kv, g, k_cache.shape[1], hd, page,
            1.0 / math.sqrt(hd), runtime.stream_of(q))
    runtime.check("paged_attention", "paged_attention", err)
    runtime.launches["paged_attention"] += 1
    return out
