"""Causal GQA flash attention (prefill) as a CUDA kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention`` of the JAX package's
``kernels/flash_attention/flash_attention.py``: ``q [B, H, S, hd]``,
``k, v [B, KV, T, hd]``, query head ``h`` reading KV head ``h // (H / KV)``,
causal with the query positions offset by ``T - S``, an online softmax in
f32 over KV blocks of ``bk`` positions, fully masked blocks skipped, output
in q's dtype.  Unlike the TPU kernel it takes any ``S <= T`` (rows and
columns past the ends are masked) and any strides with a contiguous last
dimension, so the model hands it ``[B, S, H, hd]`` activations as
transposed views and gets its output back in the same layout.

Beside the wrapper is its plain PyTorch version, the same online softmax
over the same KV blocks; a CPU tensor takes it, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import runtime

NEG_INF = -1e30
# Largest bq and bk the kernel takes: 256 threads as 16 x 16, each holding
# 4 query rows of the f32 accumulator in registers.
MAX_BLOCK = 64
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def smem_bytes(bq: int, bk: int, hd: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one CTA: q and K/V tiles (rows padded by one
    32-bit word) in the input dtype, plus the f32 P tile ``[bq, bk + 1]``."""
    return (bq + bk) * (hd * dtype_bytes + 4) + bq * (bk + 1) * 4


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B,H,S,hd] and k, v [B,KV,T,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[2] < s:
        raise ValueError(f"more queries ({s}) than keys ({k.shape[2]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {sorted(map(str, _DTYPES))}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bk: int = MAX_BLOCK) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: online softmax over KV blocks of ``bk``.

    All query rows take every block; a block the kernel skips is fully
    masked for the rows it would skip it for, and adds exactly 0 there.
    """
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, kv, h // kv, s, hd)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    m = torch.full((b, kv, h // kv, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, t, bk):
        kb = k[:, :, k0:k0 + bk].float()
        vb = v[:, :, k0:k0 + bk].float()
        sc = torch.einsum("bkgsd,bktd->bkgst", qf, kb) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb[:, :, None])
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(b, h, s, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = MAX_BLOCK, bk: int = MAX_BLOCK) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KV, T, hd]; causal with offset T - S.

    On a CUDA tensor ``bq, bk`` must lie in ``[1, 64]`` and ``hd`` in
    ``HEAD_DIMS``; the output has q's strides where q is dense.  Query
    blocks do not change any row's arithmetic, so the plain version
    takes only ``bk``.
    """
    _check(q, k, v)
    if runtime.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, bk)
    b, h, s, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (1 <= bq <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"bq={bq}, bk={bk} must lie in [1, {MAX_BLOCK}]")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be contiguous")
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    strides = (ctypes.c_longlong * 12)(
        *(st for x in (q, k, v, out) for st in (x.stride(0), x.stride(1), x.stride(2))))
    lib = runtime.library("flash_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"remop_flash_attention_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, h, kv, s, t, hd, bq, bk,
            1.0 / math.sqrt(hd), runtime.stream_of(q))
    runtime.check("flash_attention", "flash_attention", err)
    runtime.launches["flash_attention"] += 1
    return out
