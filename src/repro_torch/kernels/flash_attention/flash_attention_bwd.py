"""The gradient of the flash kernel, and the autograd Function around both.

The TPU kernel ``flash_attention`` of the JAX package's
``kernels/flash_attention/flash_attention.py`` has no backward: ``repro``
trains through XLA's autodiff of ``full_attention``/``chunked_attention``
(``models/attention.py``).  The port's forward on the card is the
hand-written flash kernel, whose launch records nothing for autograd, so its
gradient is a hand-written kernel too (``csrc/flash_attention_bwd.cu``,
the library ``flash_attention_bwd``): given q, k, v, the forward's output
and that output's gradient it returns (dq, dk, dv) of what the forward
computes, with the same mask (causal with offset ``T - S``, ``window``,
``prefix``, every key at ``prefix >= T``), ``scale`` and ``softcap``.  It
runs as three launches (``prep``: each row's log-sum-exp and ``D = sum(dO
* O)``; ``dq``; ``dkdv``, the GQA group summed inside one CTA), on the CUDA
cores, bf16 or f32, at ``(hd, hd_v)`` in :data:`BWD_HEAD_PAIRS`, with no
atomics: two calls give the same bits.  ``runtime.launches`` counts every
call under ``"flash_attention_bwd"``.

Beside it is its plain PyTorch version, the same formulas in f32 over the
same KV blocks; a CPU tensor takes it, a CUDA tensor launches the kernel or
raises.

:class:`FlashAttentionFn` runs the forward wrapper unchanged and saves q,
k, v and the output; its backward is :func:`flash_attention_bwd`.
``ops.remop_flash_attention`` goes through it only under grad, so serving
(``torch.inference_mode``) keeps its launches, bits and time.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.flash_attention import (
    NEG_INF, SMEM_LIMIT, _DTYPES, _check, first_block, flash_attention, hidden_keys,
)

# (hd, hd_v) the backward kernel takes: the widths the repo's configs train at.
BWD_HEAD_PAIRS = ((64, 64), (128, 128), (256, 256), (192, 128))
# Square blocks (bq = bk), largest first: the first whose three kernels fit a CTA.
BWD_BLOCKS = (64, 32, 16)
BWD_KERNELS = ("prep", "dq", "dkdv")


def bwd_smem_bytes(kernel: str, bq: int, bk: int, hd: int, hd_v: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one CTA of ``kernel``: staged rows of ``w``
    values padded by one 32-bit word; ``prep`` holds Q and a K block,
    ``dq`` Q, dO, one K/V block and the f32 dS tile, ``dkdv`` its K and V,
    a Q and a dO block, the f32 P^T and dS^T tiles and the block's lse and D."""
    row, row_v = (hd * dtype_bytes + 4), (hd_v * dtype_bytes + 4)
    if kernel == "prep":
        return (bq + bk) * row
    if kernel == "dq":
        return (bq + bk) * row + bq * row_v + bq * (bk + 1) * 4
    return (bk + bq) * (row + row_v) + 2 * bk * (bq + 1) * 4 + 2 * bq * 4


def plan_bwd_blocks(hd: int, hd_v: int, dtype_bytes: int) -> int:
    """The largest block of :data:`BWD_BLOCKS` whose three kernels fit in
    the shared memory one CTA may use (64 but for f32 at hd 256: 32)."""
    for b in BWD_BLOCKS:
        if all(bwd_smem_bytes(kind, b, b, hd, hd_v, dtype_bytes) <= SMEM_LIMIT
               for kind in BWD_KERNELS):
            return b
    raise ValueError(f"no backward block fits hd={hd}, hd_v={hd_v}")


def check_bwd_widths(hd: int, hd_v: int) -> None:
    """Raise ``ValueError`` for head widths the backward kernel does not take."""
    if (hd, hd_v) not in BWD_HEAD_PAIRS:
        raise ValueError(f"the flash backward kernel takes (hd, hd_v) in {BWD_HEAD_PAIRS}, got "
                         f"{(hd, hd_v)}; training at this width waits for a later slice")


def cap_grad(capped: torch.Tensor, softcap: float) -> torch.Tensor:
    """The cap's derivative at a capped score ``s_c = c tanh(s / c)``:
    ``1 - (s_c / c)^2``."""
    return 1 - (capped / softcap) ** 2


def _check_grads(q, out, dout) -> None:
    want = (*q.shape[:3], out.shape[3])
    if tuple(out.shape) != want or tuple(dout.shape) != want:
        raise ValueError(f"out and dout must be {want}, got {tuple(out.shape)} and "
                         f"{tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must be {q.dtype}, got {out.dtype} and {dout.dtype}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor,
                              scale: float | None = None, window: int = 0, prefix: int = 0,
                              softcap: float = 0.0, bk: int = BWD_BLOCKS[0]):
    """The kernel's arithmetic in PyTorch, in f32 over KV blocks of ``bk``:
    each row's log-sum-exp over its visible keys (an online max and sum)
    and ``D = sum(dO * O)``, then per block ``P = exp(s_c - lse)`` (0 where
    hidden), ``dV += P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)`` times
    ``1 - (s_c / c)^2`` when capped, ``dQ += dS K``, ``dK += dS^T Q``; dQ
    and dK times ``scale``; each rounded once to the inputs' dtype.  The
    blocks before the first one any row sees (under a window) get 0."""
    _check(q, k, v, window, prefix)
    _check_grads(q, out, dout)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    qf = q.float().reshape(b, kv, g, s, hd)
    dof = dout.float().reshape(b, kv, g, s, hd_v)
    delta = (dof * out.float().reshape(b, kv, g, s, hd_v)).sum(-1, keepdim=True)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    start = first_block(t - s, window, bk) * bk
    blocks = range(start, t, bk)

    def scores(k0):
        kb = k[:, :, k0:k0 + bk].float()
        sc = runtime.cap_scores(torch.einsum("bkgsd,bktd->bkgst", qf, kb) * scale, softcap)
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        return kb, sc, hidden_keys(q_pos, k_pos, window, prefix)

    m = torch.full((b, kv, g, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    for k0 in blocks:
        _, sc, hidden = scores(k0)
        sc = sc.masked_fill(hidden, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(sc - m_new).sum(dim=-1, keepdim=True)
        m = m_new
    lse = m + torch.log(l)

    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, kv, t, hd), device=q.device)
    dv = torch.zeros((b, kv, t, hd_v), device=q.device)
    for k0 in blocks:
        kb, sc, hidden = scores(k0)
        vb = v[:, :, k0:k0 + bk].float()
        p = torch.exp(sc - lse).masked_fill(hidden, 0.0)
        dv[:, :, k0:k0 + bk] = torch.einsum("bkgst,bkgsd->bktd", p, dof)
        ds = p * (torch.einsum("bkgsd,bktd->bkgst", dof, vb) - delta)
        if softcap:
            ds = ds * cap_grad(sc, softcap)
        dq += torch.einsum("bkgst,bktd->bkgsd", ds, kb)
        dk[:, :, k0:k0 + bk] = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    return ((dq * scale).reshape(b, h, s, hd).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, scale: float | None = None,
                        window: int = 0, prefix: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, scale=scale, window=window,
    prefix=prefix, softcap=softcap)`` whose output is ``out``, given its
    gradient ``dout`` [B, H, S, hd_v]; each gradient in its input's shape,
    dtype and (where it is dense) memory layout.

    On a CUDA tensor ``(hd, hd_v)`` must lie in :data:`BWD_HEAD_PAIRS` and
    the last dimension of all five inputs must be contiguous (any other
    strides); blocks are :func:`plan_bwd_blocks`'.
    """
    _check(q, k, v, window, prefix)
    _check_grads(q, out, dout)
    softcap = runtime.check_softcap(softcap)
    b, h, s, hd = q.shape
    kv, t, hd_v = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if runtime.on_cpu(q, k, v, out, dout):
        return flash_attention_bwd_plain(q, k, v, out, dout, scale, window, prefix, softcap)
    check_bwd_widths(hd, hd_v)
    if any(x.stride(-1) != 1 for x in (q, k, v, out, dout)):
        raise ValueError("the last dimension of q, k, v, out and dout must be contiguous")
    blk = plan_bwd_blocks(hd, hd_v, q.element_size())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(
        *(st for x in (q, k, v, out, dout, dq, dk, dv)
          for st in (x.stride(0), x.stride(1), x.stride(2))))
    lib = runtime.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"remop_flash_attention_bwd_{_DTYPES[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ctypes.addressof(strides), b, h, kv, s, t, hd, blk, blk, scale, hd_v, window,
            prefix, softcap, runtime.stream_of(q))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
    runtime.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def bwd_attributes(dtype: torch.dtype, hd: int, hd_v: int) -> dict:
    """Registers, local (spilled) bytes a thread and the largest CTA of the
    ``prep``, ``dq`` and ``dkdv`` kernels at these widths, on the current card."""
    check_bwd_widths(hd, hd_v)
    out = (ctypes.c_int * 9)()
    err = runtime.library("flash_attention_bwd").remop_flash_attention_bwd_attributes(
        int(dtype == torch.float32), hd, hd_v, ctypes.addressof(out))
    runtime.check("flash_attention_bwd", "flash_attention_bwd", err)
    return {kind: dict(zip(("registers", "local_bytes", "max_threads"), out[3 * i:3 * i + 3]))
            for i, kind in enumerate(BWD_KERNELS)}


class FlashAttentionFn(torch.autograd.Function):
    """The flash kernel under autograd: the forward wrapper as it is (q, k,
    v, the output saved), its gradient :func:`flash_attention_bwd`.  On a
    CUDA tensor a width the backward does not take raises before the
    forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, bq: int, bk: int, scale: float | None, window: int, prefix: int,
                softcap: float):
        if not runtime.on_cpu(q, k, v):
            check_bwd_widths(q.shape[3], v.shape[3])
        scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
        out = flash_attention(q, k, v, bq=bq, bk=bk, scale=scale, window=window, prefix=prefix,
                              softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (scale, window, prefix, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None
