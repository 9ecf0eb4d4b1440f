"""SSD inter-chunk state scan (Mamba-2's sequential hot spot) as a CUDA kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel ``ssd_scan`` of the
JAX package's ``kernels/ssd_scan/ssd_scan.py``: with an f32 carry starting
at zero, ``carry_{c+1} = carry_c * decays[:, c] + states[:, c]``; it returns
``prev`` (the carry entering each chunk) and ``final`` (the carry after the
last chunk), both in the states' dtype.  Each thread holds the carry of a
few consecutive elements of one (batch, head) in registers and loops over
the chunks.

Beside the wrapper is its plain PyTorch version, the same loop over chunks
(multiply, then add, each rounded in f32); a CPU tensor takes it, a CUDA
tensor launches the kernel or raises.

The gradient is a hand-written kernel too (``ssd_scan_bwd``, in the same
source; the JAX package takes it by XLA's autodiff of ``jax.lax.scan``):
with ``G_NC = dfinal`` and ``G_c = dprev[:, c] + G_{c+1} * decays[:, c]``
in f32, ``dstates[:, c] = G_{c+1}`` and ``ddecays[:, c, h]`` the sum of
``G_{c+1} * prev[:, c]`` over the head's ``P * N`` elements, written in the
inputs' dtype.  ``dstates`` equals :func:`ssd_scan_bwd_plain` bit for bit;
``ddecays`` sums in another order (per warp, then the partials in order:
no atomics, so two calls give the same bits).  :class:`SsdScanFn` is the
scan under autograd: :func:`ssd_scan` takes it whenever a call needs a
gradient, on the CPU too, where its backward is the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import runtime

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check(states: torch.Tensor, decays: torch.Tensor) -> None:
    if states.dim() != 5 or decays.dim() != 3 or tuple(decays.shape) != tuple(states.shape[:3]):
        raise ValueError(f"states must be [B,NC,H,P,N] and decays [B,NC,H]; got "
                         f"{tuple(states.shape)}, {tuple(decays.shape)}")
    if states.shape[1] < 1:
        raise ValueError("states must hold at least one chunk")
    if states.dtype not in _DTYPES or decays.dtype != states.dtype:
        raise TypeError(f"states and decays must share one dtype of "
                        f"{sorted(map(str, _DTYPES))}; got {states.dtype}, {decays.dtype}")


def ssd_scan_plain(states: torch.Tensor,
                   decays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch: an f32 carry, chunk by chunk."""
    prev = torch.empty_like(states)
    carry = torch.zeros(states[:, 0].shape, dtype=torch.float32, device=states.device)
    for c in range(states.shape[1]):
        prev[:, c] = carry.to(states.dtype)
        carry = carry * decays[:, c, :, None, None].float() + states[:, c].float()
    return prev, carry.to(states.dtype)


def ssd_scan(states: torch.Tensor, decays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """states: [B, NC, H, P, N]; decays: [B, NC, H] ->
    (prev [B, NC, H, P, N], final [B, H, P, N]), in the states' dtype.

    On a CUDA tensor both inputs must be contiguous.  A call that needs a
    gradient goes through :class:`SsdScanFn`.
    """
    _check(states, decays)
    if runtime.needs_grad(states, decays):
        return SsdScanFn.apply(states, decays)
    if runtime.on_cpu(states, decays):
        return ssd_scan_plain(states, decays)
    if not (states.is_contiguous() and decays.is_contiguous()):
        raise ValueError("states and decays must be contiguous")
    b, nc, h, p, n = states.shape
    prev = torch.empty_like(states)
    final = torch.empty((b, h, p, n), dtype=states.dtype, device=states.device)
    lib = runtime.library("ssd_scan")
    with torch.cuda.device(states.device):
        err = getattr(lib, f"remop_ssd_scan_{_DTYPES[states.dtype]}")(
            states.data_ptr(), decays.data_ptr(), prev.data_ptr(), final.data_ptr(),
            b, nc, h, p * n, runtime.stream_of(states))
    runtime.check("ssd_scan", "ssd_scan", err)
    runtime.launches["ssd_scan"] += 1
    return prev, final


# The backward kernel's threads a CTA (csrc/ssd_scan.cu's kThreads): each
# thread takes 16 bytes of a row and each warp writes one f32 partial of
# ddecays; the C entry checks the partials a row it is given.
BWD_THREADS = 256


def bwd_parts(pn: int, dtype: torch.dtype) -> int:
    """ddecays' f32 partials a (b, c, h) row: the warps of the CTAs that
    share a row of ``pn`` elements, ``16 / itemsize`` elements a thread."""
    per_cta = BWD_THREADS * (16 // dtype.itemsize)
    return -(-pn // per_cta) * (BWD_THREADS // 32)


def _check_bwd(dprev, dfinal, prev, decays) -> None:
    _check(prev, decays)
    if tuple(dprev.shape) != tuple(prev.shape) or tuple(dfinal.shape) != (
            prev.shape[0], *prev.shape[2:]):
        raise ValueError(f"dprev must be {tuple(prev.shape)} and dfinal "
                         f"{(prev.shape[0], *prev.shape[2:])}; got {tuple(dprev.shape)}, "
                         f"{tuple(dfinal.shape)}")
    if dprev.dtype != prev.dtype or dfinal.dtype != prev.dtype:
        raise TypeError(f"dprev and dfinal must be {prev.dtype}; got {dprev.dtype}, "
                        f"{dfinal.dtype}")


def ssd_scan_bwd_plain(dprev: torch.Tensor, dfinal: torch.Tensor, prev: torch.Tensor,
                       decays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in PyTorch: G carried in f32 from
    the last chunk to the first; ``ddecays`` summed by ``torch.sum``."""
    dstates = torch.empty_like(prev)
    ddecays = torch.empty_like(decays)
    g = dfinal.float()
    for c in reversed(range(prev.shape[1])):
        dstates[:, c] = g.to(prev.dtype)
        ddecays[:, c] = (g * prev[:, c].float()).sum(dim=(-2, -1)).to(decays.dtype)
        if c:
            g = g * decays[:, c, :, None, None].float() + dprev[:, c].float()
    return dstates, ddecays


def ssd_scan_bwd(dprev: torch.Tensor, dfinal: torch.Tensor, prev: torch.Tensor,
                 decays: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dstates [B, NC, H, P, N], ddecays [B, NC, H]) of :func:`ssd_scan`
    given the gradients of its outputs, its ``prev`` and the decays, in
    their dtype.  On a CUDA tensor all four must be contiguous; the kernel's
    two launches count once, under ``"ssd_scan_bwd"``."""
    _check_bwd(dprev, dfinal, prev, decays)
    if runtime.on_cpu(dprev, dfinal, prev, decays):
        return ssd_scan_bwd_plain(dprev, dfinal, prev, decays)
    if not all(x.is_contiguous() for x in (dprev, dfinal, prev, decays)):
        raise ValueError("dprev, dfinal, prev and decays must be contiguous")
    b, nc, h, p, n = prev.shape
    parts = bwd_parts(p * n, prev.dtype)
    dstates = torch.empty_like(prev)
    ddecays = torch.empty_like(decays)
    partial = torch.empty((b, nc, h, parts), dtype=torch.float32, device=prev.device)
    lib = runtime.library("ssd_scan")
    with torch.cuda.device(prev.device):
        err = getattr(lib, f"remop_ssd_scan_bwd_{_DTYPES[prev.dtype]}")(
            dprev.data_ptr(), dfinal.data_ptr(), prev.data_ptr(), decays.data_ptr(),
            dstates.data_ptr(), ddecays.data_ptr(), partial.data_ptr(), b, nc, h, p * n, parts,
            runtime.stream_of(prev))
    runtime.check("ssd_scan_bwd", "ssd_scan", err)
    runtime.launches["ssd_scan_bwd"] += 1
    return dstates, ddecays


class SsdScanFn(torch.autograd.Function):
    """The scan under autograd: the forward wrapper (``prev`` and the
    decays saved), its gradient :func:`ssd_scan_bwd`: the kernel on CUDA
    tensors, the plain version on CPU tensors.  A failed build or launch
    raises; nothing falls back to autograd of the plain loop."""

    @staticmethod
    def forward(ctx, states, decays):
        prev, final = ssd_scan(states, decays)
        ctx.save_for_backward(prev, decays)
        return prev, final

    @staticmethod
    def backward(ctx, dprev, dfinal):
        prev, decays = ctx.saved_tensors
        return ssd_scan_bwd(dprev.contiguous(), dfinal.contiguous(), prev, decays)
