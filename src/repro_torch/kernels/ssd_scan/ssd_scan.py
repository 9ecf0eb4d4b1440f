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

    On a CUDA tensor both inputs must be contiguous.
    """
    _check(states, decays)
    if runtime.on_cpu(states, decays):
        return ssd_scan_plain(states, decays)
    runtime.refuse_grad("ssd_scan", "the ssd_scan backward (and mamba2-370m training)",
                        states, decays)
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
