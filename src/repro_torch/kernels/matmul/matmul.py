"""Blocked matmul (the BNLJ analogue of the paper's §III-A) as a CUDA kernel.

The kernel (``csrc/matmul.cu``) replaces the TPU kernel ``matmul_pallas`` of
the JAX package's ``kernels/matmul/matmul.py:47``: ``a [M, K] @ b [K, N]``
tiled ``(bm, bn, bk)`` with ``M % bm == N % bn == K % bk == 0`` (the caller
pads), an f32 accumulator over K and the product cast once to ``out_dtype``.
One CTA owns one ``(bm, bn)`` output tile; each K step stages one A tile and
one B tile in shared memory, so a step is one of the planner's rounds.

Beside the wrapper is its plain PyTorch version, the same sweep over K
steps with an f32 accumulator; a CPU tensor takes it, a CUDA tensor launches
the kernel or raises.  :func:`check_tiles` is the wrapper's pre-launch check
of what the kernel takes, callable on the host without a card.
"""

from __future__ import annotations

from typing import Optional

import ctypes

import torch

from repro_torch.core.cost_model import H100
from repro_torch.kernels import runtime

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
THREADS = 256  # threads of one CTA
MAX_ACC = 32  # f32 accumulators one thread may hold (64 x 128 tiles: 32)
SMEM_BYTES = H100.vmem_bytes  # shared memory one CTA can use


def check_tiles(bm: int, bn: int, bk: int, elem_bytes: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch with these tiles.

    A thread owns one column of the tile and every ``THREADS // bn``-th row,
    so ``bn <= THREADS`` and a thread holds ``ceil(bm / (THREADS // bn))``
    accumulators, at most ``MAX_ACC``; the staged A and B tiles,
    ``(bm*bk + bk*bn) * elem_bytes``, must fit ``SMEM_BYTES``.
    """
    if min(bm, bn, bk) < 1:
        raise ValueError(f"tiles must be positive; got {(bm, bn, bk)}")
    if bn > THREADS:
        raise ValueError(f"bn={bn} exceeds the kernel's {THREADS} threads (one column each)")
    acc = -(-bm // (THREADS // bn))
    if acc > MAX_ACC:
        raise ValueError(f"tile ({bm}, {bn}) needs {acc} accumulators a thread; "
                         f"the kernel holds at most {MAX_ACC}")
    smem = (bm * bk + bk * bn) * elem_bytes
    if smem > SMEM_BYTES:
        raise ValueError(f"tiles {(bm, bn, bk)} stage {smem} bytes; a CTA has {SMEM_BYTES}")


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
           out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be [M,K] and b [K,N]; got {tuple(a.shape)}, {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"tiles {(bm, bn, bk)} must divide (M, N, K) = {(m, n, k)}; "
                         "the caller pads")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one dtype of {sorted(map(str, _DTYPES))}; "
                        f"got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be one of {sorted(map(str, _DTYPES))}; got {out_dtype}")
    return out_dtype


def matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's sweep in PyTorch: an f32 accumulator, one K step at a
    time, cast once at the end."""
    out_dtype = _check(a, b, bm, bn, bk, out_dtype)
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(out_dtype)


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: [M, K]; b: [K, N] -> [M, N] in ``out_dtype`` (default a's).

    ``M % bm == N % bn == K % bk == 0`` (the caller pads).  On a CUDA tensor
    the elements of each row of ``a`` and ``b`` must be contiguous (rows
    may be strided) and the tiles must pass :func:`check_tiles`.
    """
    out_dtype = _check(a, b, bm, bn, bk, out_dtype)
    if runtime.on_cpu(a, b):
        return matmul_tiled_plain(a, b, bm, bn, bk, out_dtype)
    check_tiles(bm, bn, bk, a.element_size())
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("the elements of each row of a and b must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    vec = 16 // a.element_size()  # elements of one 16-byte load
    wide = (bk % vec == 0 and bn % vec == 0 and a.stride(0) % vec == 0
            and b.stride(0) % vec == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = runtime.library("matmul")
    with torch.cuda.device(a.device):
        err = getattr(lib, f"remop_matmul_{_DTYPES[a.dtype]}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
            bm, bn, bk, int(out_dtype == torch.float32), int(wide), runtime.stream_of(a))
    runtime.check("matmul", "matmul", err)
    runtime.launches["matmul"] += 1
    return out


def resident_ctas(bm: int, bn: int, bk: int, dtype: torch.dtype = torch.bfloat16,
                  wide: bool = True) -> int:
    """CTAs of the kernel with these tiles that one SM of the current card
    holds at once (CUDA's occupancy calculator: registers, shared memory,
    threads); ``wide`` picks the instantiation for 16-byte-aligned tiles."""
    check_tiles(bm, bn, bk, dtype.itemsize)
    ctas = ctypes.c_int(0)
    lib = runtime.library("matmul")
    err = getattr(lib, f"remop_matmul_resident_ctas_{_DTYPES[dtype]}")(
        bm, bn, bk, int(wide), ctypes.addressof(ctas))
    runtime.check("matmul", "matmul", err)
    return ctas.value
