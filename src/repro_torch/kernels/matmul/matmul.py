"""Blocked matmul (the BNLJ analogue of the paper's §III-A) as CUDA kernels.

The kernels (``csrc/matmul.cu``) replace the TPU kernel ``matmul_pallas`` of
the JAX package's ``kernels/matmul/matmul.py:47``: ``a [M, K] @ b [K, N]``
tiled ``(bm, bn, bk)``, an f32 accumulator over K and the product cast once
to ``out_dtype``.  One CTA owns one ``(bm, bn)`` output tile; each K step
copies one A tile and one B tile into shared memory, so a step is one of the
planner's rounds.  bf16 runs on the tensor cores (``wgmma`` fed by TMA
through a two-slot ring); f32 runs exact f32 FMAs on the CUDA cores.

Three routes, each with its own launch counter in ``runtime.launches``:
``"matmul"`` (bf16, TMA), ``"matmul_staged"`` (bf16, element-staged: a row
stride or base not 16-byte aligned, or ``bk`` or ``bn`` not a multiple of
64) and ``"matmul_f32"``.

Beside the wrapper is its plain PyTorch version, the same sweep over K
steps with an f32 accumulator; a CPU tensor takes it, a CUDA tensor launches
a kernel or raises.  :func:`check_tiles` and :func:`ring_bytes` are the
wrapper's pre-launch checks and the kernel's shared memory, callable on the
host without a card.
"""

from __future__ import annotations

from typing import Optional

import ctypes

import torch

from repro_torch.core.cost_model import H100
from repro_torch.kernels import runtime

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
SMEM_BYTES = H100.vmem_bytes  # shared memory one CTA can use
# bf16 (tensor cores): wgmma's N, which bm is padded up to; a warpgroup per
# 64 columns of bn; N x warpgroups bounded by the registers (N / 2 f32
# accumulators a thread); a ring of two slots.
MMA_N = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256)
MAX_BN = 256
MAX_ACC_REGS = 512
RING_STAGES = 2
# f32 (CUDA cores): one column of the tile a thread, at most MAX_ACC rows.
THREADS = 256
MAX_ACC = 32


def mma_n(bm: int) -> int:
    """wgmma's N for a tile of ``bm`` rows: the next of ``MMA_N``."""
    return next(n for n in MMA_N if n >= bm)


def ring_slot_bytes(bm: int, bn: int, sub: int) -> int:
    """One ring slot: ``ceil(sub / 64)`` chunks of ``mma_n(bm)`` A rows of 128
    bytes, and ``ceil(bn / 64)`` chunks of ``sub`` B rows of 128 bytes."""
    return -(-sub // 64) * mma_n(bm) * 128 + -(-bn // 64) * sub * 128


def ring_bytes(bm: int, bn: int, sub: int) -> int:
    """Shared memory a bf16 CTA asks for: the two slots, 1024 bytes to align
    them to the swizzle atom, and four 8-byte mbarriers."""
    return 1024 + RING_STAGES * ring_slot_bytes(bm, bn, sub) + 32


def ring_sub(bm: int, bn: int, bk: int, tma: bool) -> int:
    """The K depth of one ring slot: the whole step ``bk`` (padded to 16)
    when two slots fit a CTA, else the largest even split of it (in units of
    64 on the TMA route, 16 on the element route) that does."""
    unit = 64 if tma else 16
    units = -(-bk // unit)
    for parts in range(1, units + 1):
        if units % parts == 0 and ring_bytes(bm, bn, units // parts * unit) <= SMEM_BYTES:
            return units // parts * unit
    raise ValueError(f"tiles {(bm, bn, bk)}: no ring slot fits a CTA")


def f32_sub(bm: int, bn: int, bk: int) -> int:
    """The K depth staged at once on the f32 route: the whole step when it
    fits a CTA, else the step split evenly into the fewest parts that fit
    (a multiple of 4, for 16-byte staging)."""
    fit = SMEM_BYTES // ((bm + bn) * 4)
    if bk <= fit:
        return bk
    fit -= fit % 4
    parts = -(-bk // fit)
    sub = -(-bk // parts)
    return min(sub + (-sub) % 4, fit)


def check_tiles(bm: int, bn: int, bk: int, elem_bytes: int) -> None:
    """Raise ``ValueError`` unless the kernel for this element size can
    launch with these tiles.

    bf16 (2 bytes): ``bm <= 256`` (wgmma's N, padded to ``MMA_N``), ``bn <=
    256`` (a warpgroup per 64 columns), and ``mma_n(bm) * ceil(bn / 64) <=
    MAX_ACC_REGS`` (the accumulators a CTA holds); any ``bk`` (a step too deep
    for the ring is split, see :func:`ring_sub`).  f32 (4 bytes): ``bn <=
    THREADS`` and ``ceil(bm / (THREADS // bn)) <= MAX_ACC`` accumulators a
    thread; any ``bk`` (staged in sub-steps, see :func:`f32_sub`).
    """
    if min(bm, bn, bk) < 1:
        raise ValueError(f"tiles must be positive; got {(bm, bn, bk)}")
    if elem_bytes == 2:
        if bm > MMA_N[-1] or bn > MAX_BN:
            raise ValueError(f"tiles {(bm, bn, bk)}: the tensor-core kernel takes bm <= "
                             f"{MMA_N[-1]} and bn <= {MAX_BN}")
        regs = mma_n(bm) * -(-bn // 64)
        if regs > MAX_ACC_REGS:
            raise ValueError(f"tiles {(bm, bn, bk)}: {mma_n(bm)} accumulator columns on "
                             f"{-(-bn // 64)} warpgroups exceed the registers "
                             f"({MAX_ACC_REGS} a CTA)")
        return
    if bn > THREADS:
        raise ValueError(f"bn={bn} exceeds the kernel's {THREADS} threads (one column each)")
    acc = -(-bm // (THREADS // bn))
    if acc > MAX_ACC:
        raise ValueError(f"tile ({bm}, {bn}) needs {acc} accumulators a thread; "
                         f"the kernel holds at most {MAX_ACC}")


def tma_route(a: torch.Tensor, b: torch.Tensor, bn: int, bk: int) -> bool:
    """True when a bf16 product can take the TMA route: 16-byte-aligned
    bases and row strides, and ``bk`` and ``bn`` whole 128-byte boxes."""
    return (a.dtype == torch.bfloat16 and a.shape[1] > 0 and bk % 64 == 0 and bn % 64 == 0
            and a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a must be [M,K] and b [K,N]; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one dtype of {sorted(map(str, _DTYPES))}; "
                        f"got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be one of {sorted(map(str, _DTYPES))}; got {out_dtype}")
    return out_dtype


def _check_divides(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int) -> None:
    (m, k), n = a.shape, b.shape[1]
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"tiles {(bm, bn, bk)} must divide (M, N, K) = {(m, n, k)}; "
                         "the caller pads")


def matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's sweep in PyTorch: an f32 accumulator, one K step at a
    time, cast once at the end."""
    out_dtype = _check(a, b, out_dtype)
    _check_divides(a, b, bm, bn, bk)
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(out_dtype)


def launch(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors of any (M, K) x (K, N): the last
    row, column and K tiles are masked in the kernel, nothing is padded.

    The elements of each row of ``a`` and ``b`` must be contiguous (rows may
    be strided) and the tiles must pass :func:`check_tiles`.
    """
    out_dtype = _check(a, b, out_dtype)
    if runtime.on_cpu(a, b):
        raise ValueError("launch takes CUDA tensors; on the CPU use matmul_tiled_plain")
    runtime.refuse_grad("remop_matmul", "its backward (two more planned products)", a, b)
    check_tiles(bm, bn, bk, a.element_size())
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("the elements of each row of a and b must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    if a.dtype == torch.bfloat16:
        route = tma_route(a, b, bn, bk)
        sub = ring_sub(bm, bn, bk, route)
        counter = "matmul" if route else "matmul_staged"
    else:
        sub = f32_sub(bm, bn, bk)
        route = (bk % 4 == 0 and bn % 4 == 0 and sub % 4 == 0 and k % 4 == 0 and n % 4 == 0
                 and a.stride(0) % 4 == 0 and b.stride(0) % 4 == 0
                 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
        counter = "matmul_f32"
    lib = runtime.library("matmul")
    with torch.cuda.device(a.device):
        err = getattr(lib, f"remop_matmul_{_DTYPES[a.dtype]}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
            bm, bn, bk, sub, int(out_dtype == torch.float32), int(route), runtime.stream_of(a))
    runtime.check("matmul", "matmul", err)
    runtime.launches[counter] += 1
    return out


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a: [M, K]; b: [K, N] -> [M, N] in ``out_dtype`` (default a's).

    ``M % bm == N % bn == K % bk == 0`` (the caller pads), as
    ``matmul_pallas`` requires.  On CUDA tensors see :func:`launch`.
    """
    out_dtype = _check(a, b, out_dtype)
    _check_divides(a, b, bm, bn, bk)
    if runtime.on_cpu(a, b):
        return matmul_tiled_plain(a, b, bm, bn, bk, out_dtype)
    return launch(a, b, bm, bn, bk, out_dtype)


def occupancy(bm: int, bn: int, bk: int, dtype: torch.dtype = torch.bfloat16,
              tma: bool = True) -> dict:
    """The kernel instantiation these tiles launch, on the current card:
    CTAs one SM holds at once (CUDA's occupancy calculator: registers,
    shared memory, threads), registers and local (spilled) bytes a thread,
    dynamic shared memory and threads a CTA.  ``tma`` picks the bf16 route;
    for f32 it picks 16-byte staging."""
    check_tiles(bm, bn, bk, dtype.itemsize)
    sub = ring_sub(bm, bn, bk, tma) if dtype == torch.bfloat16 else f32_sub(bm, bn, bk)
    out = (ctypes.c_int * 5)()
    lib = runtime.library("matmul")
    err = getattr(lib, f"remop_matmul_occupancy_{_DTYPES[dtype]}")(
        bm, bn, bk, sub, int(tma), ctypes.addressof(out))
    runtime.check("matmul", "matmul", err)
    return dict(zip(("resident_ctas", "registers", "local_bytes", "smem_bytes", "threads"), out))
