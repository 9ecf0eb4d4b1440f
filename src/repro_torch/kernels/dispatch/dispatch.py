"""Row gather: the EHJ/EAGG radix-partition step as a CUDA kernel for Hopper.

After the merge-sort kernels order rows by partition id, moving the rows
into per-partition contiguous runs is a pure gather, ``out[i] = x[idx[i]]``.
The kernel (``csrc/gather_rows.cu``) replaces the TPU kernel ``gather_rows``
of the JAX package's ``kernels/dispatch/dispatch.py`` and honours its
``rows_per_block`` contract: with ``rows_per_block > 1``, output block ``b``
is the aligned source block ``idx[b * rows_per_block] // rows_per_block``.
Beside the wrapper is its plain PyTorch version, ``x[idx]``; a CPU tensor
takes it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime


def _source_rows(idx: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    if rows_per_block == 1:
        return idx.long()
    blocks = torch.div(idx[::rows_per_block].long(), rows_per_block,
                       rounding_mode="floor")
    offsets = torch.arange(rows_per_block, device=idx.device)
    return (blocks[:, None] * rows_per_block + offsets).reshape(-1)


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor,
                      rows_per_block: int = 1) -> torch.Tensor:
    """``out[i] = x[idx[i]]`` (blocked as above when rows_per_block > 1)."""
    return x[_source_rows(idx, rows_per_block)]


def _unit_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy unit (<= 16 bytes) dividing the row and every address."""
    for unit in (16, 8, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                rows_per_block: int = 1) -> torch.Tensor:
    """``out[i] = x[idx[i]]`` for a 2-D ``x`` and int32 ``idx``.

    ``len(idx)`` must be divisible by ``rows_per_block``; rows_per_block=1 is
    always correct.  Indices must lie in ``[0, len(x))``.
    """
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be 1-D int32, got {idx.dtype} of shape {tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    n = idx.shape[0]
    if rows_per_block < 1 or n % rows_per_block:
        raise ValueError(f"rows_per_block={rows_per_block} must divide len(idx)={n}")
    if runtime.on_cpu(x, idx):
        return gather_rows_plain(x, idx, rows_per_block)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    row_bytes = x.shape[1] * x.element_size()
    lib = runtime.library("gather_rows")
    with torch.cuda.device(x.device):
        err = lib.remop_gather_rows(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes,
            _unit_bytes(row_bytes, x.data_ptr(), out.data_ptr()),
            rows_per_block, runtime.stream_of(x))
    runtime.check("gather_rows", "gather_rows", err)
    runtime.launches["gather_rows"] += 1
    return out
