"""Row gather: the EHJ/EAGG radix-partition step as a CUDA kernel for Hopper.

After the merge-sort kernels order rows by partition id, moving the rows
into per-partition contiguous runs is a pure gather, ``out[i] = x[idx[i]]``.
The kernel (``csrc/gather_rows.cu``) replaces the TPU kernel ``gather_rows``
of the JAX package's ``kernels/dispatch/dispatch.py`` and honours its
``rows_per_block`` contract: with ``rows_per_block > 1``, output block ``b``
is the aligned source block ``idx[b * rows_per_block] // rows_per_block``.
On the card that is a gather of wider rows (:func:`block_view`), so the
kernel has one index path.  Beside the wrapper is its plain PyTorch version,
``x[idx]``; a CPU tensor takes it, a CUDA tensor launches the kernel or
raises.

The host picks the kernel's route (:func:`plan`): rows of one 4-, 8- or
16-byte unit take the ``"narrow"`` route, eight rows a thread; every other
width or alignment the ``"grouped"`` route, a group of lanes a row, each
lane moving units of the widest size that divides the row and both base
addresses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import runtime

ROUTES = ("narrow", "grouped")
LANES = 32  # a warp: the widest group of lanes on one row


class Plan(NamedTuple):
    """How the kernel copies a row: its route, the bytes each load and store
    moves, and the lanes that copy one row (1 on the narrow route)."""

    route: str
    unit: int
    lanes: int


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


def block_view(x: torch.Tensor, idx: torch.Tensor,
               rows_per_block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked gather as a gather of blocks: ``x``'s whole blocks of
    ``rows_per_block`` rows viewed as one row each (a partial block at the end
    is left out), and the block each output block reads,
    ``idx[::rows_per_block] // rows_per_block`` (int32, contiguous)."""
    t, d = x.shape
    blocks = torch.div(idx[::rows_per_block], rows_per_block, rounding_mode="floor")
    whole = x[: t - t % rows_per_block]
    return whole.view(t // rows_per_block, rows_per_block * d), blocks.contiguous()


def _unit_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy unit (<= 16 bytes) dividing the row and every address."""
    for unit in (16, 8, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def plan(row_bytes: int, x_ptr: int, idx_ptr: int, out_ptr: int) -> Plan:
    """The kernel's route for rows of ``row_bytes`` at these base addresses.

    Narrow: a row is one aligned unit of 4, 8 or 16 bytes, the output is
    16-byte aligned and the indices of the rows in one 16-byte store can be
    loaded at once.  Grouped: lanes a row up to a warp, as many as the row
    has units.
    """
    unit = _unit_bytes(row_bytes, x_ptr, out_ptr)
    if row_bytes == unit >= 4 and out_ptr % 16 == 0 and idx_ptr % (64 // unit) == 0:
        return Plan("narrow", unit, 1)
    units = row_bytes // unit
    return Plan("grouped", unit, min(LANES, 1 << (units - 1).bit_length()))


def attributes(p: Plan) -> dict:
    """Registers, local (spilled) bytes and resident CTAs an SM of the
    kernel instantiation that runs plan ``p``, on the current card."""
    out = (ctypes.c_int * 3)()
    err = runtime.library("gather_rows").remop_gather_rows_attributes(
        ROUTES.index(p.route), p.unit, ctypes.addressof(out))
    runtime.check("gather_rows", "gather_rows", err)
    return dict(zip(("registers", "local_bytes", "resident_ctas"), out))


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                rows_per_block: int = 1) -> torch.Tensor:
    """``out[i] = x[idx[i]]`` for a 2-D ``x`` and int32 ``idx``.

    ``len(idx)`` must be divisible by ``rows_per_block``;
    rows_per_block=1 is always correct.  Indices must lie in ``[0, len(x))``,
    and with ``rows_per_block > 1`` in ``x``'s whole blocks,
    ``[0, len(x) - len(x) % rows_per_block)``: the JAX package's interpreter
    fills the part of a block past the end of ``x`` with its own padding,
    which the port does not reproduce.  On the CPU such an index raises, as
    any index out of range does; the kernel checks no index.
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
    runtime.refuse_grad("gather_rows", "its backward (a scatter-add kernel)", x)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    src, rows = x, idx
    if rows_per_block > 1:
        src, rows = block_view(x, idx, rows_per_block)
    row_bytes = src.shape[1] * src.element_size()
    p = plan(row_bytes, src.data_ptr(), rows.data_ptr(), out.data_ptr())
    lib = runtime.library("gather_rows")
    with torch.cuda.device(x.device):
        err = lib.remop_gather_rows(
            src.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.shape[0], row_bytes,
            ROUTES.index(p.route), p.unit, p.lanes, runtime.stream_of(x))
    runtime.check("gather_rows", "gather_rows", err)
    runtime.launches["gather_rows"] += 1
    return out
