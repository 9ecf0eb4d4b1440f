"""MoE dispatch/combine built on the sort and gather kernels.

As in the JAX package's ``kernels/dispatch/ops.py``: dispatch is the EHJ
build phase (a stable argsort of the assignments by expert id, then a
destination-driven gather into per-expert buffers of ``capacity`` rows),
combine gathers the expert outputs back to assignment order and sums each
token's ``top_k`` weighted rows.  On a CUDA tensor the sort runs on the
merge-sort kernels (``argsort_by_key``) and the row moves on the gather
kernel; on a CPU tensor both take their plain versions.
``remop_dispatch_plain`` and ``remop_combine_plain`` run the same steps
through the plain versions on any device: the yardstick the kernels are
held to on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels.dispatch.dispatch import gather_rows, gather_rows_plain
from repro_torch.kernels.merge_sort.ops import argsort_by_key, argsort_by_key_plain

Gather = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def remop_dispatch(x: torch.Tensor, expert_ids: torch.Tensor, n_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition assignment rows into per-expert buffers (EHJ build phase).

    x: [A, d] rows (token features repeated per expert choice);
    expert_ids: [A] integer.  Returns (expert_in [E, C, d], slot [A] int32).
    """
    return _dispatch(x, expert_ids, n_experts, capacity, argsort_by_key, gather_rows)


def remop_dispatch_plain(x: torch.Tensor, expert_ids: torch.Tensor, n_experts: int,
                         capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`remop_dispatch` through the plain versions, on any device."""
    return _dispatch(x, expert_ids, n_experts, capacity, argsort_by_key_plain,
                     gather_rows_plain)


def _dispatch(x, expert_ids, n_experts, capacity, argsort, gather: Gather):
    a, d = x.shape
    dev = x.device
    # Expert-major, stable; expert ids are bounded by n_experts.
    order = argsort(expert_ids, max_key=n_experts - 1).long()
    ids = expert_ids.long()
    sorted_ids = ids[order]
    # Rank within expert among sorted assignments.
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev).index_add_(
        0, ids, torch.ones_like(ids))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(a, device=dev) - starts[sorted_ids]
    keep = rank < capacity
    # Destination-driven gather: for dest slot (e, c) the source row is
    # order[starts[e] + c] when c < counts[e].
    e_idx = torch.arange(n_experts, device=dev).repeat_interleave(capacity)
    c_idx = torch.arange(capacity, device=dev).repeat(n_experts)
    valid = c_idx < counts[e_idx]
    src = torch.where(valid, starts[e_idx] + c_idx, 0)
    src_rows = torch.where(valid, order[src], 0)
    gathered = gather(x, src_rows.to(torch.int32))
    expert_in = torch.where(valid[:, None], gathered, 0).reshape(n_experts, capacity, d)
    # Slot per assignment (for combine): e*C + rank, -1 when dropped.
    slot_sorted = torch.where(keep, sorted_ids * capacity + rank, -1).to(torch.int32)
    slot = torch.zeros(a, dtype=torch.int32, device=dev).index_copy_(0, order, slot_sorted)
    return expert_in, slot


def remop_combine(expert_out: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor,
                  top_k: int) -> torch.Tensor:
    """Gather expert outputs back to token order and weight-sum over top-k."""
    return _combine(expert_out, slot, weights, top_k, gather_rows)


def remop_combine_plain(expert_out: torch.Tensor, slot: torch.Tensor,
                        weights: torch.Tensor, top_k: int) -> torch.Tensor:
    """:func:`remop_combine` through the plain gather, on any device."""
    return _combine(expert_out, slot, weights, top_k, gather_rows_plain)


def _combine(expert_out, slot, weights, top_k, gather: Gather):
    e, c, d = expert_out.shape
    a = slot.shape[0]
    flat = expert_out.reshape(e * c, d).contiguous()
    rows = gather(flat, slot.clamp_min(0).to(torch.int32))
    rows = torch.where(slot[:, None] >= 0, rows, 0)
    rows = rows * weights[:, None].to(rows.dtype)
    return rows.reshape(a // top_k, top_k, d).sum(dim=1)
