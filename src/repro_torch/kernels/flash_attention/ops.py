"""Flash-attention entry point with REMOP block planning for Hopper."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.cost_model import H100
from repro_torch.kernels.flash_attention.flash_attention import (
    MAX_BLOCK,
    flash_attention,
    smem_bytes,
)

# Shared memory one CTA may use on an H100 (227 KB of the SM's 256 KB).
HOPPER_SMEM_BYTES = H100.vmem_bytes
# The TPU planner's candidates (128 .. 1024) scaled to what one CTA holds:
# the accumulator of bq rows lives in registers, so bq and bk stop at 64.
BLOCK_CANDIDATES = (16, 32, MAX_BLOCK)


def plan_blocks(s: int, t: int, hd: int, dtype_bytes: int = 2,
                smem_budget: Optional[int] = None) -> Tuple[int, int]:
    """(bq, bk) minimizing KV staging rounds under the shared-memory budget.

    Rounds ~ ceil(S/bq) * ceil(T/bk) (each round stages one KV block); the
    working set is :func:`smem_bytes`.  Ties keep the smaller blocks, as the
    TPU planner's ascending scan does.  The kernel masks ragged ends, so
    unlike the TPU planner no candidate has to divide S or T.
    """
    smem_budget = smem_budget or HOPPER_SMEM_BYTES
    best = (BLOCK_CANDIDATES[0], BLOCK_CANDIDATES[0])
    best_rounds = math.inf
    for bq in BLOCK_CANDIDATES:
        for bk in BLOCK_CANDIDATES:
            if smem_bytes(bq, bk, hd, dtype_bytes) > smem_budget:
                continue
            rounds = math.ceil(s / bq) * math.ceil(t / bk)
            if rounds < best_rounds:
                best_rounds = rounds
                best = (bq, bk)
    return best


def remop_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bq: Optional[int] = None,
                          bk: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, S, hd]; k/v: [B, KV, T, hd]; causal with offset T - S."""
    s, hd = q.shape[2], q.shape[3]
    t = k.shape[2]
    if bq is None or bk is None:
        pbq, pbk = plan_blocks(s, t, hd, q.element_size())
        bq, bk = bq or pbq, bk or pbk
    return flash_attention(q, k, v, bq=min(bq, s), bk=min(bk, t))
