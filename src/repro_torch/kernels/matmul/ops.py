"""REMOP-planned blocked matmul: tiles from the planner, policy, padding on the CPU."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.planner import (
    MatmulTilePlan,
    conventional_matmul_tiles,
    plan_matmul_tiles,
)
from repro_torch.kernels import runtime
from repro_torch.kernels.matmul.matmul import launch, matmul_tiled


def _pad_to(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


@functools.lru_cache(maxsize=256)
def plan_for(a_shape, b_shape, dtype: torch.dtype = torch.bfloat16, policy: str = "remop",
             vmem_budget: int | None = None) -> MatmulTilePlan:
    """The tile plan of ``a_shape @ b_shape``: ``"remop"`` searches the
    neighbourhood of the closed form, ``"conventional"`` is the
    volume-minimising baseline, any other policy the closed form alone.

    Plans are frozen and depend on the arguments alone, so each is computed
    once: the REMOP search takes about half a millisecond of host time,
    which a product of a few hundred microseconds on the card would wait
    for on every call."""
    m, k = a_shape
    _, n = b_shape
    in_bytes = dtype.itemsize
    if policy == "conventional":
        return conventional_matmul_tiles(m, n, k, in_bytes=in_bytes,
                                         vmem_budget=vmem_budget)
    return plan_matmul_tiles(m, n, k, in_bytes=in_bytes,
                             vmem_budget=vmem_budget,
                             exhaustive=(policy == "remop"))


def clamped_tiles(plan: MatmulTilePlan, m: int, n: int, k: int) -> tuple[int, int, int]:
    """The tiles ``remop_matmul`` runs: the plan's, clamped to the problem's dims."""
    return min(plan.bm, m) or 8, min(plan.bn, n) or 128, min(plan.bk, k) or 128


def remop_matmul(a: torch.Tensor, b: torch.Tensor, policy: str = "remop",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Blocked matmul with REMOP-planned tiles.

    On CUDA tensors the kernel masks the ragged last row, column and K tiles
    itself; on the CPU the inputs are padded to tile multiples, as the JAX
    entry point pads them, and the plain version runs.
    """
    m, k = a.shape
    _, n = b.shape
    bm, bn, bk = clamped_tiles(plan_for(a.shape, b.shape, a.dtype, policy), m, n, k)
    out_dtype = out_dtype or a.dtype
    if not runtime.on_cpu(a, b):
        return launch(a, b, bm, bn, bk, out_dtype=out_dtype)
    ap = _pad_to(a, bm, bk)
    bp = _pad_to(b, bk, bn)
    return matmul_tiled(ap, bp, bm, bn, bk, out_dtype=out_dtype)[:m, :n]
