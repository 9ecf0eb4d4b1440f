"""REMOP planner — maps the paper's buffer-allocation algebra onto kernel knobs.

The JAX package's planner with its imports renamed and its logic left alone;
the default ``spec`` is the H100's (``cost_model.H100``), and any object with
the same attribute names (a TPU's figures included) can be passed instead.
The knobs still carry the names they had on a TPU: ``vmem`` is the shared
memory one CTA can use, a "DMA round" one staging round of a tile.

Every plan below is an instance of the same trade: a budget (shared-memory
bytes, device-memory bytes, or a step's time) is partitioned into buffer
regions; bigger regions mean fewer, larger transfers (lower C) at the price
of more total movement or memory (higher D).  The latency objective is always
Definition 3's ``L = D + tau * C`` with tau calibrated per tier
(``cost_model.H100_TIERS``):

  * matmul tiles        — BNLJ analogue (outer/inner block split, §III-A)
  * merge-sort fan-in   — EMS analogue (Property 5 / Table IV, §III-B)
  * MoE dispatch pools  — EHJ analogue (Property 6 waterfill, §III-C)
  * gradient buckets    — collective rounds over the interconnect
  * KV-cache pages      — paged-attention grid rounds over device memory
  * microbatch count    — accumulation rounds vs activation footprint
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.core.cost_model import H100, H100Spec
from repro_torch.core import policies


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _round_down(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


# ==========================================================================
# BNLJ analogue: matmul tile planning
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class MatmulTilePlan:
    bm: int
    bn: int
    bk: int
    vmem_bytes: int
    d_bytes: float  # predicted HBM traffic
    c_rounds: float  # predicted DMA rounds
    l_cost: float  # D + tau * C (bytes)
    policy: str = "remop"


def matmul_costs(
    m: int, n: int, k: int, bm: int, bn: int, bk: int,
    in_bytes: int, out_bytes: int,
) -> Tuple[float, float]:
    """(D, C) for a tiled matmul with grid (m/bm, n/bn, k/bk).

    BNLJ correspondence (§III-A): the A row-block is the pinned outer block
    (one read per (i, j) tile: A is re-read once per N/bn column sweep), B is
    the rescanned inner relation, the (bm, bn) accumulator is the output
    region flushed once per (i, j).
    """
    gm, gn, gk = math.ceil(m / bm), math.ceil(n / bn), math.ceil(k / bk)
    d = (
        gn * m * k * in_bytes  # A re-read once per column sweep
        + gm * k * n * in_bytes  # B re-read once per row sweep
        + m * n * out_bytes  # C written once (K accumulated in VMEM)
    )
    c = 2.0 * gm * gn * gk + gm * gn  # A-tile + B-tile DMA per step, one flush
    return float(d), float(c)


def matmul_vmem(bm: int, bn: int, bk: int, in_bytes: int, acc_bytes: int = 4,
                double_buffer: bool = True) -> int:
    """VMEM bytes claimed by one grid step's working set."""
    factor = 2 if double_buffer else 1  # prefetch double buffer (§IV-E)
    return factor * (bm * bk + bk * bn) * in_bytes + bm * bn * acc_bytes


def plan_matmul_tiles(
    m: int, n: int, k: int,
    in_bytes: int = 2,
    acc_bytes: int = 4,
    vmem_budget: int | None = None,
    spec: H100Spec = H100,
    lane: int = 128,
    sublane: int = 8,
    exhaustive: bool = True,
) -> MatmulTilePlan:
    """Pick (bm, bn, bk) minimizing L = D + tau_dma * C under the VMEM budget.

    ``exhaustive=False`` applies the paper's closed form only: split the input
    region between the A and B tiles at p_R*:p_S* = sqrt(1 + R_in/tau):1
    (Property 4) and quantize to MXU alignment.  ``exhaustive=True`` (default,
    the beyond-paper mode) additionally searches the hardware-legal
    neighborhood and returns the argmin.
    """
    vmem_budget = vmem_budget or (spec.vmem_bytes // 2)
    tau = spec.tau_dma_bytes

    def aligned(x: int, cap: int, mult: int) -> int:
        return max(mult, min(_round_down(x, mult), _round_up(cap, mult)))

    # --- paper closed form -------------------------------------------------
    # Output region: selectivity analogue beta is tiny for matmul (the output
    # tile is written once per (i, j)), so r_in ~ Table III at beta -> 0.
    a_param = (vmem_budget / max(in_bytes, 1)) / max(tau, 1e-9)
    r_in = policies.bnlj_rin_opt(a_param, 1e-6)
    input_budget = r_in * vmem_budget
    p_r = policies.bnlj_split_opt(input_budget / max(in_bytes, 1), tau / max(in_bytes, 1))
    # Interpret: A-tile gets p_r of the input region, B-tile the rest; pick bk
    # to use the depth allowed by the smaller side at max lane alignment.
    bk0 = aligned(min(k, 512), k, lane)
    bm0 = aligned(int(p_r * input_budget / (2 * in_bytes * bk0)), m, sublane)
    bn0 = aligned(int((1 - p_r) * input_budget / (2 * in_bytes * bk0)), n, lane)
    bm0, bn0, bk0 = min(bm0, _round_up(m, sublane)), min(bn0, _round_up(n, lane)), min(bk0, _round_up(k, lane))

    def mk(bm: int, bn: int, bk: int, policy: str) -> MatmulTilePlan | None:
        v = matmul_vmem(bm, bn, bk, in_bytes, acc_bytes)
        if v > vmem_budget:
            return None
        d, c = matmul_costs(m, n, k, bm, bn, bk, in_bytes, acc_bytes)
        return MatmulTilePlan(bm, bn, bk, v, d, c, d + tau * c, policy)

    base = mk(bm0, bn0, bk0, "remop-closed-form")
    while base is None and bk0 > lane:
        bk0 //= 2
        base = mk(bm0, bn0, bk0, "remop-closed-form")
    while base is None and (bm0 > sublane or bn0 > lane):
        bm0 = max(sublane, bm0 // 2)
        bn0 = max(lane, bn0 // 2)
        base = mk(bm0, bn0, bk0, "remop-closed-form")
    assert base is not None, "no feasible tile under VMEM budget"
    if not exhaustive:
        return base

    # --- beyond-paper exhaustive neighborhood search -----------------------
    best = base
    bms = {aligned(x, m, sublane) for x in (64, 128, 256, 512, 1024, 2048, bm0)}
    bns = {aligned(x, n, lane) for x in (128, 256, 512, 1024, 2048, bn0)}
    bks = {aligned(x, k, lane) for x in (128, 256, 512, 1024, 2048, bk0)}
    for bm in bms:
        for bn in bns:
            for bk in bks:
                cand = mk(min(bm, _round_up(m, sublane)),
                          min(bn, _round_up(n, lane)),
                          min(bk, _round_up(k, lane)), "remop-search")
                if cand is not None and cand.l_cost < best.l_cost:
                    best = cand
    return best


def conventional_matmul_tiles(
    m: int, n: int, k: int, in_bytes: int = 2, acc_bytes: int = 4,
    vmem_budget: int | None = None, spec: H100Spec = H100,
) -> MatmulTilePlan:
    """Volume-minimizing baseline (the disk-era policy): maximize the A tile,
    stream B one lane-column at a time — the (M-2):1 outer-heavy split."""
    vmem_budget = vmem_budget or (spec.vmem_bytes // 2)
    tau = spec.tau_dma_bytes
    bn, bk = 128, min(k, 512)
    bm = _round_down(
        (vmem_budget - matmul_vmem(0, bn, bk, in_bytes, acc_bytes)) // (2 * in_bytes * bk + acc_bytes * bn),
        8,
    )
    bm = max(8, min(bm, _round_up(m, 8)))
    d, c = matmul_costs(m, n, k, bm, bn, bk, in_bytes, acc_bytes)
    return MatmulTilePlan(bm, bn, bk, matmul_vmem(bm, bn, bk, in_bytes, acc_bytes),
                          d, c, d + tau * c, "conventional")


# ==========================================================================
# EMS analogue: merge fan-in for blocked sort
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class SortPlan:
    n_items: int
    run_items: int  # items sorted in-core per run
    k: int  # merge fan-in per pass
    passes: int
    r_in_frac: float


def plan_sort(
    n_items: int, item_bytes: int = 8,
    vmem_budget: int | None = None, spec: H100Spec = H100,
) -> SortPlan:
    """EMS policy for the blocked merge sort kernel: Property 5 + Table IV."""
    vmem_budget = vmem_budget or (spec.vmem_bytes // 4)
    m_pages = vmem_budget  # bytes as "pages" of 1 byte; tau in bytes
    tau = spec.tau_dma_bytes
    k = policies.ems_kopt(m_pages / tau)
    run_items = max(1024, _round_down(vmem_budget // (2 * item_bytes), 1024))
    runs = math.ceil(n_items / run_items)
    k = max(2, min(k, max(2, runs)))
    passes = policies.ems_passes(n_items, run_items, k) if runs > 1 else 0
    return SortPlan(n_items, run_items, k, passes, policies.ems_split_opt(k))


# ==========================================================================
# EHJ analogue: MoE dispatch staging pools
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    tokens: int
    experts: int
    ep_degree: int
    sigma: float  # fraction of tokens routed off-chip
    read_pool: float  # R_r (bytes)
    stage_pool: float  # R_s (bytes) — per-destination staging total
    out_pool: float  # R_o (bytes)
    a2a_rounds: float  # predicted all-to-all rounds


def plan_dispatch(
    tokens_per_device: int,
    token_bytes: int,
    experts: int,
    ep_degree: int,
    buffer_budget: int,
    out_factor: float = 1.0,
) -> DispatchPlan:
    """EHJ probe-phase allocation for MoE all-to-all dispatch (Property 6).

    `tokens` play |Q|, destinations (ep shards) play partitions P, off-chip
    fraction sigma = 1 - 1/ep (uniform routing), output = returned expert
    results.  R_s caps tokens staged per a2a round: rounds = spilled/R_s.
    """
    sigma = 0.0 if ep_degree <= 1 else 1.0 - 1.0 / ep_degree
    q = float(tokens_per_device * token_bytes)
    out = out_factor * q
    coeffs = (q, sigma * sigma * ep_degree * q, (1.0 - sigma) * out)
    alloc, _ = policies.waterfill(coeffs, float(buffer_budget))
    r_r, r_s, r_o = alloc
    spilled = sigma * q
    rounds = spilled / max(r_s, 1.0) if spilled else 0.0
    return DispatchPlan(tokens_per_device, experts, ep_degree, sigma,
                        r_r, r_s, r_o, rounds)


# ==========================================================================
# Collective rounds: gradient-bucket planning
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    total_bytes: int
    n_buckets: int
    bucket_bytes: int
    exposed_seconds: float


def plan_grad_buckets(
    total_grad_bytes: int,
    backward_seconds: float,
    group_size: int,
    spec: H100Spec = H100,
    max_buckets: int = 256,
) -> BucketPlan:
    """Round-aware all-reduce bucketing.

    With B buckets, comm time = total/bw_ring + B * launch (C = B rounds each
    paying the collective-launch "RTT"); all but the last bucket can overlap
    backward compute.  Exposed time ~ max(comm - backward, 0) + last bucket.
    Minimizing this is the REMOP trade: fewer rounds vs finer overlap.
    """
    if group_size <= 1 or total_grad_bytes == 0:
        return BucketPlan(total_grad_bytes, 1, total_grad_bytes, 0.0)
    ring = 2.0 * (group_size - 1) / group_size  # ring all-reduce volume factor
    bw = spec.ici_bandwidth
    tau = spec.collective_launch_s

    def exposed(b: int) -> float:
        bucket = total_grad_bytes / b
        comm = ring * total_grad_bytes / bw + b * tau
        tail = ring * bucket / bw + tau
        return max(comm - backward_seconds, 0.0) + tail

    best_b = min(range(1, max_buckets + 1), key=exposed)
    return BucketPlan(total_grad_bytes, best_b,
                      int(math.ceil(total_grad_bytes / best_b)), exposed(best_b))


# ==========================================================================
# KV-cache paging for decode
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class KVPagePlan:
    page_tokens: int
    pages: int
    d_bytes: float
    c_rounds: float
    l_cost: float


def plan_kv_pages(
    context_len: int,
    kv_heads: int,
    head_dim: int,
    kv_bytes: int = 2,
    vmem_budget: int | None = None,
    spec: H100Spec = H100,
    lane: int = 128,
) -> KVPagePlan:
    """Page size for paged-attention decode: one page read = one DMA round.

    Bigger pages cut rounds (C = 2 * ceil(S/page) for K and V) but claim more
    VMEM and waste tail bandwidth (avg page/2 overfetch on the last page).
    """
    vmem_budget = vmem_budget or (spec.vmem_bytes // 8)
    tau = spec.tau_dma_bytes
    per_tok = kv_heads * head_dim * kv_bytes
    best = None
    p = lane
    while p <= max(lane, min(context_len, 4096)):
        vmem = 2 * 2 * p * per_tok  # K and V slots, double-buffered
        if vmem <= vmem_budget:
            pages = math.ceil(context_len / p)
            d = 2.0 * pages * p * per_tok  # includes tail overfetch
            c = 2.0 * pages
            l = d + tau * c
            if best is None or l < best.l_cost:
                best = KVPagePlan(p, pages, d, c, l)
        p *= 2
    assert best is not None
    return best


# ==========================================================================
# Microbatching: accumulation rounds vs activation footprint
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class MicrobatchPlan:
    microbatches: int
    per_microbatch: int
    act_bytes: int


def plan_microbatches(
    per_device_batch: int,
    seq_len: int,
    d_model: int,
    n_layers: int,
    act_bytes_per_elem: int = 2,
    act_multiplier: float = 2.0,
    hbm_activation_budget: int | None = None,
    spec: H100Spec = H100,
    seq_shards: int = 1,
) -> MicrobatchPlan:
    """Smallest accumulation-round count whose activations fit the budget.

    Under remat-over-layers, the checkpointed residual stream costs about
    n_layers * (mb * seq * d_model) * act_bytes * act_multiplier; each extra
    microbatch is one more accumulation round (C), so we take the minimum
    feasible count — the same min-C-subject-to-budget shape as Property 5.
    """
    budget = hbm_activation_budget or int(spec.hbm_bytes * 0.45)
    per_tok = d_model * act_bytes_per_elem * act_multiplier * n_layers / max(seq_shards, 1)
    mb = 1
    while mb < per_device_batch:
        act = (per_device_batch / mb) * seq_len * per_tok
        if act <= budget:
            break
        mb *= 2
    mb = min(mb, per_device_batch)
    while per_device_batch % mb:
        mb += 1
    act = int((per_device_batch / mb) * seq_len * per_tok)
    return MicrobatchPlan(mb, per_device_batch // mb, act)
