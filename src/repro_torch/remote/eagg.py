"""External (grace-style) hash aggregation over simulated remote memory.

Two phases under one I/O budget.  P1 scans the input relation through the R_r
read buffer and hash-partitions it into P partitions: resident partitions
aggregate on the fly in local hash tables, spilled partitions (fraction
``sigma``) flush raw tuples through the per-partition-sliced R_w write pool,
and the resident group output flushes through R_o.  P2 re-reads each spilled
partition through R_r, aggregates it in memory (grace assumption: one
partition fits locally), and flushes its groups through R_o.  Every block
read is a :class:`repro_torch.engine.PageCursor` round and every pool flush a
:class:`repro_torch.engine.BufferPool` round, so the measured ledger matches
:func:`repro_torch.core.policies.eagg_costs_exact` exactly (skew included).

Group rows are ``(key, sum(payload), count)`` triples over column 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.policies import EAggPlan
from repro_torch.engine.buffers import BufferPool, PageCursor
from repro_torch.engine.scheduler import TransferScheduler, stream_tiers
from repro_torch.remote.simulator import Relation, RemoteMemory, as_relation, relation_rows


# Typed input signature for the session API: ``engine.registry`` binds named
# task inputs to ``eagg``'s positional data-plane arguments through this, and
# maps each input to the WorkloadStats field that estimates its size.
INPUTS = ("rel",)
INPUT_STATS = {"rel": "size_r"}

# Spill streams this operator writes, in declaration order — the unit of
# fractional placement: raw spilled partitions vs. the group output
# (resident P1 groups and external P2 groups share the output stream tier).
STREAMS = ("partitions", "output")


@dataclasses.dataclass
class AggResult:
    output_page_ids: List[int]
    group_rows: int
    sigma: float
    d_read: float
    d_write: float
    c_read: int
    c_write: int
    per_phase_rounds: Dict[str, int]
    # How many spilled partitions were partially aggregated at the memory
    # tier in P2 (0 when pushdown was off or no tier was reduce-capable).
    pushdown_partitions: int = 0


def eagg_output(result: AggResult) -> List[int]:
    """The operator's output pages — what a downstream task's input binds to."""
    return result.output_page_ids


def eagg_measured(stats, result: AggResult):
    """Feed the measured output cardinality back into the workload stats."""
    return dataclasses.replace(stats, out=float(len(result.output_page_ids)))


def _hash_part(keys: np.ndarray, p: int) -> np.ndarray:
    h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return ((h >> np.uint64(33)) % np.uint64(p)).astype(np.int64)


def _aggregate(rows: np.ndarray) -> np.ndarray:
    """Group rows by column 0: (key, sum of column 1, count) per group."""
    if not len(rows):
        return np.empty((0, 3), dtype=np.int64)
    keys, inverse = np.unique(rows[:, 0], return_inverse=True)
    sums = np.bincount(inverse, weights=rows[:, 1].astype(np.float64))
    counts = np.bincount(inverse)
    return np.stack([keys, sums.astype(np.int64), counts.astype(np.int64)], axis=1)


def _reduce_partition(pages: List[np.ndarray]) -> np.ndarray:
    """Tier-side reducer for one spilled partition (grace assumption)."""
    return _aggregate(np.concatenate(pages, axis=0))


def eagg(
    remote: RemoteMemory,
    rel: Relation,
    plan: EAggPlan,
    rows_per_page: int | None = None,
    prefetch: bool = False,
    tier=None,
    pushdown: bool = False,
) -> AggResult:
    """Run the two-phase external hash aggregation under ``plan``.

    ``remote`` is a single tier or a :class:`MemoryHierarchy`; on a
    hierarchy, ``tier`` names the placement spilled partitions and group
    output are routed to — a scalar, or a per-stream spec over ``STREAMS``.
    ``rel`` accepts a ``Relation`` or a bare page-id list.

    ``pushdown=True`` lets P2 partially aggregate a spilled partition *at*
    the tier holding it: when every page of the partition is resident on one
    ``"reduce"``-capable tier, a single ``read_reduced`` pushdown round
    ships only the group pages instead of re-reading the raw spill.
    Partitions that waterfalled across tiers, or sit on non-capable tiers,
    fall back to the plain re-read — the group table is identical either
    way (``_aggregate`` is deterministic), only D/C change.
    """
    rel = as_relation(remote, rel)
    tiers = stream_tiers(tier, STREAMS)
    rows_per_page = rows_per_page or rel.rows_per_page
    p = plan.partitions
    n_spilled = int(round(plan.sigma * p))
    spilled = set(range(p - n_spilled, p))  # deterministic spill set
    sched = TransferScheduler(remote, tier=tiers["output"])
    before = sched.snapshot()
    phase_rounds: Dict[str, int] = {}

    # ---- P1: scan, aggregate resident partitions, spill the rest -----------
    t0 = sched.snapshot()
    r_r1, r_w1, r_o1 = plan.p1
    spill_pool = BufferPool(sched, r_w1, rows_per_page,
                            n_streams=max(len(spilled), 1),
                            tier=tiers["partitions"])
    resident: Dict[int, List[np.ndarray]] = {q: [] for q in range(p) if q not in spilled}
    for rows in PageCursor(sched, rel.page_ids, round(r_r1),
                           prefetch=prefetch).blocks():
        parts = _hash_part(rows[:, 0], p)
        for q, sel in sched.partitions(rows, parts):
            if q in spilled:
                spill_pool.add(sel, stream=q)
            else:
                resident[q].append(sel)
    spill_pool.flush_all()
    out_pool = BufferPool(sched, r_o1, rows_per_page, tier=tiers["output"])
    group_rows = 0
    for q in sorted(resident):
        if not resident[q]:
            continue
        groups = _aggregate(np.concatenate(resident[q], axis=0))
        group_rows += len(groups)
        out_pool.add(groups)  # single resident-output stream
    out_pool.flush_all()
    phase_rounds["P1"] = sched.delta(t0).c_total

    # ---- P2: re-read each spilled partition, aggregate, flush groups -------
    t0 = sched.snapshot()
    r_r2, r_o2 = plan.p2
    read_pages = round(r_r2)
    ext_out_pool = BufferPool(sched, r_o2, rows_per_page, tier=tiers["output"])
    pushdown_parts = 0
    for q in sorted(spilled):
        ids = spill_pool.pages(q)
        if not ids:
            continue
        pushed = False
        if pushdown and getattr(remote, "is_hierarchy", False):
            homes = {remote.tier_of(i) for i in ids}
            if len(homes) == 1:
                home = homes.pop()
                if remote.spec.level(home).can_push("reduce"):
                    group_pages = remote.read_reduced(
                        home, ids, _reduce_partition, rows_per_page
                    )
                    groups = (
                        np.concatenate(group_pages, axis=0)
                        if group_pages
                        else np.empty((0, 3), dtype=np.int64)
                    )
                    pushdown_parts += 1
                    pushed = True
        if not pushed:
            part_rows = PageCursor(sched, ids, read_pages, prefetch=prefetch).read_all()
            groups = _aggregate(part_rows)
        group_rows += len(groups)
        ext_out_pool.add(groups)
    ext_out_pool.flush_all()
    phase_rounds["P2"] = sched.delta(t0).c_total

    d = sched.delta(before)
    return AggResult(
        output_page_ids=out_pool.pages() + ext_out_pool.pages(),
        group_rows=group_rows,
        sigma=plan.sigma,
        d_read=d.d_read,
        d_write=d.d_write,
        c_read=d.c_read,
        c_write=d.c_write,
        per_phase_rounds=phase_rounds,
        pushdown_partitions=pushdown_parts,
    )


def eagg_oracle(remote: RemoteMemory, rel: Relation) -> np.ndarray:
    """Oracle group table (key, sum, count), sorted by key (no accounting)."""
    return _aggregate(relation_rows(remote, rel))
