"""External (radix-partitioned) hash join over simulated remote memory.

Algorithm 3 / §III-C: both relations are hash-partitioned into P partitions; a
fraction ``sigma`` of partitions spill.  Phase P1 partitions the build side
(resident partitions become in-memory hash tables, spilled tuples flush
through the R_w write pool); P2 partitions the probe side (resident tuples
probe on the fly, spilled tuples stage through R_s, resident output through
R_o); P3 re-reads each spilled pair and joins it.  The R_w/R_s/R_o pools are
per-partition-sliced :class:`repro_torch.engine.BufferPool` instances and every
block read is a :class:`repro_torch.engine.PageCursor` round, so the ledger counts
match the Table V terms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.policies import EHJPlan
from repro_torch.engine.buffers import BufferPool, PageCursor
from repro_torch.engine.scheduler import TransferScheduler, stream_tiers
from repro_torch.remote.bnlj import _block_join
from repro_torch.remote.simulator import Relation, RemoteMemory, as_relation, relation_rows


# Typed input signature for the session API: ``engine.registry`` binds named
# task inputs to ``ehj``'s positional data-plane arguments through this, and
# maps each input to the WorkloadStats field that estimates its size.
INPUTS = ("build", "probe")
INPUT_STATS = {"build": "size_r", "probe": "size_s"}

# Spill streams this operator writes, in declaration order — the unit of
# fractional placement: spilled build partitions, staged probe tuples, and
# the join output (resident + external rounds share the output stream tier).
STREAMS = ("build", "stage", "output")


@dataclasses.dataclass
class HashJoinResult:
    output_rows: int
    sigma: float
    d_read: float
    d_write: float
    c_read: int
    c_write: int
    per_phase_rounds: Dict[str, int]
    output_page_ids: List[int] = dataclasses.field(default_factory=list)


def ehj_output(result: HashJoinResult) -> List[int]:
    """The operator's output pages — what a downstream task's input binds to."""
    return result.output_page_ids


def ehj_measured(stats, result: HashJoinResult):
    """Feed the measured output cardinality back into the workload stats.

    This is the ROADMAP's known misestimation case: the planner's ``out``
    estimate can be ~8x off at high selectivity, and the measured page count
    is what ``Session.run(replan="measured")`` re-arbitrates with.
    """
    return dataclasses.replace(stats, out=float(len(result.output_page_ids)))


def ehj(
    remote: RemoteMemory,
    build: Relation,
    probe: Relation,
    plan: EHJPlan,
    rows_per_page: int | None = None,
    prefetch: bool = False,
    tier=None,
) -> HashJoinResult:
    """Run the three-phase external hash join under `plan`.

    ``remote`` is a single tier or a :class:`MemoryHierarchy`; on a
    hierarchy, ``tier`` names the placement spilled partitions and output
    are routed to — a scalar, or a per-stream spec over ``STREAMS`` (e.g.
    spilled build partitions on DRAM, staged probe tuples on SSD).
    ``build`` / ``probe`` accept a ``Relation`` or a bare page-id list.
    """
    build = as_relation(remote, build)
    probe = as_relation(remote, probe)
    tiers = stream_tiers(tier, STREAMS)
    rows_per_page = rows_per_page or build.rows_per_page
    p = plan.partitions
    n_spilled = int(round(plan.sigma * p))
    spilled = set(range(p - n_spilled, p))  # deterministic spill set
    sched = TransferScheduler(remote, tier=tiers["output"])
    before = sched.snapshot()
    phase_rounds: Dict[str, int] = {}

    def hash_part(keys: np.ndarray) -> np.ndarray:
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return ((h >> np.uint64(33)) % np.uint64(p)).astype(np.int64)

    # ---- P1: partition build, build resident tables, spill the rest -------
    t0 = sched.snapshot()
    r_r1, r_w1 = plan.p1
    build_pool = BufferPool(sched, r_w1, rows_per_page,
                            n_streams=max(len(spilled), 1),
                            tier=tiers["build"])
    resident_build: Dict[int, List[np.ndarray]] = {q: [] for q in range(p) if q not in spilled}
    for rows in PageCursor(sched, build.page_ids, round(r_r1),
                           prefetch=prefetch).blocks():
        parts = hash_part(rows[:, 0])
        for q, sel in sched.partitions(rows, parts):
            if q in spilled:
                build_pool.add(sel, stream=q)
            else:
                resident_build[q].append(sel)
    build_pool.flush_all()
    resident_tables = {
        q: (np.concatenate(v, axis=0) if v else np.empty((0, 2), dtype=np.int64))
        for q, v in resident_build.items()
    }
    phase_rounds["P1"] = sched.delta(t0).c_total

    # ---- P2: partition probe; probe resident, stage spilled ----------------
    t0 = sched.snapshot()
    r_r2, r_s2, r_o2 = plan.p2
    stage_pool = BufferPool(sched, r_s2, rows_per_page,
                            n_streams=max(len(spilled), 1),
                            tier=tiers["stage"])
    out_pool = BufferPool(sched, r_o2, rows_per_page, tier=tiers["output"])
    output_rows = 0
    for rows in PageCursor(sched, probe.page_ids, round(r_r2),
                           prefetch=prefetch).blocks():
        parts = hash_part(rows[:, 0])
        for q, sel in sched.partitions(rows, parts):
            if q in spilled:
                stage_pool.add(sel, stream=q)
            else:
                matched = _block_join(resident_tables[q], sel)
                if len(matched):
                    output_rows += len(matched)
                    out_pool.add(matched)  # single resident-output stream
    stage_pool.flush_all()
    phase_rounds["P2"] = sched.delta(t0).c_total

    # ---- P3: external rounds over spilled pairs ----------------------------
    t0 = sched.snapshot()
    r_r3, r_o3 = plan.p3
    read_pages = round(r_r3)
    ext_out_pool = BufferPool(sched, r_o3, rows_per_page, tier=tiers["output"])
    for q in sorted(spilled):
        b_ids = build_pool.pages(q)
        q_ids = stage_pool.pages(q)
        if not b_ids or not q_ids:
            continue
        b_rows = PageCursor(sched, b_ids, read_pages, prefetch=prefetch).read_all()
        for q_rows in PageCursor(sched, q_ids, read_pages,
                                 prefetch=prefetch).blocks():
            matched = _block_join(b_rows, q_rows)
            if len(matched):
                output_rows += len(matched)
                ext_out_pool.add(matched, stream=q)
    out_pool.flush_all()
    ext_out_pool.flush_all()
    phase_rounds["P3"] = sched.delta(t0).c_total

    d = sched.delta(before)
    output_ids = list(out_pool.pages())
    for q in sorted(spilled):
        output_ids.extend(ext_out_pool.pages(q))
    return HashJoinResult(
        output_rows=output_rows,
        sigma=plan.sigma,
        d_read=d.d_read,
        d_write=d.d_write,
        c_read=d.c_read,
        c_write=d.c_write,
        per_phase_rounds=phase_rounds,
        output_page_ids=output_ids,
    )


def ehj_oracle(remote: RemoteMemory, build: Relation, probe: Relation) -> int:
    """Oracle row count for the equijoin (no accounting)."""
    b = relation_rows(remote, build)
    q = relation_rows(remote, probe)
    return len(_block_join(b, q))
