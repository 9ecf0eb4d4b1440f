"""External merge sort over simulated remote memory (Algorithm 2).

Run formation sorts M-page chunks in "local memory" and writes them back as
sorted runs; the merge phase merges groups of ``k`` runs through per-run input
buffers of ``floor(R_in/k)`` pages and an ``R_out``-page output buffer.  Each
run streams through a :class:`repro_torch.engine.PageCursor` (one refill = one read
round) and the output region is a :class:`repro_torch.engine.BufferPool` (one slice
flush = one write round), exactly as analysed in §III-B (and the §II-C worked
example).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.policies import EMSPlan
from repro_torch.engine.buffers import BufferPool, PageCursor
from repro_torch.engine.scheduler import TransferScheduler, stream_tiers
from repro_torch.remote.simulator import RemoteMemory


# Typed input signature for the session API: ``engine.registry`` binds named
# task inputs to ``ems_sort``'s positional data-plane arguments through this,
# and maps each input to the WorkloadStats field that estimates its size.
INPUTS = ("page_ids",)
INPUT_STATS = {"page_ids": "size_r"}

# Spill streams this operator writes, in declaration order — the unit of
# fractional placement: intermediate sorted runs vs. the final merged output.
STREAMS = ("runs", "output")


@dataclasses.dataclass
class SortResult:
    run_page_ids: List[int]  # final single sorted run
    passes: int
    d_read: float
    d_write: float
    c_read: int
    c_write: int


def ems_output(result: SortResult) -> List[int]:
    """The operator's output pages — what a downstream task's input binds to."""
    return result.run_page_ids


def ems_measured(stats, result: SortResult):
    """Feed the measured output cardinality back into the workload stats."""
    return dataclasses.replace(stats, out=float(len(result.run_page_ids)))


def _merge_group(
    sched: TransferScheduler,
    runs: List[List[int]],
    plan: EMSPlan,
    rows_per_page: int,
    prefetch: bool,
    out_tier=None,
) -> List[int]:
    """Merge up to k runs into one; returns the new run's page ids."""
    per_run = max(1, int(plan.input_pages) // max(len(runs), 1))
    r_out = max(1, int(round(plan.output_pages)))
    cursors = [
        PageCursor(sched, r, per_run, prefetch=prefetch, ravel=True) for r in runs
    ]
    out_pool = BufferPool(sched, r_out, rows_per_page, tier=out_tier)

    while True:
        for c in cursors:
            c.refill()  # 1 read round per refill; no-op unless buffer is empty
        active = [c for c in cursors if c.buffered > 0]
        if not active:
            break
        # Emit everything provably below every active run's buffered horizon
        # (batched tournament: same refill/flush rounds as tuple-at-a-time).
        bounds = [b for c in active if (b := c.safe_bound()) is not None]
        bound = min(bounds) if bounds else None
        taken = [c.take_upto(bound) for c in active]
        merged = sched.sort_keys(np.concatenate(taken))
        if len(merged) == 0:
            # Bound excluded everything buffered: force the binding cursor on.
            binding = min(
                active, key=lambda c: c.safe_bound() or np.iinfo(np.int64).max
            )
            out_pool.add(sched.sort_keys(binding.take_upto(None)))
        else:
            out_pool.add(merged)
    out_pool.flush_all()
    return out_pool.pages()


def ems_sort(
    remote: RemoteMemory,
    page_ids: List[int],
    plan: EMSPlan,
    rows_per_page: int,
    prefetch: bool = False,
    count_run_formation: bool = True,
    tier=None,
) -> SortResult:
    """Full external merge sort of the pages' int64 keys under `plan`.

    ``remote`` is a single tier or a :class:`MemoryHierarchy`; on a
    hierarchy, ``tier`` names the placement runs and merge output spill to —
    a scalar, or a per-stream spec over ``STREAMS`` routing intermediate
    runs and the final merged output to different tiers.
    """
    if hasattr(page_ids, "page_ids"):  # accept a Relation (DAG scan output)
        page_ids = list(page_ids.page_ids)
    tiers = stream_tiers(tier, STREAMS)
    sched = TransferScheduler(remote, tier=tiers["output"])
    before = sched.snapshot()
    m_pages = max(1, int(plan.m))

    # ---- run formation: sort M-page chunks locally (§III-B a) -------------
    runs: List[List[int]] = []
    for start in range(0, len(page_ids), m_pages):
        ids = page_ids[start : start + m_pages]
        if count_run_formation:
            pages = sched.read(ids)  # 1 round
        else:
            pages = remote.peek_batch(ids)
        data = sched.sort_keys(np.concatenate([p.ravel() for p in pages]))
        out_pages = [data[i : i + rows_per_page] for i in range(0, len(data), rows_per_page)]
        if count_run_formation:
            runs.append(sched.write(out_pages, tier=tiers["runs"]))  # 1 round
        else:
            runs.append(remote.put_local(out_pages))

    # ---- merge passes (Algorithm 2) ----------------------------------------
    passes = 0
    while len(runs) > 1:
        # The last pass (a single merge group) writes the *output* stream;
        # every earlier pass writes intermediate runs.
        final = len(runs) <= plan.k
        out_tier = tiers["output"] if final else tiers["runs"]
        nxt: List[List[int]] = []
        for g in range(0, len(runs), plan.k):
            group = runs[g : g + plan.k]
            if len(group) == 1:
                nxt.append(group[0])
            else:
                nxt.append(
                    _merge_group(
                        sched, group, plan, rows_per_page, prefetch, out_tier=out_tier
                    )
                )
        runs = nxt
        passes += 1

    d = sched.delta(before)
    return SortResult(
        run_page_ids=runs[0] if runs else [],
        passes=passes,
        d_read=d.d_read,
        d_write=d.d_write,
        c_read=d.c_read,
        c_write=d.c_write,
    )


def ems_oracle(remote: RemoteMemory, page_ids: List[int]) -> np.ndarray:
    """Dense oracle: all keys, fully sorted (no accounting)."""
    return np.sort(np.concatenate([p.ravel() for p in remote.peek_batch(page_ids)]))
