"""Blocked nested-loop join over simulated remote memory (Algorithm 1).

Faithful to §III-A / §IV-B: the budget ``M`` is split into an input region
(``p_R`` of it pinned for the outer block, the rest cycling inner blocks) and
an output region flushed when full.  All round accounting flows through the
spill engine: block reads are :class:`repro_torch.engine.PageCursor` streams and the
output region is a single-stream :class:`repro_torch.engine.BufferPool`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.policies import BNLJPlan
from repro_torch.engine.buffers import BufferPool, PageCursor
from repro_torch.engine.scheduler import TransferScheduler, stream_tiers
from repro_torch.remote.simulator import Relation, RemoteMemory, as_relation


# Typed input signature for the session API: ``engine.registry`` binds named
# task inputs to ``bnlj``'s positional data-plane arguments through this, and
# maps each input to the WorkloadStats field that estimates its size.
INPUTS = ("outer", "inner")
INPUT_STATS = {"outer": "size_r", "inner": "size_s"}

# Spill streams this operator writes, in declaration order — the unit of
# fractional placement (``tier=`` may map each to a different tier).
STREAMS = ("output",)


@dataclasses.dataclass
class JoinResult:
    output_page_ids: List[int]
    output_rows: int
    d_read: float
    d_write: float
    c_read: int
    c_write: int
    # Probe-side filter telemetry (None when no inner_filter was applied):
    # measured surviving fraction of the inner stream, for replan="measured".
    inner_sel_measured: Optional[float] = None


def bnlj_output(result: JoinResult) -> List[int]:
    """The operator's output pages — what a downstream task's input binds to."""
    return result.output_page_ids


def bnlj_measured(stats, result: JoinResult):
    """Feed measured output cardinality (and probe selectivity) into stats."""
    stats = dataclasses.replace(stats, out=float(len(result.output_page_ids)))
    if result.inner_sel_measured is not None and hasattr(stats, "pushdown_sel"):
        stats = dataclasses.replace(
            stats, pushdown_sel=float(result.inner_sel_measured)
        )
    return stats


def _block_join(r_rows: np.ndarray, s_rows: np.ndarray) -> np.ndarray:
    """Equijoin two blocks on column 0; returns (r_key, r_payload, s_payload)."""
    rk, sk = r_rows[:, 0], s_rows[:, 0]
    # Sort-merge inside the block pair (vectorized all-to-all comparison).
    order = np.argsort(sk, kind="stable")
    sk_sorted = sk[order]
    lo = np.searchsorted(sk_sorted, rk, side="left")
    hi = np.searchsorted(sk_sorted, rk, side="right")
    counts = hi - lo
    if counts.sum() == 0:
        return np.empty((0, 3), dtype=np.int64)
    r_idx = np.repeat(np.arange(len(rk)), counts)
    starts = np.repeat(lo, counts)
    within = np.arange(len(r_idx)) - np.repeat(np.cumsum(counts) - counts, counts)
    s_idx = order[starts + within]
    return np.stack(
        [rk[r_idx], r_rows[r_idx, 1], s_rows[s_idx, 1]], axis=1
    ).astype(np.int64)


def bnlj(
    remote: RemoteMemory,
    outer: Relation,
    inner: Relation,
    plan: BNLJPlan,
    prefetch: bool = False,
    tier=None,
    inner_filter: Union[float, None, object] = None,
    pushdown: bool = False,
) -> JoinResult:
    """Run BNLJ with the given buffer plan; returns output + ledger deltas.

    ``remote`` is a single tier or a :class:`MemoryHierarchy`; on a
    hierarchy, ``tier`` names the placement the output spill is routed to —
    a scalar, or a per-stream spec over ``STREAMS`` (see ``stream_tiers``).
    ``outer`` / ``inner`` accept a ``Relation`` or a bare page-id list
    (a DAG upstream's output), coerced via ``as_relation``.

    ``inner_filter`` applies a probe-side filter to the inner stream — a
    scalar selectivity in (0, 1] (deterministic positional keep rule) or a
    ``predicate(page) -> bool``.  With ``pushdown=False`` every inner page
    still makes the round trip and is filtered locally; with
    ``pushdown=True`` the filter executes at any capable tier holding inner
    pages and only survivors are shipped (``c_pushdown`` rounds).  The join
    output is identical either way — pushdown changes D, never results.
    """
    outer = as_relation(remote, outer)
    inner = as_relation(remote, inner)
    tiers = stream_tiers(tier, STREAMS)
    p_r = max(1, int(round(plan.outer_pages)))
    p_s = max(1, int(round(plan.inner_pages)))
    r_out = max(1, int(round(plan.output_pages)))

    sched = TransferScheduler(remote, tier=tiers["output"])
    before = sched.snapshot()
    out_pool = BufferPool(sched, r_out, outer.rows_per_page, tier=tiers["output"])

    filt_kw = None
    if inner_filter is not None:
        filt_kw = (
            {"predicate": inner_filter}
            if callable(inner_filter)
            else {"selectivity": float(inner_filter)}
        )
    inner_kept: Optional[int] = None

    for r_block in PageCursor(sched, outer.page_ids, p_r).blocks():
        if filt_kw is None:
            # Inner stream is sequential and predictable: prefetchable
            # (§IV-E); a fresh cursor per outer block, so its first round is
            # never hidden.
            for s_block in PageCursor(sched, inner.page_ids, p_s, prefetch=prefetch).blocks():
                out_pool.add(_block_join(r_block, s_block))
        else:
            # Filtered probe: same ``p_s``-page request rounds as the plain
            # stream; survivors join in one block per request chunk.
            pages = sched.read_filtered(
                inner.page_ids, batch_pages=p_s, pushdown=pushdown, **filt_kw
            )
            inner_kept = len(pages)
            for start in range(0, len(pages), p_s):
                s_rows = np.concatenate(pages[start : start + p_s], axis=0)
                out_pool.add(_block_join(r_block, s_rows))
    out_pool.flush_all()

    d = sched.delta(before)
    return JoinResult(
        output_page_ids=out_pool.pages(),
        output_rows=out_pool.rows_flushed,
        d_read=d.d_read,
        d_write=d.d_write,
        c_read=d.c_read,
        c_write=d.c_write,
        inner_sel_measured=(
            None
            if filt_kw is None or not inner.page_ids
            else (inner_kept or 0) / len(inner.page_ids)
        ),
    )


def bnlj_oracle(remote: RemoteMemory, outer: Relation, inner: Relation) -> np.ndarray:
    """Dense oracle: full equijoin, canonically sorted rows (no accounting)."""
    from repro_torch.remote.simulator import relation_rows

    r = relation_rows(remote, outer)
    s = relation_rows(remote, inner)
    out = _block_join(r, s)
    return out[np.lexsort((out[:, 2], out[:, 1], out[:, 0]))] if len(out) else out
