"""Unified spill-engine layer shared by every remote-memory operator.

All three REMOP operators (BNLJ, EMS, EHJ) — and any operator added later —
move data across the remote tier exclusively through this layer:

  * :class:`TransferScheduler` (``engine.scheduler``) is the tier router and
    owner of the :class:`repro_torch.core.TransferLedger` stack: every batched
    read/write it issues is one transfer round per tier touched (its target
    is a single ``RemoteMemory`` or a whole ``MemoryHierarchy``, with writes
    named to a placement tier and reads placement-resolved), it records
    §IV-E prefetch hiding in one place, supports ledger
    ``snapshot()``/``delta()`` for per-region accounting (per-tier ledgers
    summing to hierarchy-wide D/C on a hierarchy), and can coalesce adjacent
    read rounds.
  * :class:`BufferPool` (``engine.buffers``) is the write side: a pool of
    ``capacity`` pages sliced across ``n_streams`` output streams, flushing
    one slice per batched write round when a slice fills.
  * :class:`PageCursor` (``engine.buffers``) is the read side: a page stream
    through a fixed-size buffer, one refill per read round, with an optional
    double-buffer prefetch and sorted-run merge helpers.
  * ``engine.registry`` maps operator names to :class:`OperatorSpec` bundles
    (plan type, buffer policies, runner, oracle, latency model, min_pages);
    :func:`plan_operator` is the single planning entry point used by the
    benchmark harness.
  * ``engine.session`` is the query-facing surface: a :class:`Session` owns
    the remote target, the scheduler, the policy, and the global budget, and
    exposes typed ``session.task(op, stats, inputs=...)`` construction,
    ``session.plan``/``session.explain`` (structured plan reports), and
    ``session.run`` with optional measured-feedback re-planning
    (``replan="measured"``).
  * ``engine.pipeline`` holds the shared plan dataclasses and the deprecated
    ``plan_pipeline``/``run_pipeline`` shims (ledger-exact over the session).

The accounting contract (paper §II, Definitions 1–3)
----------------------------------------------------

Latency on a remote tier is Eq. (1): ``D/BW + C*RTT``, normalized to the
dimensionless latency cost

    ``L = D + tau * C``,   ``tau = BW * RTT / page_bytes``

where ``D`` counts transferred *pages* and ``C`` counts *transfer rounds*.
The engine guarantees, for any operator built on it:

  1. **One call, one round.** Every ``TransferScheduler.read``/``write`` (and
     hence every ``PageCursor`` refill and every ``BufferPool`` slice flush)
     increments ``C`` by exactly 1 and ``D`` by the batch's page count —
     rounds are never double-counted and never split.
  2. **Ceil semantics.** Streaming ``V`` pages through a ``c``-page cursor or
     pool slice costs exactly ``ceil(V/c)`` rounds (capacity-triggered
     flushes plus one forced flush for a partial remainder), matching the
     closed forms in §III that the tests compare against.
  3. **Prefetch hiding.** With prefetch enabled, every round after a read
     stream's first is overlapped by the double buffer and recorded in
     ``c_prefetch_hidden``; the first round of a stream is never hidden.
     ``TransferLedger.latency_seconds(tier, prefetch=True)`` then charges RTT
     only for ``C - c_prefetch_hidden`` rounds.
  4. **Delta reporting.** Operators report per-call D/C as
     ``ledger.delta(snapshot)`` — immutable snapshots, no ledger copies — so
     nested/sequenced operators compose on one shared ledger.
"""

from repro_torch.engine.buffers import BufferPool, PageCursor
from repro_torch.engine.eviction import (
    ClockPolicy,
    DeadAfterFlushPolicy,
    EvictionPolicy,
    Evictor,
    LRUPolicy,
    make_policy,
)
from repro_torch.engine.scheduler import TransferScheduler
from repro_torch.engine import registry
from repro_torch.engine.registry import (
    OperatorPlan,
    OperatorSpec,
    WorkloadStats,
    model_costs,
    model_latency,
    plan_operator,
    resolve_hierarchy,
    resolve_tier,
)
from repro_torch.engine.pipeline import (
    OperatorBudget,
    PipelinePlan,
    PipelineRunResult,
    plan_pipeline,
    run_pipeline,
)
from repro_torch.engine.server import (
    PreemptionEvent,
    QueryReport,
    QueryRequest,
    Server,
    ServerReport,
    SlotLoop,
)
from repro_torch.engine.session import (
    OperatorTask,
    PlanReport,
    ReplanEvent,
    Session,
    SessionRunResult,
    TaskExplain,
    TaskOutput,
    TaskRun,
)

__all__ = [
    "Server",
    "QueryRequest",
    "QueryReport",
    "ServerReport",
    "PreemptionEvent",
    "SlotLoop",
    "Session",
    "OperatorTask",
    "TaskOutput",
    "TaskRun",
    "TaskExplain",
    "PlanReport",
    "ReplanEvent",
    "SessionRunResult",
    "BufferPool",
    "PageCursor",
    "TransferScheduler",
    "EvictionPolicy",
    "Evictor",
    "LRUPolicy",
    "ClockPolicy",
    "DeadAfterFlushPolicy",
    "make_policy",
    "OperatorPlan",
    "OperatorSpec",
    "WorkloadStats",
    "model_costs",
    "model_latency",
    "plan_operator",
    "resolve_hierarchy",
    "resolve_tier",
    "registry",
    "OperatorBudget",
    "PipelinePlan",
    "PipelineRunResult",
    "plan_pipeline",
    "run_pipeline",
]
