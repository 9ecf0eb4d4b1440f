"""Session-centric execution API: typed tasks, ``explain()``, adaptive replan.

A :class:`Session` owns everything one spilling query needs — the remote
target (a single :class:`repro_torch.remote.simulator.RemoteMemory` tier or a whole
:class:`repro_torch.remote.simulator.MemoryHierarchy`), the
:class:`repro_torch.engine.scheduler.TransferScheduler` routing every transfer
round, the buffer policy, and the global page budget — and exposes the
planning loop as one object:

  * ``session.task(op, stats, inputs=...)`` builds a typed
    :class:`OperatorTask`: named data-plane inputs validated against the
    operator's declared signature (``OperatorSpec.inputs``) instead of the
    legacy positional ``(args, kwargs)`` tuples, with ``task.output`` usable
    as a downstream task's input so pipelines chain by reference.
  * ``session.plan(tasks)`` arbitrates the global budget (and, on a
    hierarchy, the tier placements) across the tasks — the same arbitration
    the legacy ``plan_pipeline`` performed.
  * ``session.explain(tasks)`` returns a structured :class:`PlanReport`:
    per-operator budget, placement, modeled D/C/L, and spill footprint
    against tier capacity — the plan, inspectable before a single page moves.
  * ``session.run(tasks)`` executes against the session's one shared ledger
    stack; ``session.run(tasks, replan="measured")`` additionally feeds each
    finished operator's *measured* output cardinality (via the operator's
    ``measured_stats`` hook) and the live hierarchy's consumed capacity back
    into the arbiter, re-planning the remaining operators' budgets and tier
    placements mid-pipeline — the capacity-aware re-planning loop the
    ROADMAP calls for (the EHJ output estimate can be ~8x off; see
    ``benchmarks/bench_session.py``).

The legacy ``plan_pipeline``/``run_pipeline`` entry points remain as thin
deprecated shims over this module with exact-ledger parity
(``tests/test_session.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.arbiter import (
    ArbiterItem,
    HierarchyItem,
    arbitrate,
    arbitrate_hierarchy,
)
from repro_torch.core.cost_model import HierarchySpec, TierSpec
from repro_torch.engine.registry import (
    WorkloadStats,
    get,
    plan_operator,
    resolve_hierarchy,
    resolve_tier,
)
from repro_torch.engine.scheduler import TransferScheduler, stream_tiers

# --------------------------------------------------------------------------
# Typed tasks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class OperatorTask:
    """One typed pipeline member: an operator, its stats, and named inputs.

    ``inputs`` maps the operator's declared input names (see
    ``OperatorSpec.inputs``) to data-plane values — a ``Relation``, a page-id
    list, or another task's :class:`TaskOutput` (``task.output``), resolved
    when the producing task has run.  A ``TaskOutput`` input is also a DAG
    edge: ``session.run(tasks, schedule="dag")`` executes producers before
    consumers and overlaps independent subtrees.  ``options`` carries the
    remaining run keywords (``rows_per_page``, ``prefetch``, ...).  Tasks
    compare by identity so the same task object can be referenced from
    several places.
    """

    op: str
    stats: WorkloadStats
    inputs: Mapping[str, Any]
    options: Mapping[str, Any]
    label: str
    # Per-task eviction policy override: a resolved EvictionPolicy instance
    # (session.task() resolves names once, so stateful policies keep their
    # hints across runs); None uses the session's policy.
    eviction: Any = None
    # Fractional placement: {stream: tier-name-or-None} over the operator's
    # declared spill streams (``OperatorSpec.streams``); None-valued streams
    # follow the arbiter's placement.  Built by ``session.task(placement=)``.
    placement: Optional[Mapping[str, Optional[str]]] = None

    @property
    def output(self) -> "TaskOutput":
        """A reference to this task's output pages, bindable downstream."""
        return TaskOutput(self)


@dataclasses.dataclass(frozen=True, eq=False)
class TaskOutput:
    """Marker binding a downstream input to an earlier task's output pages."""

    task: OperatorTask


# --------------------------------------------------------------------------
# explain(): the structured plan report
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TaskExplain:
    """One operator's row of the plan report."""

    op: str
    label: str
    m_pages: float
    placement: str  # tier name the spill is routed to
    tau: float
    modeled_d: float
    modeled_c: float
    modeled_latency: float  # L = D + tau*C
    footprint: float  # estimated spill pages parked on the placement tier
    capacity: float  # the placement tier's total capacity (inf = unbounded)
    min_pages: float
    # Eviction plan (None when the session has no evictor): the effective
    # policy, the estimated pages the evictor must demote off the placement
    # tier to fit the footprint, and the coarse background-round estimate
    # (one demotion batch per overflowing write round of ~M_i pages).
    eviction: Optional[str] = None
    eviction_pages: float = 0.0
    eviction_rounds: float = 0.0
    # Fractional placement: (stream, tier, estimated pages) per declared
    # stream — only populated when the task carries a per-stream placement.
    streams: Tuple[Tuple[str, str, float], ...] = ()
    # Ship-vs-push verdict for the operator's pushable stream (None when the
    # operator has nothing to push): the repro_torch.core.policies.PushdownChoice
    # the arbiter priced at this task's (pages, tier).
    pushdown: Optional[Any] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["capacity"] = None if math.isinf(self.capacity) else self.capacity
        d["streams"] = [
            {"stream": s, "tier": t, "footprint": fp} for s, t, fp in self.streams
        ]
        ch = self.pushdown
        d["pushdown"] = None if ch is None else {
            "op": ch.op, "mode": ch.mode, "l_ship": ch.l_ship,
            "l_push": None if math.isinf(ch.l_push) else ch.l_push,
            "l_delta": ch.l_delta, "d_saved": ch.d_saved,
            "c_pushdown": ch.c_pushdown, "scanned": ch.scanned,
        }
        return d


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """``session.explain(tasks)``: the arbitrated plan, decomposed.

    ``tasks`` holds one :class:`TaskExplain` per operator;
    ``tier_footprints`` aggregates the estimated spill residency per tier
    against its capacity.  ``str(report)`` renders an aligned table.
    """

    policy: str
    m_total: float
    target: str  # tier name, or "dram->rdma->ssd" for a hierarchy
    tasks: Tuple[TaskExplain, ...]
    tier_footprints: Tuple[Tuple[str, float, float], ...]  # (tier, fp, cap)
    # Session eviction setup, e.g. "lru+overlap"; None when disabled.
    eviction: Optional[str] = None

    @property
    def total_modeled_latency(self) -> float:
        return sum(t.modeled_latency for t in self.tasks)

    @property
    def total_eviction_rounds(self) -> float:
        """Estimated background demotion batches across the whole plan."""
        return sum(t.eviction_rounds for t in self.tasks)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "m_total": self.m_total,
            "target": self.target,
            "eviction": self.eviction,
            "total_modeled_latency": self.total_modeled_latency,
            "total_eviction_rounds": self.total_eviction_rounds,
            "tasks": [t.to_dict() for t in self.tasks],
            "tier_footprints": [
                {"tier": name, "footprint": fp,
                 "capacity": None if math.isinf(cap) else cap}
                for name, fp, cap in self.tier_footprints
            ],
        }

    def __str__(self) -> str:
        header = (f"plan: policy={self.policy} M={self.m_total:g} "
                  f"target={self.target}")
        if self.eviction is not None:
            header += f" eviction={self.eviction}"
        cols = ("op", "label", "M_i", "tier", "D", "C", "L", "footprint/cap")
        if self.eviction is not None:
            cols = cols + ("evict",)
        rows = [cols]
        for t in self.tasks:
            cap = "inf" if math.isinf(t.capacity) else f"{t.capacity:g}"
            row = (
                t.op, t.label, f"{t.m_pages:g}", t.placement,
                f"{t.modeled_d:.1f}", f"{t.modeled_c:.1f}",
                f"{t.modeled_latency:.1f}", f"{t.footprint:g}/{cap}",
            )
            if self.eviction is not None:
                row = row + (
                    f"{t.eviction_pages:g}p/{t.eviction_rounds:g}r",
                )
            rows.append(row)
        widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
        lines = [header] + [
            "  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
            for row in rows
        ]
        for t in self.tasks:
            if t.streams:
                split = " ".join(
                    f"{s}->{tn}({fp:g}p)" for s, tn, fp in t.streams
                )
                lines.append(f"  {t.label} streams: {split}")
        for t in self.tasks:
            ch = t.pushdown
            if ch is None:
                continue
            if ch.push:
                lines.append(
                    f"  {t.label} pushdown: push({ch.op})@{t.placement} "
                    f"D-saved={ch.d_saved:g} c_pushdown={ch.c_pushdown:g} "
                    f"L{ch.l_delta:+.1f}"
                )
            else:
                why = ("tier cannot execute it" if math.isinf(ch.l_push)
                       else "compute too slow to pay for the trip")
                lines.append(
                    f"  {t.label} pushdown: ship({ch.op}) — {why}"
                )
        lines.append(f"total modeled latency L = {self.total_modeled_latency:.1f}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# run(): results and replan events
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TaskRun:
    """One executed task: the plan it ran under and its measured ledger."""

    task: OperatorTask
    op: str
    label: str
    m_pages: float
    placement: Optional[str]
    stats: WorkloadStats  # stats the executed plan was built from
    measured: WorkloadStats  # stats with the measured output fed back
    result: Any  # the operator's run result
    delta: Any  # LedgerSnapshot / HierarchySnapshot for this task
    replanned: bool = False  # True when a mid-run replan changed this task
    # Measured eviction effort during this task (0 without an evictor).
    eviction_pages: int = 0
    eviction_rounds: int = 0  # background demotion batches


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One mid-pipeline re-arbitration, after ``after_label`` finished."""

    after_index: int
    after_label: str
    measured_out: float  # the finished operator's measured output pages
    budgets_before: Tuple[float, ...]  # remaining tasks, pipeline order
    budgets_after: Tuple[float, ...]
    placements_before: Tuple[Optional[str], ...]
    placements_after: Tuple[Optional[str], ...]
    modeled_before: float  # remaining tasks' modeled L under the old split
    modeled_after: float
    # Measured eviction effort up to this replan boundary (cumulative over
    # the run so far, 0 without an evictor): background demotion batches and
    # the pages they moved.
    eviction_rounds: int = 0
    eviction_pages: int = 0


@dataclasses.dataclass
class SessionRunResult:
    """Measured per-task and total D/C of one session execution."""

    per_task: List[TaskRun]
    total: Any  # LedgerSnapshot / HierarchySnapshot
    plan: Any  # the initial PipelinePlan the run started from
    replan_events: List[ReplanEvent]
    tier: TierSpec
    hierarchy: Optional[HierarchySpec]
    # True when the session ran background demotions overlapped with compute
    # (hidden migration rounds then pay no RTT in latency_seconds()).
    overlap_migration: bool = False
    # "serial" (list order) or "dag" (dependency order, ready tasks overlap).
    schedule: str = "serial"
    # DAG runs only: Eq.-(1) wall clock with ready tasks from independent
    # subtrees overlapped under per-tier processor sharing — never more than
    # the serial ``latency_seconds()``; equal for a linear chain.
    makespan_seconds: Optional[float] = None
    # Execution-backend targets only: measured wall-clock seconds of the real
    # host<->device transfers + kernel time this run spent (read off
    # the backend's WallClock — the session itself never touches a clock).
    # ``None`` on simulator targets; never regression-gated in CI.
    wall_seconds: Optional[float] = None

    @property
    def per_op(self) -> List[Tuple[str, Any, Any]]:
        """Legacy ``(op, result, delta)`` triples, pipeline order."""
        return [(tr.op, tr.result, tr.delta) for tr in self.per_task]

    def latency_seconds(self) -> float:
        """Eq.-(1) wall latency of the whole run on the session's target."""
        if self.hierarchy is not None:
            return self.total.latency_seconds(
                self.hierarchy, overlap_migration=self.overlap_migration
            )
        return self.tier.latency_seconds(self.total.d_total, self.total.c_total)

    def latency_cost(self) -> float:
        """L of the whole run against the session's tau(s)."""
        if self.hierarchy is not None:
            return self.total.latency_cost(self.hierarchy)
        return self.total.latency_cost(self.tier.tau_pages)


# --------------------------------------------------------------------------
# Simulated concurrency: chunk decomposition + processor-shared playback
# --------------------------------------------------------------------------

_EPS = 1e-12


def delta_chunks(delta, hierarchy, tier, overlap_migration=False):
    """Decompose one task's ledger delta into ``[tier_index, seconds]`` work.

    Each chunk is the Eq.-(1) seconds the task spends on one tier (hidden
    migration rounds pay no RTT when ``overlap_migration``).  The chunks are
    the currency of :func:`playback_dag` and the server's event clock: tasks
    demanding the same tier at the same simulated time share its bandwidth.
    """
    if hierarchy is None:
        secs = tier.latency_seconds(delta.d_total, delta.c_total)
        return [[0, float(secs)]] if secs > 0 else []
    chunks = []
    for ti, (name, lv) in enumerate(zip(hierarchy.names, hierarchy.levels)):
        snap = delta.tier(name)
        c = snap.c_total
        if overlap_migration:
            c -= snap.c_migration_hidden
        secs = lv.tier.latency_seconds(snap.d_total, max(c, 0))
        if secs > 0:
            chunks.append([ti, float(secs)])
    return chunks


def playback_dag(chunks, deps) -> float:
    """Makespan of per-task chunk lists under dependency-gated sharing.

    ``chunks[i]`` is task *i*'s ``[tier, seconds]`` list (``None`` treated as
    empty); ``deps[i]`` the set of task indices it waits on.  A task starts
    the instant its last dependency finishes; concurrently-running tasks
    demanding the same tier split its bandwidth evenly (processor sharing),
    so per-tier work is conserved and the makespan never exceeds the serial
    sum — a linear chain reproduces it exactly.
    """
    n = len(chunks)
    remaining = [[list(c) for c in (chunks[i] or [])] for i in range(n)]
    finished = [False] * n
    running: set = set()
    clock = 0.0

    def admit() -> None:
        moved = True
        while moved:
            moved = False
            for i in range(n):
                if (not finished[i] and i not in running
                        and all(finished[d] for d in deps[i])):
                    if remaining[i]:
                        running.add(i)
                    else:
                        finished[i] = True  # zero-work task: instant
                    moved = True

    admit()
    while running:
        demand: Dict[int, int] = {}
        for i in running:
            ti = remaining[i][0][0]
            demand[ti] = demand.get(ti, 0) + 1
        dt = min(
            remaining[i][0][1] * demand[remaining[i][0][0]] for i in running
        )
        clock += dt
        for i in list(running):
            ti = remaining[i][0][0]
            remaining[i][0][1] -= dt / demand[ti]
            while remaining[i] and remaining[i][0][1] <= _EPS:
                remaining[i].pop(0)
            if not remaining[i]:
                running.discard(i)
                finished[i] = True
        admit()
    return clock


# --------------------------------------------------------------------------
# The session
# --------------------------------------------------------------------------


class Session:
    """One spilling query's execution context: target + budget + policy.

    ``target`` is a live ``RemoteMemory``/``MemoryHierarchy`` or anything
    that resolves to one — a tier name/``TierSpec`` (a fresh simulated tier
    is created), a ``HierarchySpec``, or a level list such as
    ``[("dram", 64), ("rdma", 256), "ssd"]``.  ``budget`` is the global page
    budget M split across every task of a pipeline.

    ``eviction`` enables proactive background demotion on a hierarchy
    target: a policy name (``"lru"``/``"clock"``/``"dead"``) or an
    :class:`repro_torch.engine.eviction.EvictionPolicy` instance attaches an
    :class:`repro_torch.engine.eviction.Evictor` to the hierarchy, so cold pages
    are demoted out of hot spill streams' way instead of the streams
    waterfalling downward.  ``overlap_migration`` (default ``True``) issues
    those demotions overlapped with operator compute — their rounds pay no
    RTT in the session's measured latency.  ``headroom`` keeps that many
    pages free on every non-bottom tier after each write.  Individual tasks
    can select a different policy via ``session.task(..., eviction=...)``.
    """

    def __init__(self, target: Any, budget: float, policy: str = "remop",
                 step: float = 1.0, eviction: Any = None,
                 overlap_migration: bool = True, headroom: float = 0.0):
        if budget <= 0:
            raise ValueError(f"session budget must be > 0 pages, got {budget}")
        self.budget = float(budget)
        self.policy = policy
        self.step = step
        self.remote = self._materialize(target)
        self.scheduler = TransferScheduler(self.remote)
        self.is_hierarchy = bool(getattr(self.remote, "is_hierarchy", False))
        self.hierarchy: Optional[HierarchySpec] = (
            self.remote.spec if self.is_hierarchy else None
        )
        self.tier: TierSpec = (
            self.hierarchy.levels[0].tier if self.is_hierarchy
            else self.remote.tier
        )
        self.evictor = None
        self.overlap_migration = False
        if eviction is not None:
            if not self.is_hierarchy:
                raise ValueError(
                    "eviction needs a memory hierarchy target; a single "
                    "tier has nowhere to demote cold pages to"
                )
            from repro_torch.engine.eviction import Evictor

            self.evictor = Evictor(
                self.remote, eviction, overlap=overlap_migration,
                headroom=headroom,
            )
            self.remote.evictor = self.evictor
            self.overlap_migration = bool(overlap_migration)
        elif getattr(self.remote, "evictor", None) is not None:
            # A live hierarchy handed in with an evictor already attached
            # (e.g. by a Server sharing one hierarchy across tenants) keeps
            # its eviction semantics: adopt it instead of silently planning
            # without eviction-aware capacities.
            self.evictor = self.remote.evictor
            self.overlap_migration = bool(self.evictor.overlap)
        self._task_seq = 0
        self._run_seq = 0
        self._exec_seq = 0

    @staticmethod
    def _materialize(target: Any):
        """Resolve ``target`` to a live store, creating one from a spec."""
        from repro_torch.remote.simulator import MemoryHierarchy, RemoteMemory

        if isinstance(target, (RemoteMemory, MemoryHierarchy)):
            return target
        if getattr(target, "is_hierarchy", False):  # duck-typed live hierarchy
            return target
        if isinstance(target, (HierarchySpec, list, tuple)):
            return MemoryHierarchy(resolve_hierarchy(target))
        return RemoteMemory(resolve_tier(target))

    @property
    def target_name(self) -> str:
        if self.hierarchy is not None:
            return "->".join(self.hierarchy.names)
        return self.tier.name

    def _placement_tau(self, placement: Optional[str]) -> float:
        """tau of a plan's placement tier (the session tier when single)."""
        if self.hierarchy is not None and placement is not None:
            return self.hierarchy.level(placement).tier.tau_pages
        return self.tier.tau_pages

    def _placement_level(self, placement: Optional[str]):
        """The placement tier's full TierLevel, capabilities included.

        A single-tier session gets a capability-free wrapper level, so
        pushdown verdicts degrade to ship there.
        """
        from repro_torch.core.cost_model import TierLevel

        if self.hierarchy is not None and placement is not None:
            return self.hierarchy.level(placement)
        return TierLevel(tier=self.tier)

    @property
    def eviction_name(self) -> Optional[str]:
        """Human-readable eviction setup, e.g. ``"lru+overlap"``."""
        if self.evictor is None:
            return None
        name = self.evictor.policy.name
        return f"{name}+overlap" if self.overlap_migration else name

    # -- task construction ---------------------------------------------------

    def task(
        self,
        op: str,
        stats: WorkloadStats,
        *,
        inputs: Optional[Mapping[str, Any]] = None,
        label: Optional[str] = None,
        eviction: Any = None,
        placement: Any = None,
        **options: Any,
    ) -> OperatorTask:
        """Build a typed task; input names are validated against the operator.

        ``inputs`` values may be live data (relations, page-id lists) or an
        earlier task's ``.output`` reference; ``options`` are passed through
        to the operator's data plane (``rows_per_page``, ``prefetch``, ...).
        ``eviction`` selects a different eviction policy for this task only
        (the session's evictor must be enabled; validated eagerly).

        ``placement`` routes the operator's spill *streams* to explicit
        hierarchy tiers (fractional placement): a list aligned with the
        operator's ``OperatorSpec.streams`` declaration, or a dict keyed by
        stream name — e.g. EHJ ``placement={"build": "dram", "stage":
        "ssd"}`` keeps spilled build partitions hot while staging probes
        cold.  ``None`` entries follow the arbiter's placement; tier names
        are validated eagerly against the session's hierarchy.
        """
        spec = get(op)  # raises ValueError for unknown operators
        if self.policy not in spec.policies:
            raise ValueError(
                f"operator {op!r} has no policy {self.policy!r}; "
                f"available: {spec.policies}"
            )
        if eviction is not None:
            if self.evictor is None:
                raise ValueError(
                    f"task {op!r} selects eviction policy {eviction!r} but "
                    f"the session has no evictor (pass eviction=... to "
                    f"Session)"
                )
            from repro_torch.engine.eviction import make_policy

            # Resolve once (failing fast on unknown names) and keep the
            # instance on the task, so a stateful policy ("dead", "clock")
            # retains its hints/sweep state across runs of the same task.
            eviction = make_policy(eviction)
        # Unknown names fail fast here; *missing* inputs only fail at run
        # time (bind_inputs), so plan()/explain() work on data-free tasks.
        unknown = sorted(set(inputs or {}) - set(spec.inputs))
        if unknown:
            raise ValueError(
                f"operator {op!r} takes inputs {list(spec.inputs)}: "
                f"unknown {unknown}"
            )
        if placement is not None:
            if not self.is_hierarchy:
                raise ValueError(
                    f"task {op!r} placement needs a memory hierarchy target; "
                    f"a single tier has no placement choice"
                )
            if not spec.streams:
                raise ValueError(
                    f"operator {op!r} declares no spill streams; per-stream "
                    f"placement is not supported"
                )
            norm = stream_tiers(placement, spec.streams)
            # Resolve names/indices eagerly so bad tiers fail at task build.
            try:
                placement = {
                    s: (None if v is None
                        else self.hierarchy.names[self.remote.tier_index(v)])
                    for s, v in norm.items()
                }
            except KeyError as e:
                raise ValueError(
                    f"task {op!r} placement: {e.args[0]}"
                ) from None
        self._task_seq += 1
        return OperatorTask(
            op=op,
            stats=stats,
            inputs=dict(inputs or {}),
            options=dict(options),
            label=label or f"{op}#{self._task_seq}",
            eviction=eviction,
            placement=placement,
        )

    def _check_tasks(
        self, tasks: Sequence[OperatorTask], dag: bool = False
    ) -> List[OperatorTask]:
        tasks = list(tasks)
        if not tasks:
            raise ValueError(
                "empty pipeline: session.plan/run/explain need at least one "
                "task (build them with session.task(op, stats, inputs=...))"
            )
        for i, task in enumerate(tasks):
            if not isinstance(task, OperatorTask):
                raise TypeError(
                    f"tasks[{i}] is {type(task).__name__}, expected an "
                    f"OperatorTask from session.task(...)"
                )
            if not dag:
                for name, value in task.inputs.items():
                    if isinstance(value, TaskOutput):
                        if not any(value.task is t for t in tasks[:i]):
                            raise ValueError(
                                f"task {task.label!r} input {name!r} "
                                f"references a task output that does not run "
                                f"earlier in this pipeline"
                            )
        if dag:
            self._check_dag(tasks)
        return tasks

    @staticmethod
    def _dag_deps(tasks: Sequence[OperatorTask]) -> List[set]:
        """Per-task dependency sets (list indices) from ``TaskOutput`` edges."""
        index = {id(t): i for i, t in enumerate(tasks)}
        return [
            {
                index[id(v.task)]
                for v in t.inputs.values()
                if isinstance(v, TaskOutput)
            }
            for t in tasks
        ]

    def _check_dag(self, tasks: Sequence[OperatorTask]) -> None:
        """Fail fast on DAG wiring errors, naming the offending task.

        Duplicate task objects or labels, ``inputs=`` referencing a task not
        part of this run, and dependency cycles each raise ``ValueError``.
        """
        seen_labels: Dict[str, int] = {}
        for i, t in enumerate(tasks):
            if any(t is u for u in tasks[:i]):
                raise ValueError(
                    f"duplicate task {t.label!r}: the same task object "
                    f"appears twice in this run"
                )
            if t.label in seen_labels:
                raise ValueError(
                    f"duplicate task name {t.label!r}: labels must be unique "
                    f"in a DAG run"
                )
            seen_labels[t.label] = i
        index = {id(t): i for i, t in enumerate(tasks)}
        for t in tasks:
            for name, value in t.inputs.items():
                if isinstance(value, TaskOutput) and id(value.task) not in index:
                    raise ValueError(
                        f"task {t.label!r} input {name!r} references task "
                        f"{value.task.label!r}, which is not part of this run"
                    )
        # Kahn's algorithm: anything left unordered sits on a cycle.
        deps = self._dag_deps(tasks)
        pending = {i: set(d) for i, d in enumerate(deps)}
        while True:
            ready = [i for i, d in pending.items() if not d]
            if not ready:
                break
            for i in ready:
                del pending[i]
            for d in pending.values():
                d.difference_update(ready)
        if pending:
            offender = tasks[min(pending)]
            raise ValueError(
                f"cyclic inputs=: task {offender.label!r} participates in a "
                f"dependency cycle"
            )

    # -- planning ------------------------------------------------------------

    def _primary_pin(self, task: OperatorTask) -> Optional[int]:
        """Arbiter tier pin for a fractionally-placed task (else ``None``).

        The arbiter assigns one (pages, tier) pair per task; a per-stream
        placement pins that choice to the *primary* stream's tier — the
        explicitly-placed stream with the largest estimated footprint — so
        the joint descent prices the task where most of its spill lands
        while the data plane routes each stream to its own tier.
        """
        if task.placement is None or self.hierarchy is None:
            return None
        explicit = {s: v for s, v in task.placement.items() if v is not None}
        if not explicit:
            return None
        spec = get(task.op)
        primary = next(iter(explicit))
        if spec.stream_footprints is not None and len(explicit) > 1:
            m0 = max(self.budget / 4.0, spec.min_pages)
            tau0 = self.tier.tau_pages
            fps = spec.stream_footprints(task.stats, tau0, m0)
            primary = max(explicit, key=lambda s: (fps.get(s, 0.0), s))
        return self.remote.tier_index(explicit[primary])

    def _task_pins(
        self, tasks: Sequence[OperatorTask]
    ) -> Optional[List[Optional[int]]]:
        if self.hierarchy is None:
            return None
        pins = [self._primary_pin(t) for t in tasks]
        return pins if any(p is not None for p in pins) else None

    def plan(self, tasks: Sequence[OperatorTask], dag: bool = False):
        """Arbitrate the session budget (and placements) across ``tasks``.

        ``dag=True`` validates the tasks as a DAG (any topological wiring)
        instead of requiring list order to be execution order.
        """
        from repro_torch.engine.pipeline import _plan_pipeline

        tasks = self._check_tasks(tasks, dag=dag)
        target = self.hierarchy if self.hierarchy is not None else self.tier
        return _plan_pipeline(
            [t.op for t in tasks], [t.stats for t in tasks],
            target, self.budget, self.policy, self.step,
            eviction=self.evictor is not None,
            pinned=self._task_pins(tasks),
        )

    @staticmethod
    def _check_plan_matches(pplan, tasks: Sequence[OperatorTask]) -> None:
        if len(pplan.ops) != len(tasks):
            raise ValueError(
                f"plan has {len(pplan.ops)} operators for {len(tasks)} tasks"
            )
        for ob, task in zip(pplan.ops, tasks):
            if ob.op != task.op:
                raise ValueError(
                    f"plan/task mismatch: plan expects {ob.op!r}, task is "
                    f"{task.op!r} ({task.label})"
                )

    def explain(
        self, tasks: Sequence[OperatorTask], plan=None, dag: bool = False
    ) -> PlanReport:
        """The structured plan report: budgets, placements, D/C/L, footprints."""
        tasks = self._check_tasks(tasks, dag=dag)
        pplan = plan if plan is not None else self.plan(tasks, dag=dag)
        self._check_plan_matches(pplan, tasks)
        rows: List[TaskExplain] = []
        usage: Dict[str, float] = {}
        for task, ob in zip(tasks, pplan.ops):
            spec = get(ob.op)
            if self.hierarchy is not None and ob.placement is not None:
                level = self.hierarchy.level(ob.placement)
                tier_name, tau = level.tier.name, level.tier.tau_pages
                capacity = level.capacity_pages
            else:
                tier_name, tau = self.tier.name, self.tier.tau_pages
                capacity = math.inf
            d, c = (spec.costs(ob.stats, tau, ob.m_pages, self.policy)
                    if spec.costs else (math.nan, math.nan))
            fp = (spec.footprint(ob.stats, tau, ob.m_pages)
                  if spec.footprint else 0.0)
            # Fractional placement: decompose the footprint per stream and
            # attribute each stream's pages to *its* tier.
            stream_rows: Tuple[Tuple[str, str, float], ...] = ()
            if task.placement is not None and spec.streams:
                sf = (spec.stream_footprints(ob.stats, tau, ob.m_pages)
                      if spec.stream_footprints else {})
                stream_rows = tuple(
                    (s, task.placement.get(s) or tier_name,
                     float(sf.get(s, 0.0)))
                    for s in spec.streams
                )
            if stream_rows:
                for _s, s_tier, s_fp in stream_rows:
                    usage[s_tier] = usage.get(s_tier, 0.0) + s_fp
            else:
                usage[tier_name] = usage.get(tier_name, 0.0) + fp
            ev_name, ev_pages, ev_rounds = None, 0.0, 0.0
            if self.evictor is not None:
                ev_name = (task.eviction.name if task.eviction is not None
                           else self.evictor.policy.name)
                # Footprint beyond the placement tier's free capacity is
                # what the evictor must demote; the round estimate assumes
                # one background batch per overflowing ~M_i-page write.
                free = capacity
                if not math.isinf(free):
                    free = max(capacity - float(
                        self.remote.tier_resident(tier_name)), 0.0)
                    ev_pages = max(fp - free, 0.0)
                    ev_rounds = math.ceil(
                        ev_pages / max(ob.m_pages, 1.0)) if ev_pages else 0.0
            rows.append(TaskExplain(
                op=ob.op, label=task.label, m_pages=ob.m_pages,
                placement=tier_name, tau=tau, modeled_d=d, modeled_c=c,
                modeled_latency=ob.modeled_latency, footprint=fp,
                capacity=capacity, min_pages=spec.min_pages,
                eviction=ev_name, eviction_pages=ev_pages,
                eviction_rounds=ev_rounds, streams=stream_rows,
                pushdown=getattr(ob, "pushdown", None),
            ))
        if self.hierarchy is not None:
            footprints = tuple(
                (name, usage.get(name, 0.0), level.capacity_pages)
                for name, level in zip(self.hierarchy.names,
                                       self.hierarchy.levels)
            )
        else:
            footprints = ((self.tier.name, usage.get(self.tier.name, 0.0),
                           math.inf),)
        return PlanReport(
            policy=self.policy, m_total=self.budget, target=self.target_name,
            tasks=tuple(rows), tier_footprints=footprints,
            eviction=self.eviction_name,
        )

    # -- execution -----------------------------------------------------------

    def exec_task(
        self,
        task: OperatorTask,
        ob: Any,
        *,
        outputs: Optional[Dict[int, Any]] = None,
        stats: Optional[WorkloadStats] = None,
        label: Optional[str] = None,
        replanned: bool = False,
    ) -> TaskRun:
        """Execute one planned task against the session's shared ledger.

        ``ob`` is the task's :class:`~repro_torch.engine.pipeline.OperatorBudget`;
        ``outputs`` maps ``id(task)`` to resolved output pages — it resolves
        this task's :class:`TaskOutput` inputs and receives its own output.
        ``stats`` overrides the stats handed to the ``measured_stats`` hook
        (defaults to ``ob.stats``).  This is the single execution path shared
        by :meth:`run` and the multi-tenant ``Server``, so both produce
        identical ledger deltas for the same plan.
        """
        spec = get(task.op)
        if outputs is None:
            outputs = {}
        base_stats = stats if stats is not None else ob.stats
        resolved = {
            name: outputs[id(value.task)]
            if isinstance(value, TaskOutput) else value
            for name, value in task.inputs.items()
        }
        args = spec.bind_inputs(resolved)
        kwargs = dict(task.options)
        # Realize the arbiter's ship-vs-push verdict as data-plane kwargs
        # (e.g. BNLJ's inner_filter/pushdown); explicit task options win.
        choice = getattr(ob, "pushdown", None)
        if choice is not None and spec.pushdown_kwargs is not None:
            for key, value in spec.pushdown_kwargs(base_stats, choice).items():
                kwargs.setdefault(key, value)
        if self.is_hierarchy:
            if task.placement is not None and spec.streams:
                # Fractional placement: every stream to its explicit tier,
                # unplaced streams follow the arbiter's placement.
                kwargs.setdefault("tier", {
                    s: (task.placement.get(s) or ob.placement)
                    for s in spec.streams
                })
            elif ob.placement is not None:
                kwargs.setdefault("tier", ob.placement)
        if label is None:
            self._exec_seq += 1
            label = f"session-exec{self._exec_seq}"
        sched = self.scheduler
        sched.checkpoint(label)
        ev_before = self.evictor.counters() if self.evictor else None
        saved_policy = None
        if self.evictor is not None and task.eviction is not None:
            saved_policy = self.evictor.policy
            self.evictor.policy = task.eviction
        try:
            result = spec.run(self.remote, *args, ob.plan, **kwargs)
            delta = sched.since(label)
        finally:
            sched.drop_checkpoint(label)
            if saved_policy is not None:
                self.evictor.policy = saved_policy
        ev_pages = ev_rounds = 0
        if ev_before is not None:
            after = self.evictor.counters()
            ev_pages = after["pages_demoted"] - ev_before["pages_demoted"]
            ev_rounds = after["demote_batches"] - ev_before["demote_batches"]
        if spec.output_of is not None:
            outputs[id(task)] = spec.output_of(result)
        measured = (spec.measured_stats(base_stats, result)
                    if spec.measured_stats else base_stats)
        return TaskRun(
            task=task, op=task.op, label=task.label,
            m_pages=ob.m_pages, placement=ob.placement,
            stats=ob.stats, measured=measured, result=result,
            delta=delta, replanned=replanned,
            eviction_pages=ev_pages, eviction_rounds=ev_rounds,
        )

    @staticmethod
    def estimate_error(planned: WorkloadStats, measured: WorkloadStats) -> float:
        """Relative cardinality error of a plan's estimate vs measurement."""
        est, got = float(planned.out), float(measured.out)
        return abs(got - est) / max(abs(est), 1.0)

    def run(
        self,
        tasks: Sequence[OperatorTask],
        replan: Optional[str] = None,
        plan=None,
        replan_threshold: Optional[float] = None,
        schedule: str = "serial",
    ) -> SessionRunResult:
        """Execute ``tasks`` in order against the session's shared ledger.

        ``replan=None`` executes the arbitrated plan as-is (ledger-exact with
        the legacy ``run_pipeline``).  ``replan="measured"`` re-arbitrates
        after each operator finishes: its measured output cardinality updates
        the downstream stats (both the finished operator's ``out`` and any
        task input bound to its ``.output``), and the remaining operators'
        budgets and tier placements are re-planned against the measured
        remaining capacity.  ``replan_threshold`` (only with
        ``replan="measured"``) skips the re-arbitration while the finished
        operator's relative cardinality error ``|measured - estimated| /
        max(estimated, 1)`` stays at or below the threshold — measured stats
        still propagate downstream, but an accurately-estimated pipeline
        records zero :class:`ReplanEvent`\\ s.  ``None`` keeps the legacy
        behaviour of re-arbitrating after every task.  ``plan`` optionally
        supplies a precomputed :class:`~repro_torch.engine.pipeline.PipelinePlan`.

        ``schedule="dag"`` treats ``TaskOutput`` inputs as DAG edges instead
        of requiring list order: tasks execute in dependency order (lowest
        list index first among ready tasks), wiring errors fail fast
        (cycles, duplicates, foreign references), ``replan="measured"``
        re-arbitrates the *remaining frontier* after each finish, and the
        result carries ``makespan_seconds`` — the Eq.-(1) wall clock with
        independent subtrees overlapped under per-tier processor sharing.
        A linear chain reproduces the serial schedule's ledgers exactly.
        """
        if replan not in (None, "measured"):
            raise ValueError(
                f"replan must be None or 'measured', got {replan!r}"
            )
        if replan_threshold is not None:
            if replan != "measured":
                raise ValueError(
                    "replan_threshold requires replan='measured'"
                )
            if replan_threshold < 0:
                raise ValueError(
                    f"replan_threshold must be >= 0, got {replan_threshold}"
                )
        if schedule not in ("serial", "dag"):
            raise ValueError(
                f"schedule must be 'serial' or 'dag', got {schedule!r}"
            )
        if schedule == "dag":
            return self._run_dag(
                tasks, replan=replan, plan=plan,
                replan_threshold=replan_threshold,
            )
        tasks = self._check_tasks(tasks)
        pplan = plan if plan is not None else self.plan(tasks)
        self._check_plan_matches(pplan, tasks)
        budgets = list(pplan.ops)  # OperatorBudget per task; replan swaps tails
        cur_stats = [ob.stats for ob in budgets]
        replanned = [False] * len(tasks)
        outputs: Dict[int, Any] = {}  # id(task) -> resolved output pages
        events: List[ReplanEvent] = []
        per_task: List[TaskRun] = []

        self._run_seq += 1
        run_label = f"session-run{self._run_seq}"
        sched = self.scheduler
        wall0 = None if sched.wall is None else sched.wall.total_seconds
        sched.checkpoint(run_label)
        try:
            for i, task in enumerate(tasks):
                ob = budgets[i]
                tr = self.exec_task(
                    task, ob, outputs=outputs, stats=cur_stats[i],
                    label=f"{run_label}/{i}", replanned=replanned[i],
                )
                measured = tr.measured
                cur_stats[i] = measured
                per_task.append(tr)
                if replan == "measured" and i + 1 < len(tasks):
                    self.propagate_measured(tasks, cur_stats, outputs, i)
                    if (replan_threshold is not None
                            and self.estimate_error(ob.stats, measured)
                            <= replan_threshold):
                        continue
                    event = self._replan_remaining(
                        tasks, budgets, cur_stats, i, measured
                    )
                    if event is not None:
                        events.append(event)
                        for j in range(i + 1, len(tasks)):
                            replanned[j] = True
            total = sched.since(run_label)
        finally:
            sched.drop_checkpoint(run_label)
        return SessionRunResult(
            per_task=per_task, total=total, plan=pplan, replan_events=events,
            tier=self.tier, hierarchy=self.hierarchy,
            overlap_migration=self.overlap_migration,
            wall_seconds=(
                None if wall0 is None else sched.wall.total_seconds - wall0
            ),
        )

    def _run_dag(
        self,
        tasks: Sequence[OperatorTask],
        replan: Optional[str],
        plan,
        replan_threshold: Optional[float],
    ) -> SessionRunResult:
        """DAG scheduler: dependency-ordered execution + overlapped makespan.

        Tasks execute one at a time against the shared ledger (the simulator
        is single-threaded), picking the lowest-index ready task — so a
        linear chain is byte-identical to the serial path, labels included.
        Concurrency is *modeled*: each task's ledger delta decomposes into
        per-tier work chunks (:func:`delta_chunks`) and
        :func:`playback_dag` replays them with ready tasks from independent
        subtrees sharing each tier's bandwidth — the same event clock the
        multi-tenant ``Server`` uses cross-query, re-used intra-query.
        """
        tasks = self._check_tasks(tasks, dag=True)
        pplan = plan if plan is not None else self.plan(tasks, dag=True)
        self._check_plan_matches(pplan, tasks)
        deps = self._dag_deps(tasks)
        n = len(tasks)
        budgets = list(pplan.ops)
        cur_stats = [ob.stats for ob in budgets]
        replanned = [False] * n
        outputs: Dict[int, Any] = {}
        events: List[ReplanEvent] = []
        per_task: List[TaskRun] = []
        chunks: List[Any] = [None] * n
        done = [False] * n

        self._run_seq += 1
        run_label = f"session-run{self._run_seq}"
        sched = self.scheduler
        wall0 = None if sched.wall is None else sched.wall.total_seconds
        sched.checkpoint(run_label)
        try:
            for _ in range(n):
                i = next(
                    j for j in range(n)
                    if not done[j] and all(done[d] for d in deps[j])
                )
                task, ob = tasks[i], budgets[i]
                tr = self.exec_task(
                    task, ob, outputs=outputs, stats=cur_stats[i],
                    label=f"{run_label}/{i}", replanned=replanned[i],
                )
                measured = tr.measured
                cur_stats[i] = measured
                per_task.append(tr)
                chunks[i] = delta_chunks(
                    tr.delta, self.hierarchy, self.tier,
                    overlap_migration=self.overlap_migration,
                )
                done[i] = True
                remaining = [j for j in range(n) if not done[j]]
                if replan == "measured" and remaining:
                    self.propagate_measured(
                        tasks, cur_stats, outputs, i, targets=remaining
                    )
                    if (replan_threshold is not None
                            and self.estimate_error(ob.stats, measured)
                            <= replan_threshold):
                        continue
                    budget_rem = self.budget - sum(
                        budgets[k].m_pages for k in range(n) if done[k]
                    )
                    event = self._replan_indices(
                        tasks, budgets, cur_stats, remaining, budget_rem,
                        i, measured,
                    )
                    if event is not None:
                        events.append(event)
                        for j in remaining:
                            replanned[j] = True
            total = sched.since(run_label)
        finally:
            sched.drop_checkpoint(run_label)
        return SessionRunResult(
            per_task=per_task, total=total, plan=pplan, replan_events=events,
            tier=self.tier, hierarchy=self.hierarchy,
            overlap_migration=self.overlap_migration,
            schedule="dag", makespan_seconds=playback_dag(chunks, deps),
            wall_seconds=(
                None if wall0 is None else sched.wall.total_seconds - wall0
            ),
        )

    # -- mid-pipeline re-arbitration ------------------------------------------

    @staticmethod
    def propagate_measured(
        tasks: Sequence[OperatorTask],
        cur_stats: List[WorkloadStats],
        outputs: Mapping[int, Any],
        done: int,
        targets: Optional[Sequence[int]] = None,
    ) -> None:
        """Feed task ``done``'s measured output sizes into downstream stats.

        Updates ``cur_stats`` in place for every later task whose input binds
        to the finished task's output (the operator's ``input_stats`` mapping
        names the stats field the input sizes).  ``targets`` restricts the
        update to specific task indices (the DAG scheduler passes its
        unfinished frontier; the default is every later list position).
        Pure stats bookkeeping — no arbitration — so callers can propagate
        measurements even when a replan threshold suppresses the re-split
        itself.
        """
        finished_task = tasks[done]
        measured_sel = cur_stats[done].pushdown_sel
        if targets is None:
            targets = range(done + 1, len(tasks))
        for j in targets:
            spec_j = get(tasks[j].op)
            for name, value in tasks[j].inputs.items():
                if not (isinstance(value, TaskOutput)
                        and value.task is finished_task):
                    continue
                field = spec_j.input_stats.get(name)
                resolved = outputs.get(id(finished_task))
                if field is None or resolved is None:
                    continue
                cur_stats[j] = dataclasses.replace(
                    cur_stats[j], **{field: float(len(resolved))}
                )
                # A downstream task filtering the same annotated chain
                # refines its selectivity estimate from the measured one,
                # so the next re-arbitration re-decides ship-vs-push.
                if (measured_sel is not None
                        and cur_stats[j].pushdown_sel is not None):
                    cur_stats[j] = dataclasses.replace(
                        cur_stats[j], pushdown_sel=float(measured_sel)
                    )

    def _replan_remaining(
        self,
        tasks: Sequence[OperatorTask],
        budgets: List[Any],
        cur_stats: List[WorkloadStats],
        done: int,
        measured: WorkloadStats,
    ) -> Optional[ReplanEvent]:
        """Re-split the remaining budget after task ``done`` finished.

        Re-arbitrates the remaining budget over tasks ``done+1..`` at their
        current (measured-updated) stats — on a hierarchy, against the
        *measured* per-tier residency (``occupied``), so placements react to
        capacity actually consumed.  Returns a :class:`ReplanEvent` when the
        split changed, ``None`` when the re-arbitration confirmed the current
        plan (or was infeasible, in which case the current plan is kept).
        """
        remaining = list(range(done + 1, len(tasks)))
        budget_rem = self.budget - sum(budgets[k].m_pages
                                       for k in range(done + 1))
        return self._replan_indices(
            tasks, budgets, cur_stats, remaining, budget_rem, done, measured
        )

    def _replan_indices(
        self,
        tasks: Sequence[OperatorTask],
        budgets: List[Any],
        cur_stats: List[WorkloadStats],
        remaining: Sequence[int],
        budget_rem: float,
        done: int,
        measured: WorkloadStats,
    ) -> Optional[ReplanEvent]:
        """Re-arbitrate ``budget_rem`` over the ``remaining`` task indices.

        The index-list generalization shared by the serial tail replan and
        the DAG scheduler's frontier replan (the frontier is not a list
        suffix once independent subtrees interleave).
        """
        from repro_torch.engine.pipeline import _modeled_latency

        finished_task = tasks[done]
        before_m = tuple(budgets[j].m_pages for j in remaining)
        before_p = tuple(budgets[j].placement for j in remaining)
        # Price the *old* split at the *updated* stats, so before/after in the
        # event measure what the re-split itself bought (pushdown verdicts
        # re-derived at the measured selectivity, symmetric with the re-split).
        before_l = sum(
            _modeled_latency(
                get(tasks[j].op), cur_stats[j],
                self._placement_level(budgets[j].placement),
                budgets[j].m_pages, self.policy,
            )
            for j in remaining
        )
        try:
            new_budgets = self._arbitrate_tail(
                [tasks[j] for j in remaining],
                [cur_stats[j] for j in remaining],
                budget_rem,
            )
        except ValueError:
            # No feasible re-split (e.g. measured residency ate the capacity
            # the estimate assumed): keep the current plan rather than fail a
            # query the static path would have completed.
            return None
        changed = any(
            abs(nb.m_pages - budgets[j].m_pages) > 1e-9
            or nb.placement != budgets[j].placement
            or nb.plan != budgets[j].plan
            or nb.pushdown != getattr(budgets[j], "pushdown", None)
            for j, nb in zip(remaining, new_budgets)
        )
        if not changed:
            return None
        for j, nb in zip(remaining, new_budgets):
            budgets[j] = nb
        ev = (self.evictor.counters() if self.evictor is not None
              else {"demote_batches": 0, "pages_demoted": 0})
        return ReplanEvent(
            after_index=done,
            after_label=finished_task.label,
            measured_out=measured.out,
            budgets_before=before_m,
            budgets_after=tuple(nb.m_pages for nb in new_budgets),
            placements_before=before_p,
            placements_after=tuple(nb.placement for nb in new_budgets),
            modeled_before=before_l,
            modeled_after=sum(nb.modeled_latency for nb in new_budgets),
            eviction_rounds=ev["demote_batches"],
            eviction_pages=ev["pages_demoted"],
        )

    def _arbitrate_tail(
        self,
        tasks: Sequence[OperatorTask],
        stats: Sequence[WorkloadStats],
        budget: float,
        weights: Optional[Sequence[float]] = None,
        pinned: Optional[Sequence[float]] = None,
    ) -> List[Any]:
        """Arbitrate ``budget`` over the remaining tasks with updated stats.

        ``weights`` (one per task, default all 1.0) scale each task's modeled
        latency inside the arbiter's marginal-cost descent — the multi-tenant
        ``Server`` passes per-tenant priorities here so high-priority queries
        win the contested budget quanta and fast-tier placements.  Reported
        ``modeled_latency`` stays unweighted.

        ``pinned`` (per-tier page counts, hierarchy targets only) marks
        residency that must NOT be treated as evictable: those pages are
        subtracted from both the tier capacities and the soft ``occupied``
        residency before arbitration.  A single query's own cold pages are
        legitimately evictable (the standalone semantics), but another
        in-flight query's pages are about to be read again — planning spill
        on top of them causes demotion thrash, so the ``Server`` pins every
        admitted tenant's residency whenever two or more queries share the
        hierarchy.
        """
        from repro_torch.core.cost_model import TierLevel
        from repro_torch.engine.pipeline import (
            OperatorBudget,
            _modeled_latency,
            pushdown_choice,
        )

        policy = self.policy
        if weights is None:
            weights = [1.0] * len(tasks)
        if len(weights) != len(tasks):
            raise ValueError(
                f"{len(weights)} weights for {len(tasks)} tasks"
            )
        if self.hierarchy is None:
            tau = self.tier.tau_pages
            level = TierLevel(tier=self.tier)  # capability-free: always ship
            items = [
                ArbiterItem(
                    name=t.op, min_pages=get(t.op).min_pages,
                    latency_of=lambda m, s=get(t.op), st=st, w=w: w * s.model(
                        st, tau, m, policy
                    ),
                )
                for t, st, w in zip(tasks, stats, weights)
            ]
            alloc, _ = arbitrate(items, budget, step=self.step)
            return [
                OperatorBudget(
                    op=t.op, stats=st, m_pages=m,
                    plan=plan_operator(t.op, st, self.tier, m, policy=policy),
                    modeled_latency=get(t.op).model(st, tau, m, policy),
                    pushdown=pushdown_choice(get(t.op), st, level, m, policy),
                )
                for t, st, m in zip(tasks, stats, alloc)
            ]
        hspec = self.hierarchy
        taus = hspec.taus
        occupied = [
            float(self.remote.tier_resident(t)) for t in range(len(hspec))
        ]
        capacities = list(hspec.capacities)
        if pinned is not None:
            if len(pinned) != len(hspec):
                raise ValueError(
                    f"{len(pinned)} pinned counts for {len(hspec)} tiers"
                )
            occupied = [max(o - p, 0.0) for o, p in zip(occupied, pinned)]
            capacities = [
                c if math.isinf(c) else max(c - p, 0.0)
                for c, p in zip(capacities, pinned)
            ]
        items = []
        for t, st, w in zip(tasks, stats, weights):
            spec = get(t.op)
            footprint = spec.footprint or (lambda st_, tau_, m_: 0.0)
            items.append(HierarchyItem(
                name=t.op, min_pages=spec.min_pages,
                latency_of=lambda m, ti, s=spec, st=st, w=w: w * _modeled_latency(
                    s, st, hspec.levels[ti], m, policy
                ),
                footprint_of=lambda m, ti, fp=footprint, st=st: fp(
                    st, taus[ti], m
                ),
            ))
        alloc, placement, _ = arbitrate_hierarchy(
            items, budget, capacities, step=self.step, occupied=occupied,
            eviction=self.evictor is not None,
            pinned_tiers=self._task_pins(tasks),
        )
        return [
            OperatorBudget(
                op=t.op, stats=st, m_pages=m,
                plan=plan_operator(t.op, st, hspec.levels[ti].tier, m,
                                   policy=policy),
                modeled_latency=_modeled_latency(
                    get(t.op), st, hspec.levels[ti], m, policy
                ),
                placement=hspec.names[ti],
                pushdown=pushdown_choice(
                    get(t.op), st, hspec.levels[ti], m, policy
                ),
            )
            for t, st, m, ti in zip(tasks, stats, alloc, placement)
        ]
