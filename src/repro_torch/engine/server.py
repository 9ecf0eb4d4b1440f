"""Concurrent multi-tenant serving: many queries on one shared hierarchy.

A :class:`Server` owns one :class:`repro_torch.remote.simulator.MemoryHierarchy`
and admits many :class:`repro_torch.engine.session.Session` pipelines concurrently.
It generalizes the single-query machinery to the fleet:

  * **Cross-query arbitration** — on every admission and finish event the
    server re-arbitrates budgets *and* tier placements across all in-flight
    queries' pending operators through the same
    :func:`repro_torch.core.arbiter.arbitrate_hierarchy` descent the session replan
    loop uses, with ``occupied=`` fed from the live hierarchy.  A finishing
    query is a capacity-release event: its held budget returns to the pool and
    its pages are freed.
  * **Admission control** — a request is admitted only when the joint
    arbitration over (its operators + every pending operator) is feasible
    under the remaining budget and capacities; otherwise it queues FIFO, with
    the closed-form admissibility check being the arbiter's own feasibility
    test (budget floors + capacity-feasible placement).
  * **Priority and preemptive demotion** — per-tenant ``priority`` weights
    scale each query's modeled latency inside the arbiter's marginal-cost
    descent, so contested quanta and fast tiers go to high-priority queries;
    at admission the server additionally *preempts* lower-priority tenants'
    resident pages off the tiers the new query was granted, demoting them via
    the hierarchy in background batches (``c_migration_hidden`` rounds,
    accounted to the admitted query).
  * **Event-driven simulated clock** — each executed task's measured ledger
    delta decomposes into per-tier work (Eq. (1) seconds per tier); every
    tier is a processor-shared resource among the tenants currently demanding
    it, and the server advances a simulated clock between chunk boundaries
    and arrivals.  A query's tiers are consumed serially, so a *single*
    admitted query reproduces the standalone session's simulated latency —
    while concurrent queries overlap different tiers, which is exactly where
    serving throughput beats FIFO-one-at-a-time.

All ledger-touching work on behalf of a query (its operators, the demotions
its admission triggered) is wrapped in checkpoints, so per-tenant
:class:`repro_torch.core.cost_model.HierarchySnapshot` deltas sum **byte-for-byte**
to the hierarchy totals (``tests/test_hierarchy_invariants.py``).

The request/slot surface follows ``repro_torch.runtime.serve_loop``'s continuous
batching shape: requests queue up, at most ``slots`` run concurrently, and a
finishing query frees its slot for the queue head.

Serving modes (``benchmarks/bench_serving.py`` compares all three):

``"arbitrated"``
  The full system: cross-query arbitration + priorities + preemption.
``"fifo"``
  One query at a time (``slots=1``) with the full single-query machinery —
  the strongest serial baseline.
``"even"``
  Static even-split sharing: every admitted query plans against
  ``budget/slots`` pages and ``capacity/slots`` per tier, with no
  cross-query re-arbitration and no preemption.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

from repro_torch.core.cost_model import (
    HierarchySnapshot,
    HierarchySpec,
    LedgerSnapshot,
    TierLevel,
)
from repro_torch.engine.session import OperatorTask, Session, TaskRun, delta_chunks

_EPS = 1e-9


# --------------------------------------------------------------------------
# The continuous-batching primitive
# --------------------------------------------------------------------------


class SlotLoop:
    """Continuous batching over an arbitrary per-item engine.

    The slot discipline both serving surfaces share: at most ``slots`` items
    are active, free slots refill FIFO from the pending queue, every active
    item advances one quantum per iteration, and a finishing item releases
    its slot immediately for the queue head.  ``start(item)`` admits an item
    into a slot and returns its slot state; ``step(item, state)`` advances
    it one quantum and returns ``True`` when it finished.

    :class:`Server` interleaves this discipline with its simulated event
    clock; ``repro_torch.runtime.serve_loop.ServeEngine`` (LM decode) delegates
    its batching loop here verbatim — one quantum is one decoded token.
    """

    def __init__(
        self,
        slots: int,
        start: Callable[[Any], Any],
        step: Callable[[Any, Any], bool],
    ) -> None:
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.start = start
        self.step = step

    def run(self, items: Sequence[Any]) -> List[Any]:
        """Drive every item to completion; returns them in finish order."""
        pending = list(items)
        active: List[Tuple[Any, Any]] = []
        finished: List[Any] = []
        while pending or active:
            while pending and len(active) < self.slots:
                item = pending.pop(0)
                active.append((item, self.start(item)))
            for entry in list(active):
                if self.step(entry[0], entry[1]):
                    active.remove(entry)
                    finished.append(entry[0])
        return finished


# --------------------------------------------------------------------------
# Requests and reports
# --------------------------------------------------------------------------


@dataclasses.dataclass
class QueryRequest:
    """One tenant's query: the serving analogue of ``serve_loop.Request``.

    ``tasks_of`` is called with a :class:`Session` over the server's shared
    hierarchy when the request is admitted; it seeds the query's input data
    into the hierarchy and returns the typed task pipeline.  It must be
    deterministic — the server also calls it against a scratch hierarchy at
    submit time to learn the pipeline's shape for the admissibility check.

    ``priority`` biases the cross-query arbiter (higher wins contested budget
    and fast tiers) and makes lower-priority tenants preemptible by this one.
    ``done`` flips when the query completes (continuous-batching shape).
    """

    rid: int
    tasks_of: Callable[[Session], Sequence[OperatorTask]]
    arrival: float = 0.0
    priority: float = 1.0
    label: str = ""
    done: bool = False


@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """One reclaim-for-admission demotion batch, per victim query."""

    time: float
    rid: int  # the admitted query that triggered the reclaim
    victim_rid: int  # the lower-priority query whose pages were demoted
    tier: str  # the tier the pages were demoted off
    pages: int


@dataclasses.dataclass
class QueryReport:
    """One served query: timing, its ledger share, and its task runs."""

    rid: int
    label: str
    priority: float
    arrival: float
    admitted: float
    finished: float
    ledger: HierarchySnapshot  # this tenant's exact share of the totals
    tasks: List[TaskRun]
    preempted_pages: int = 0  # this query's pages demoted by others' arrivals

    @property
    def latency(self) -> float:
        """Simulated seconds from arrival to completion (incl. queueing)."""
        return self.finished - self.arrival

    @property
    def wait(self) -> float:
        """Simulated seconds spent queued before admission."""
        return self.admitted - self.arrival

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rid": self.rid,
            "label": self.label,
            "priority": self.priority,
            "arrival": self.arrival,
            "admitted": self.admitted,
            "finished": self.finished,
            "latency": self.latency,
            "wait": self.wait,
            "preempted_pages": self.preempted_pages,
        }


@dataclasses.dataclass
class ServerReport:
    """One ``Server.run()``: per-query reports plus fleet-level metrics."""

    mode: str
    queries: List[QueryReport]  # completion order
    total: HierarchySnapshot  # hierarchy-wide delta over the whole run
    makespan: float  # simulated seconds, first arrival handled to last finish
    preemptions: List[PreemptionEvent]
    rearbitrations: int

    def query(self, rid: int) -> QueryReport:
        for q in self.queries:
            if q.rid == rid:
                return q
        raise KeyError(f"no query rid={rid} in report")

    @property
    def throughput(self) -> float:
        """Sustained queries/second over the makespan."""
        if self.makespan <= 0.0:
            return math.inf if self.queries else 0.0
        return len(self.queries) / self.makespan

    def latency_percentile(self, pct: float) -> float:
        """Nearest-rank percentile of per-query simulated latency."""
        if not self.queries:
            return 0.0
        lats = sorted(q.latency for q in self.queries)
        rank = max(int(math.ceil(pct / 100.0 * len(lats))), 1)
        return lats[rank - 1]

    @property
    def p50_latency(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_latency(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def tenant_total(self) -> HierarchySnapshot:
        """Sum of per-query ledgers — equals ``total`` byte-for-byte."""
        acc = HierarchySnapshot(tiers=tuple(
            (n, LedgerSnapshot()) for n, _ in self.total.tiers
        ))
        for q in self.queries:
            acc = acc + q.ledger
        return acc

    def to_dict(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "queries": [q.to_dict() for q in self.queries],
            "makespan": self.makespan,
            "throughput": self.throughput,
            "p50_latency": self.p50_latency,
            "p99_latency": self.p99_latency,
            "preempted_pages": sum(e.pages for e in self.preemptions),
            "rearbitrations": self.rearbitrations,
        }

    def __str__(self) -> str:
        lines = [
            f"serving: mode={self.mode} queries={len(self.queries)} "
            f"makespan={self.makespan:.4g}s "
            f"throughput={self.throughput:.4g} q/s "
            f"p50={self.p50_latency:.4g}s p99={self.p99_latency:.4g}s"
        ]
        for q in self.queries:
            mark = f" preempted={q.preempted_pages}p" if q.preempted_pages else ""
            lines.append(
                f"  q{q.rid} {q.label or '-'} prio={q.priority:g} "
                f"wait={q.wait:.4g}s latency={q.latency:.4g}s{mark}"
            )
        if self.preemptions:
            for e in self.preemptions:
                lines.append(
                    f"  preempt t={e.time:.4g}s q{e.rid} demoted {e.pages}p "
                    f"of q{e.victim_rid} off {e.tier}"
                )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Internal per-tenant state
# --------------------------------------------------------------------------


class _Tenant:
    """One admitted query: its session, grants, playback and ledger share."""

    def __init__(
        self,
        request: QueryRequest,
        session: Session,
        tasks: Sequence[OperatorTask],
        spec: HierarchySpec,
    ) -> None:
        self.request = request
        self.session = session
        self.tasks = list(tasks)
        self.grants: List[Any] = [None] * len(self.tasks)  # OperatorBudget
        self.cur_stats = [t.stats for t in self.tasks]
        self.outputs: Dict[int, Any] = {}
        self.started = 0  # tasks executed so far (grants below are held)
        self.runs: List[TaskRun] = []
        self.ledger = HierarchySnapshot.zero(spec)
        self.owned: Set[int] = set()  # page ids attributed to this query
        self.admitted = 0.0
        self.preempted_pages = 0
        # Simulated playback of the running task: [tier_index, seconds_left]
        # chunks consumed in order, each at the tier's processor-shared rate.
        self.chunks: Deque[List[float]] = deque()

    @property
    def held_pages(self) -> float:
        """Budget held by started tasks (released when the query finishes)."""
        return sum(self.grants[j].m_pages for j in range(self.started))


# --------------------------------------------------------------------------
# The server
# --------------------------------------------------------------------------


class Server:
    """Admit many session pipelines concurrently on one shared hierarchy.

    ``target`` must resolve to a memory hierarchy (spec, level list, or live
    :class:`MemoryHierarchy`); ``budget`` is the fleet-wide page budget the
    cross-query arbiter splits.  ``slots`` caps concurrently admitted queries
    (the continuous-batching slot count); ``eviction`` attaches the
    hierarchy's background evictor (``None`` disables both background
    demotion and preemption).  See the module docstring for ``mode``.
    """

    def __init__(
        self,
        target: Any,
        budget: float,
        *,
        policy: str = "remop",
        mode: str = "arbitrated",
        slots: int = 4,
        step: float = 1.0,
        eviction: Any = "lru",
        overlap_migration: bool = True,
        headroom: float = 0.0,
    ) -> None:
        if mode not in ("arbitrated", "even", "fifo"):
            raise ValueError(
                f"mode must be 'arbitrated', 'even' or 'fifo', got {mode!r}"
            )
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        # The bootstrap session materializes the hierarchy, attaches the
        # evictor, and doubles as the planner the arbitration calls run on.
        self._planner = Session(
            target, budget=budget, policy=policy, step=step,
            eviction=eviction, overlap_migration=overlap_migration,
            headroom=headroom,
        )
        if not self._planner.is_hierarchy:
            raise ValueError(
                "a Server needs a memory hierarchy target; multi-tenant "
                "placement has no meaning on a single tier"
            )
        self.remote = self._planner.remote
        self.spec: HierarchySpec = self._planner.hierarchy
        self.evictor = self._planner.evictor
        self.overlap = self._planner.overlap_migration
        self.budget = float(budget)
        self.policy = policy
        self.step = step
        self.mode = mode
        self.slots = 1 if mode == "fifo" else int(slots)
        self._sched = self._planner.scheduler
        self.active: List[_Tenant] = []
        self._pending: List[QueryRequest] = []
        self._probes: Dict[int, List[OperatorTask]] = {}
        self.preemptions: List[PreemptionEvent] = []
        self.rearbitrations = 0

    # -- submission ----------------------------------------------------------

    def submit(
        self, requests: Union[QueryRequest, Sequence[QueryRequest]]
    ) -> "Server":
        """Enqueue requests for the next :meth:`run` (chainable)."""
        if isinstance(requests, QueryRequest):
            requests = [requests]
        for req in requests:
            if req.rid in self._probes:
                raise ValueError(f"duplicate request rid={req.rid}")
            if req.priority <= 0:
                raise ValueError(
                    f"request rid={req.rid}: priority must be > 0, "
                    f"got {req.priority}"
                )
            if req.arrival < 0:
                raise ValueError(
                    f"request rid={req.rid}: arrival must be >= 0, "
                    f"got {req.arrival}"
                )
            self._probes[req.rid] = self._probe(req)
            self._pending.append(req)
        return self

    def _probe(self, req: QueryRequest) -> List[OperatorTask]:
        """Learn the request's pipeline shape against a scratch hierarchy.

        The scratch session shares nothing with the live hierarchy, so the
        admissibility check (which needs every operator's spec and stats)
        never seeds data — or spends ledger rounds — before admission.
        """
        scratch = Session(
            self.spec, budget=self.budget, policy=self.policy, step=self.step
        )
        tasks = list(req.tasks_of(scratch))
        if not tasks:
            raise ValueError(f"request rid={req.rid}: tasks_of returned no tasks")
        return tasks

    # -- cross-query arbitration ----------------------------------------------

    def _held_budget(self) -> float:
        return sum(ten.held_pages for ten in self.active)

    def _pinned(
        self, participants: Sequence["_Tenant"]
    ) -> Optional[List[float]]:
        """Per-tier residency that this arbitration must not reallocate.

        A tenant *participating* in the arbitration (it still has pending
        operators) has its resident pages represented as soft ``occupied``
        capacity — the descent may plan around displacing its own cold
        pages, exactly like a standalone ``Session``.  A tenant that is
        fully started but still draining its simulated chunks is outside
        the descent's control: its pages are in active use and must be
        subtracted from the capacities outright, or the joint arbitration
        over-commits fast tiers and locks churn-heavy placements in at
        task start.  Preemptive demotion is the pressure valve that turns
        a low-priority tenant's pinned fast-tier residency back into
        capacity.  Solo admission pins nothing, which is what makes
        single-tenant admission reproduce the standalone ``Session`` plan
        byte-for-byte.
        """
        part = set(id(t) for t in participants)
        drainers = [t for t in self.active if id(t) not in part]
        if not drainers:
            return None
        pinned = [0.0] * len(self.spec)
        for ten in drainers:
            for p in ten.owned:
                try:
                    pinned[self.spec.index(self.remote.tier_of(p))] += 1.0
                except KeyError:
                    continue  # freed behind our back; nothing to pin
        return pinned

    def _arbitrate_pending(
        self,
        extra: Optional[Sequence[OperatorTask]] = None,
        extra_priority: float = 1.0,
    ) -> List[Any]:
        """Re-split the unheld budget over every pending operator.

        Pending = not-yet-executed tasks of in-flight queries, plus (for an
        admission trial) a candidate's probe tasks.  Started tasks keep their
        grants until their query finishes — a finishing query is the
        capacity-release event.  Commits new grants to in-flight tenants and
        returns the candidate's grants; raises ``ValueError`` when infeasible
        (nothing is committed in that case).
        """
        tasks: List[OperatorTask] = []
        stats: List[Any] = []
        weights: List[float] = []
        owners: List[Tuple[_Tenant, int]] = []
        participants: List[_Tenant] = []
        for ten in self.active:
            w = ten.request.priority
            if ten.started < len(ten.tasks):
                participants.append(ten)
            for j in range(ten.started, len(ten.tasks)):
                tasks.append(ten.tasks[j])
                stats.append(ten.cur_stats[j])
                weights.append(w)
                owners.append((ten, j))
        n_own = len(tasks)
        if extra is not None:
            for t in extra:
                tasks.append(t)
                stats.append(t.stats)
                weights.append(extra_priority)
        if not tasks:
            return []
        budget_avail = self.budget - self._held_budget()
        grants = self._planner._arbitrate_tail(
            tasks, stats, budget_avail, weights=weights,
            pinned=self._pinned(participants),
        )
        for (ten, j), ob in zip(owners, grants[:n_own]):
            ten.grants[j] = ob
        self.rearbitrations += 1
        return grants[n_own:]

    def _rearbitrate(self) -> bool:
        """Global re-arbitration; keeps current grants when infeasible."""
        try:
            self._arbitrate_pending()
            return True
        except ValueError:
            return False

    def _even_plan(self, tasks: Sequence[OperatorTask]) -> List[Any]:
        """Static even-split baseline: 1/slots of budget and capacities."""
        from repro_torch.engine.pipeline import _plan_pipeline

        scaled = HierarchySpec(tuple(
            TierLevel(
                lv.tier,
                lv.capacity_pages if math.isinf(lv.capacity_pages)
                else max(lv.capacity_pages / self.slots, 1.0),
            )
            for lv in self.spec.levels
        ))
        plan = _plan_pipeline(
            [t.op for t in tasks], [t.stats for t in tasks],
            scaled, self.budget / self.slots, self.policy, self.step,
            eviction=self.evictor is not None,
        )
        return list(plan.ops)

    # -- admission -----------------------------------------------------------

    def _try_admit(self, req: QueryRequest, now: float) -> bool:
        """Admit ``req`` if the joint arbitration is feasible right now."""
        probe = self._probes[req.rid]
        if self.mode == "even":
            try:
                self._even_plan(probe)
            except ValueError:
                return False
        else:
            try:
                self._arbitrate_pending(extra=probe, extra_priority=req.priority)
            except ValueError:
                return False  # stays queued; nothing was committed
        session = Session(
            self.remote, budget=self.budget, policy=self.policy, step=self.step
        )
        before = set(self.remote.resident_ids())
        tasks = list(req.tasks_of(session))
        seeded = set(self.remote.resident_ids()) - before
        if [t.op for t in tasks] != [t.op for t in probe]:
            raise RuntimeError(
                f"request rid={req.rid}: tasks_of is not deterministic "
                f"(probe saw {[t.op for t in probe]}, admission got "
                f"{[t.op for t in tasks]})"
            )
        ten = _Tenant(req, session, tasks, self.spec)
        ten.owned |= seeded
        ten.admitted = now
        self.active.append(ten)
        if self.mode == "even":
            ten.grants = self._even_plan(tasks)
        else:
            try:
                self._arbitrate_pending()
            except ValueError:
                raise RuntimeError(
                    f"request rid={req.rid}: admission trial was feasible "
                    f"but the commit arbitration is not — tasks_of seeded "
                    f"data onto a finite tier?"
                ) from None
            before = len(self.preemptions)
            self._reclaim_for(ten, now)
            if len(self.preemptions) > before:
                # The reclaim unpinned fast-tier capacity; let every grant
                # (including the admitted query's) see it before executing.
                self._rearbitrate()
        self._exec_next(ten)
        return True

    def _reclaim_for(self, ten: _Tenant, now: float) -> None:
        """Preemptive demotion: clear lower-priority pages off granted tiers.

        For every non-bottom tier the new query's grants place spill on, the
        granted *buffer* pages beyond the tier's free capacity are reclaimed
        by demoting the coldest resident pages *owned by strictly
        lower-priority tenants* (active scan windows spared) one tier down,
        as background migration batches.  The rounds are accounted to the
        admitted query.

        Only the working buffers are reclaimed eagerly — not the full
        modeled footprint.  Run files and outputs stream through the tier
        and are better displaced lazily by the evictor as the operator
        actually touches them; reclaiming the whole footprint up front
        demotes a low-priority sort's still-warm runs wholesale and forces
        it to re-read them from the slow tier during its merge.
        """
        if self.evictor is None:
            return
        prio = ten.request.priority
        owner: Dict[int, _Tenant] = {}
        for other in self.active:
            if other is ten or other.request.priority >= prio:
                continue
            for p in other.owned:
                owner[p] = other
        if not owner:
            return
        need: Dict[int, float] = {}
        for _task, ob in zip(ten.tasks, ten.grants):
            if ob is None or ob.placement is None:
                continue
            ti = self.spec.index(ob.placement)
            if ti >= len(self.spec) - 1:
                continue
            # Tasks run serially, so the peak single-task buffer demand is
            # the residency the tier must absorb at any one time.
            need[ti] = max(need.get(ti, 0.0), float(ob.m_pages))
        if not need:
            return
        protected = self.evictor.scan_pages()
        label = f"srv-preempt-q{ten.request.rid}"
        self._sched.checkpoint(label)
        try:
            for ti in sorted(need):
                deficit = int(math.ceil(need[ti] - self.remote.capacity_left(ti)))
                if deficit <= 0:
                    continue
                cands = [
                    p for p in self.remote.pages_on(ti)
                    if p in owner and p not in protected
                ]
                cands.sort(key=lambda p: (self.remote.last_access(p), p))
                victims = cands[:deficit]
                if not victims:
                    continue
                self.evictor.make_room(ti + 1, len(victims))
                room = self.remote.capacity_left(ti + 1)
                if not math.isinf(room):
                    victims = victims[: max(int(room), 0)]
                if not victims:
                    continue
                self.remote.demote(victims, background=self.overlap)
                per: Dict[int, int] = {}
                for p in victims:
                    victim = owner[p]
                    victim.preempted_pages += 1
                    per[victim.request.rid] = per.get(victim.request.rid, 0) + 1
                for vrid, n in sorted(per.items()):
                    self.preemptions.append(PreemptionEvent(
                        time=now, rid=ten.request.rid, victim_rid=vrid,
                        tier=self.spec.names[ti], pages=n,
                    ))
            delta = self._sched.since(label)
        finally:
            self._sched.drop_checkpoint(label)
        ten.ledger = ten.ledger + delta
        # The reclaim precedes the first task in this query's playback.
        ten.chunks.extend(self._chunks_of(delta))

    # -- execution -----------------------------------------------------------

    def _exec_next(self, ten: _Tenant) -> None:
        """Execute the tenant's next task and queue its per-tier playback."""
        i = ten.started
        task, ob = ten.tasks[i], ten.grants[i]
        if ob is None:
            raise RuntimeError(
                f"query rid={ten.request.rid} task {i} has no grant"
            )
        before = set(self.remote.resident_ids())
        tr = ten.session.exec_task(
            task, ob, outputs=ten.outputs, stats=ten.cur_stats[i],
            label=f"srv-q{ten.request.rid}-t{i}",
        )
        after = set(self.remote.resident_ids())
        ten.owned = (ten.owned & after) | (after - before)
        ten.cur_stats[i] = tr.measured
        ten.runs.append(tr)
        ten.ledger = ten.ledger + tr.delta
        ten.started = i + 1
        Session.propagate_measured(ten.tasks, ten.cur_stats, ten.outputs, i)
        ten.chunks.extend(self._chunks_of(tr.delta))

    def _chunks_of(self, delta: HierarchySnapshot) -> List[List[float]]:
        """Decompose a ledger delta into per-tier Eq.-(1) seconds, top first."""
        return [
            [float(ti), secs]
            for ti, secs in delta_chunks(
                delta, self.spec, None, overlap_migration=self.overlap
            )
        ]

    def _advance_tenant(
        self, ten: _Tenant, now: float, reports: List[QueryReport]
    ) -> None:
        """Drained playback: start the next task or finish the query."""
        while not ten.chunks:
            if ten.started < len(ten.tasks):
                if self.mode != "even":
                    # Task boundaries re-arbitrate too: measured stats and
                    # consumed capacity feed every in-flight query's grants.
                    self._rearbitrate()
                self._exec_next(ten)
            else:
                self._finish_query(ten, now, reports)
                return

    def _finish_query(
        self, ten: _Tenant, now: float, reports: List[QueryReport]
    ) -> None:
        """Capacity-release event: free pages, report, re-arbitrate."""
        self.active.remove(ten)
        req = ten.request
        req.done = True
        resident = set(self.remote.resident_ids())
        to_free = sorted(ten.owned & resident)
        if to_free:
            # Releasing a finished query's pages is allocation bookkeeping,
            # not a transfer: no rounds, like the seeding that created them.
            self.remote.free(to_free)
        reports.append(QueryReport(
            rid=req.rid, label=req.label, priority=req.priority,
            arrival=req.arrival, admitted=ten.admitted, finished=now,
            ledger=ten.ledger, tasks=ten.runs,
            preempted_pages=ten.preempted_pages,
        ))
        if self.mode != "even":
            self._rearbitrate()

    # -- the event loop --------------------------------------------------------

    def run(self) -> ServerReport:
        """Serve every submitted request to completion (simulated clock)."""
        arrivals = sorted(self._pending, key=lambda r: (r.arrival, r.rid))
        self._pending = []
        queue: List[QueryRequest] = []
        reports: List[QueryReport] = []
        now = 0.0
        base = self._sched.snapshot()
        while arrivals or queue or self.active:
            while arrivals and arrivals[0].arrival <= now + _EPS:
                queue.append(arrivals.pop(0))
            # Priority-ordered admission, FIFO within a priority class; the
            # highest-priority waiter admits or blocks the queue (no
            # backfill past it, so one admission check never starves it).
            queue.sort(key=lambda r: (-r.priority, r.arrival, r.rid))
            while queue and len(self.active) < self.slots:
                if not self._try_admit(queue[0], now):
                    break
                queue.pop(0)
            if not self.active:
                if arrivals:
                    now = max(now, arrivals[0].arrival)
                    continue
                if queue:
                    head = queue[0]
                    raise RuntimeError(
                        f"request rid={head.rid} is inadmissible on an idle "
                        f"server (pipeline floors exceed budget "
                        f"{self.budget:g}?)"
                    )
                break
            # Processor sharing per tier: k tenants demanding one tier each
            # progress at rate 1/k; the next event is the earliest chunk
            # boundary or the next arrival.
            demand = [0] * len(self.spec)
            for ten in self.active:
                demand[int(ten.chunks[0][0])] += 1
            dt = math.inf
            for ten in self.active:
                ti = int(ten.chunks[0][0])
                dt = min(dt, ten.chunks[0][1] * demand[ti])
            if arrivals:
                dt = min(dt, max(arrivals[0].arrival - now, 0.0))
            dt = max(dt, 0.0)
            for ten in self.active:
                ti = int(ten.chunks[0][0])
                ten.chunks[0][1] -= dt / demand[ti]
            now += dt
            for ten in list(self.active):
                while ten.chunks and ten.chunks[0][1] <= _EPS:
                    ten.chunks.popleft()
                if not ten.chunks:
                    self._advance_tenant(ten, now, reports)
        total = self._sched.delta(base)
        return ServerReport(
            mode=self.mode, queries=reports, total=total, makespan=now,
            preemptions=list(self.preemptions),
            rearbitrations=self.rearbitrations,
        )
