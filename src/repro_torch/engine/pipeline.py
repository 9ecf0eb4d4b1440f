"""Pipeline planning and execution: many operators, one budget, one memory stack.

``plan_pipeline`` is the query-level entry point.  On a single tier it wraps
each registered operator's latency model (``OperatorSpec.model``) as an
:class:`repro_torch.core.arbiter.ArbiterItem`, lets the arbiter split the global
page budget M, and then plans every operator at its awarded budget through
the normal ``plan_operator`` path — so a single-operator pipeline degenerates
to exactly the standalone plan.  On a **memory hierarchy** (a
:class:`repro_torch.core.cost_model.HierarchySpec`, a live
:class:`repro_torch.remote.simulator.MemoryHierarchy`, or a level list such as
``[("dram", 64), ("rdma", 256), "ssd"]``) it instead builds
:class:`repro_torch.core.arbiter.HierarchyItem`\\ s — each operator's modeled cost
as a function of (pages, tier) plus its spill footprint — and the
hierarchy-wide arbiter jointly assigns every operator a budget *and* a tier
placement under the per-tier capacities, never worse than the best
single-tier placement.

``run_pipeline`` executes a planned pipeline against *one shared* remote
target: all operators account on the same ledger stack, and per-operator D/C
come back as snapshot deltas (engine contract rule 4), so pipeline totals are
measured, not summed estimates.  On a hierarchy each operator's spill writes
are routed to its planned placement tier.

.. deprecated::
    ``plan_pipeline`` and ``run_pipeline`` are thin shims over the
    session-centric API (:class:`repro_torch.engine.session.Session`): build typed
    tasks with ``session.task(op, stats, inputs=...)`` and use
    ``session.plan`` / ``session.run`` / ``session.explain`` instead.  The
    shims stay ledger-exact with ``Session.run`` (tests/test_session.py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.arbiter import ArbiterItem, HierarchyItem, arbitrate, arbitrate_hierarchy
from repro_torch.core.cost_model import HierarchySpec, TierLevel, TierSpec
from repro_torch.core.policies import PushdownChoice
from repro_torch.engine.registry import (
    OperatorPlan,
    WorkloadStats,
    get,
    plan_operator,
    resolve_hierarchy,
    resolve_tier,
)


@dataclasses.dataclass(frozen=True)
class OperatorBudget:
    """One pipeline member's share: awarded pages, plan, and modeled cost.

    ``placement`` names the hierarchy tier the operator's spill is routed to
    (``None`` on a single-tier pipeline, where the pipeline tier applies).
    ``pushdown`` is the arbiter's ship-pages vs. ship-compute verdict for
    the operator's pushable stream at its awarded (pages, tier) — ``None``
    when the operator has nothing to push.  ``modeled_latency`` includes the
    verdict's ``l_delta`` so plan totals match the arbitration objective.
    """

    op: str
    stats: WorkloadStats
    m_pages: float
    plan: OperatorPlan
    modeled_latency: float
    placement: Optional[str] = None
    pushdown: Optional[PushdownChoice] = None


def pushdown_choice(
    spec, stats: WorkloadStats, level: TierLevel, m: float, policy: str
) -> Optional[PushdownChoice]:
    """The operator's priced ship-vs-push verdict at one (pages, tier) point.

    ``None`` when the operator declares no pushdown hook or has nothing to
    push.  On a plain (single) tier, wrap the tier in a capability-free
    ``TierLevel(tier=...)`` — the verdict is then always ship, but the
    data-plane kwargs (e.g. BNLJ's ``inner_filter``) still apply, so a
    filter annotation stays *semantically* physical everywhere.
    """
    if spec.pushdown is None:
        return None
    return spec.pushdown(stats, level, m, policy)


def _modeled_latency(
    spec, stats: WorkloadStats, level: TierLevel, m: float, policy: str
) -> float:
    """Modeled L = D + tau*C plus the pushdown verdict's l_delta (<= 0)."""
    base = spec.model(stats, level.tier.tau_pages, m, policy)
    ch = pushdown_choice(spec, stats, level, m, policy)
    return base + (ch.l_delta if ch is not None else 0.0)


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """An arbitrated pipeline: per-operator budgets summing to ``m_total``.

    ``hierarchy`` is set when the pipeline was planned against a memory
    hierarchy; ``tier`` then holds the hierarchy's top tier for the legacy
    single-tier accessors.
    """

    tier: TierSpec
    m_total: float
    policy: str
    ops: Tuple[OperatorBudget, ...]
    hierarchy: Optional[HierarchySpec] = None

    @property
    def budgets(self) -> Tuple[float, ...]:
        return tuple(ob.m_pages for ob in self.ops)

    @property
    def placements(self) -> Tuple[Optional[str], ...]:
        return tuple(ob.placement for ob in self.ops)

    @property
    def total_modeled_latency(self) -> float:
        return sum(ob.modeled_latency for ob in self.ops)


def _broadcast_stats(
    ops: Sequence[str], stats: Union[WorkloadStats, Sequence[WorkloadStats]]
) -> List[WorkloadStats]:
    if isinstance(stats, WorkloadStats):
        return [stats] * len(ops)
    stats = list(stats)
    if len(stats) != len(ops):
        raise ValueError(
            f"got {len(stats)} WorkloadStats for {len(ops)} operators"
        )
    return stats


def _is_hierarchy(tier: Any) -> bool:
    return (
        isinstance(tier, HierarchySpec)
        or getattr(tier, "is_hierarchy", False)
        or isinstance(tier, (list, tuple))
    )


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use the session API instead "
        f"(repro_torch.engine.Session: {new})",
        DeprecationWarning,
        stacklevel=3,
    )


def plan_pipeline(
    ops: Sequence[str],
    stats: Union[WorkloadStats, Sequence[WorkloadStats]],
    tier: Any,
    m_pages: float,
    policy: str = "remop",
    step: float = 1.0,
) -> PipelinePlan:
    """Deprecated shim over ``Session.plan``: split ``m_pages`` across ``ops``.

    ``stats`` is one :class:`WorkloadStats` per operator (or a single one
    broadcast to all).  ``tier`` is a single tier (TierSpec or name) or a
    memory hierarchy (spec, live ``MemoryHierarchy``, or level list); on a
    hierarchy the arbiter jointly assigns budgets and tier placements.
    Budgets sum to exactly ``m_pages`` and each respects the operator's
    ``min_pages``; infeasible budgets raise ``ValueError``.
    """
    _warn_deprecated("plan_pipeline", "session.plan(tasks)")
    return _plan_pipeline(ops, stats, tier, m_pages, policy, step)


def _plan_pipeline(
    ops: Sequence[str],
    stats: Union[WorkloadStats, Sequence[WorkloadStats]],
    tier: Any,
    m_pages: float,
    policy: str = "remop",
    step: float = 1.0,
    eviction: bool = False,
    pinned: Optional[Sequence[Optional[int]]] = None,
) -> PipelinePlan:
    """The shared planning core behind ``Session.plan`` and the legacy shim.

    ``eviction=True`` plans for a hierarchy with a background evictor:
    tier capacities are soft and placement costs blend per-tier taus by
    where each footprint comes to rest (see
    :func:`repro_torch.core.arbiter.arbitrate_hierarchy`).  ``pinned`` (hierarchy
    targets only; one tier index or ``None`` per operator) fixes operators
    with an explicit ``placement=`` on their pinned tier while the arbiter
    still grants them budget.
    """
    if not list(ops):
        raise ValueError(
            "empty pipeline: plan_pipeline needs at least one operator "
            "(got ops=[])"
        )
    if _is_hierarchy(tier):
        return _plan_pipeline_hierarchy(
            ops, stats, resolve_hierarchy(tier), m_pages, policy, step,
            eviction=eviction, pinned=pinned,
        )
    tier_spec = resolve_tier(tier)
    tau = tier_spec.tau_pages
    # Capability-free level: the ship-vs-push verdict on a single tier is
    # always ship, but it still carries the filter annotation to the data
    # plane (OperatorSpec.pushdown_kwargs).
    level = TierLevel(tier=tier_spec)
    all_stats = _broadcast_stats(ops, stats)
    items = []
    for op, st in zip(ops, all_stats):
        spec = get(op)  # raises ValueError for unknown operators
        if spec.model is None:
            raise ValueError(f"operator {op!r} has no latency model")
        items.append(ArbiterItem(
            name=op,
            min_pages=spec.min_pages,
            latency_of=lambda m, spec=spec, st=st: spec.model(st, tau, m, policy),
        ))
    alloc, _ = arbitrate(items, float(m_pages), step=step)
    budgets = tuple(
        OperatorBudget(
            op=op,
            stats=st,
            m_pages=m,
            plan=plan_operator(op, st, tier_spec, m, policy=policy),
            modeled_latency=get(op).model(st, tau, m, policy),
            pushdown=pushdown_choice(get(op), st, level, m, policy),
        )
        for op, st, m in zip(ops, all_stats, alloc)
    )
    return PipelinePlan(tier=tier_spec, m_total=float(m_pages), policy=policy,
                        ops=budgets)


def _plan_pipeline_hierarchy(
    ops: Sequence[str],
    stats: Union[WorkloadStats, Sequence[WorkloadStats]],
    hspec: HierarchySpec,
    m_pages: float,
    policy: str,
    step: float,
    eviction: bool = False,
    pinned: Optional[Sequence[Optional[int]]] = None,
) -> PipelinePlan:
    """Joint (pages, tier) assignment over a hierarchy's taus and capacities."""
    taus = hspec.taus
    all_stats = _broadcast_stats(ops, stats)
    items = []
    for op, st in zip(ops, all_stats):
        spec = get(op)  # raises ValueError for unknown operators
        if spec.model is None:
            raise ValueError(f"operator {op!r} has no latency model")
        footprint = spec.footprint or (lambda st_, tau_, m_: 0.0)
        items.append(HierarchyItem(
            name=op,
            min_pages=spec.min_pages,
            # Pushdown-aware placement cost: a compute-capable tier's
            # l_delta (<= 0) can beat a faster dumb tier.
            latency_of=lambda m, t, spec=spec, st=st: _modeled_latency(
                spec, st, hspec.levels[t], m, policy
            ),
            footprint_of=lambda m, t, fp=footprint, st=st: fp(st, taus[t], m),
        ))
    alloc, placement, _ = arbitrate_hierarchy(
        items, float(m_pages), hspec.capacities, step=step, eviction=eviction,
        pinned_tiers=pinned,
    )
    budgets = tuple(
        OperatorBudget(
            op=op,
            stats=st,
            m_pages=m,
            plan=plan_operator(op, st, hspec.levels[t].tier, m, policy=policy),
            modeled_latency=_modeled_latency(
                get(op), st, hspec.levels[t], m, policy
            ),
            placement=hspec.names[t],
            pushdown=pushdown_choice(get(op), st, hspec.levels[t], m, policy),
        )
        for op, st, m, t in zip(ops, all_stats, alloc, placement)
    )
    return PipelinePlan(tier=hspec.levels[0].tier, m_total=float(m_pages),
                        policy=policy, ops=budgets, hierarchy=hspec)


@dataclasses.dataclass
class PipelineRunResult:
    """Measured per-operator and total D/C of one shared-target execution.

    ``total`` (and each per-op delta) is a ``LedgerSnapshot`` for a
    single-tier run and a ``HierarchySnapshot`` — per-tier ledgers summing to
    the hierarchy-wide D/C — for a hierarchy run.
    """

    per_op: List[Tuple[str, Any, Any]]  # (op, run result, snapshot delta)
    total: Any

    def latency_seconds(self, tier) -> float:
        """Eq.-(1) wall latency of the run.

        ``tier`` is the run's ``TierSpec`` for a single-tier execution, or
        the ``HierarchySpec`` (e.g. ``pplan.hierarchy``) for a hierarchy
        execution — pricing a multi-tier run's aggregate rounds with one
        tier's constants would be silently wrong, so that combination raises.
        """
        is_hier_run = hasattr(self.total, "tiers")
        if isinstance(tier, HierarchySpec):
            if not is_hier_run:
                raise TypeError(
                    "single-tier run: pass the run's TierSpec, not a "
                    "HierarchySpec (the plan's placements were not routed)"
                )
            return self.total.latency_seconds(tier)
        if is_hier_run:
            raise TypeError(
                "hierarchy run: pass the HierarchySpec (e.g. pplan.hierarchy)"
                " so each tier's rounds are priced with its own (BW, RTT)"
            )
        return tier.latency_seconds(self.total.d_total, self.total.c_total)

    def latency_cost(self, tau) -> float:
        """L of the whole run; ``tau`` is a scalar or a ``HierarchySpec``."""
        return self.total.latency_cost(tau)


def run_pipeline(
    remote,
    pplan: PipelinePlan,
    workloads: Sequence[Tuple[Sequence[Any], Optional[Dict[str, Any]]]],
) -> PipelineRunResult:
    """Deprecated shim over ``Session.run``: execute ``pplan`` on ``remote``.

    ``workloads[i]`` is the legacy positional ``(args, kwargs)`` tuple for
    operator ``i``'s data plane — the args are bound to the operator's typed
    input signature in declaration order and handed to a one-shot
    :class:`repro_torch.engine.session.Session`, so the shim is ledger-exact with
    ``session.run(tasks)``.  All operators share ``remote``'s ledger stack;
    per-operator D/C are snapshot deltas.  When ``remote`` is a
    :class:`MemoryHierarchy` and the plan carries placements, each operator's
    spill writes target its planned tier.
    """
    _warn_deprecated("run_pipeline", "session.run(tasks)")
    from repro_torch.engine.session import Session

    if len(workloads) != len(pplan.ops):
        raise ValueError(
            f"got {len(workloads)} workloads for {len(pplan.ops)} operators"
        )
    session = Session(remote, budget=pplan.m_total, policy=pplan.policy)
    tasks = []
    for ob, (args, kwargs) in zip(pplan.ops, workloads):
        spec = get(ob.op)
        if len(args) != len(spec.inputs):
            raise ValueError(
                f"operator {ob.op!r} takes {len(spec.inputs)} data-plane "
                f"inputs {list(spec.inputs)}; got {len(args)} positional "
                f"values"
            )
        tasks.append(session.task(
            ob.op, ob.stats, inputs=dict(zip(spec.inputs, args)),
            **(kwargs or {}),
        ))
    res = session.run(tasks, plan=pplan)
    return PipelineRunResult(per_op=res.per_op, total=res.total)
