"""Operator/plan registry: one entry point for planning every spill operator.

Benchmarks, examples, and future query layers plan through

    plan_operator("bnlj" | "ems" | "ehj", stats, tier, m_pages, policy=...)

instead of importing per-operator constructors.  Each registered
:class:`OperatorSpec` bundles the plan type, the available buffer policies
(REMOP optimum plus the paper's baselines), the data-plane runner, and the
correctness oracle, so adding an operator (external aggregation, a new tier
stack) is one ``register()`` call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (
    Any,
    Callable,
    Dict,
    Mapping,
    Optional,
    Protocol,
    Tuple,
    Union,
    runtime_checkable,
)

from repro_torch.core.cost_model import (
    HierarchySpec,
    TierLevel,
    TierSpec,
    hierarchy_spec,
    resolve_tier_name,
)
from repro_torch.core.policies import (
    BNLJPlan,
    PushdownChoice,
    pushdown_or_ship,
    EAggPlan,
    EHJPlan,
    EMSPlan,
    bnlj_conventional,
    bnlj_costs,
    bnlj_plan,
    eagg_data_costs,
    eagg_plan,
    eagg_round_costs,
    eagg_starved,
    ehj_data_costs,
    ehj_plan,
    ehj_round_costs,
    ehj_starved,
    ems_conventional,
    ems_duckdb,
    ems_passes,
    ems_plan,
    ems_total_costs,
)


@runtime_checkable
class OperatorPlan(Protocol):
    """A buffer plan for one spill operator; ``op`` names its registry entry."""

    op: str


@dataclasses.dataclass(frozen=True)
class WorkloadStats:
    """Operator-independent workload description; all sizes in pages.

    ``size_r`` is the primary input (BNLJ outer, EMS sort input, EHJ build),
    ``size_s`` the secondary (inner / probe), ``out`` the output estimate.
    ``selectivity`` is the BNLJ join selectivity ``f`` (beta = f*M);
    ``partitions``/``sigma`` are the EHJ radix count and spilled fraction;
    ``k_cap`` optionally caps the EMS merge fan-in.  ``pushdown_sel`` is the
    estimated surviving fraction of a probe-side *filter* annotation on the
    secondary input (BNLJ inner) — ``None`` means no filter; a set value
    makes the filter physical and lets the arbiter price executing it at a
    compute-capable tier (``OperatorSpec.pushdown``).
    """

    size_r: float = 0.0
    size_s: float = 0.0
    out: float = 0.0
    selectivity: float = 0.0
    partitions: int = 16
    sigma: float = 0.5
    k_cap: Optional[int] = None
    pushdown_sel: Optional[float] = None


Planner = Callable[[WorkloadStats, float, float, str], OperatorPlan]
# Modeled latency cost L(stats, tau, m_pages, policy) — the arbiter's
# marginal-cost hook (repro_torch.core.arbiter consumes L as a function of m).
LatencyModel = Callable[[WorkloadStats, float, float, str], float]
# Modeled (D, C) of the policy's plan at budget m — the structured form the
# session ``explain()`` report decomposes L = D + tau*C from.
CostModel = Callable[[WorkloadStats, float, float, str], Tuple[float, float]]
# Estimated remote spill footprint F(stats, tau, m_pages) in pages — what a
# tier's capacity constrains when the hierarchy arbiter places an operator.
# tau matters because the plan itself is tau-dependent (e.g. the EMS merge
# fan-in, hence pass count, changes with the placement tier).
Footprint = Callable[[WorkloadStats, float, float], float]
# Measured-feedback hook: (estimated stats, run result) -> stats with the
# *measured* output cardinality, for mid-pipeline re-planning.
MeasuredStats = Callable[[WorkloadStats, Any], WorkloadStats]
# Output-stats hook: estimated output size (pages) of the operator at plan
# time — the planning-time analogue of ``MeasuredStats``.  A query frontend
# uses it to feed one task's estimated output into the downstream task's
# input stats (``input_stats``) before anything has run.
OutputPages = Callable[[WorkloadStats], float]
# Per-stream footprint decomposition: the same pages ``Footprint`` reports,
# attributed to the operator's named spill streams (``OperatorSpec.streams``)
# — what fractional placement splits across tiers and ``explain()`` renders.
StreamFootprints = Callable[[WorkloadStats, float, float], Dict[str, float]]
# Ship-pages vs. ship-compute arbitration hook: given the workload, the
# placement tier's full TierLevel (capabilities included), the budget m, and
# the policy, return the priced PushdownChoice — or None when the operator
# has nothing to push (no filter annotation, no spilled partitions).  The
# choice's l_delta (<= 0) is added to the operator's modeled L during
# arbitration, so a slower-tau tier with compute can win placement.
Pushdown = Callable[
    [WorkloadStats, TierLevel, float, str], Optional[PushdownChoice]
]
# Data-plane kwargs realizing a PushdownChoice (e.g. BNLJ's
# ``inner_filter``/``pushdown``); applied with setdefault so explicit task
# options always win.
PushdownKwargs = Callable[[WorkloadStats, PushdownChoice], Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Everything the engine knows about one spill operator."""

    name: str
    plan_type: type
    policies: Tuple[str, ...]  # first entry is the default ("remop")
    planner: Planner
    run: Callable[..., Any]  # data-plane executor over a RemoteMemory/hierarchy
    oracle: Callable[..., Any]  # accounting-free correctness reference
    model: Optional[LatencyModel] = None  # modeled L for pipeline arbitration
    min_pages: float = 3.0  # smallest plannable budget (pages)
    footprint: Optional[Footprint] = None  # spill pages parked on the tier
    costs: Optional[CostModel] = None  # modeled (D, C) behind ``model``
    # Typed input signature (session API): ordered names of the data-plane
    # inputs ``run`` takes positionally, and the WorkloadStats field each one
    # sizes (so a re-planner can refresh an estimate from a measured input).
    inputs: Tuple[str, ...] = ()
    input_stats: Mapping[str, str] = dataclasses.field(default_factory=dict)
    measured_stats: Optional[MeasuredStats] = None  # replan feedback hook
    output_of: Optional[Callable[[Any], Any]] = None  # run result -> output pages
    # Estimated output pages at plan time (feeds downstream input stats).
    output_pages: Optional[OutputPages] = None
    # Named spill streams, in the order the data plane's ``tier=`` mapping
    # (and ``session.task(..., placement=[...])`` lists) bind to; empty for
    # operators without per-stream routing.
    streams: Tuple[str, ...] = ()
    # ``footprint`` decomposed per stream (keys ⊆ ``streams``).
    stream_footprints: Optional[StreamFootprints] = None
    # Ship-vs-push arbitration hook and the data-plane kwargs realizing its
    # verdict; None for operators with nothing to execute at the tier.
    pushdown: Optional[Pushdown] = None
    pushdown_kwargs: Optional[PushdownKwargs] = None

    def bind_inputs(self, inputs: Mapping[str, Any]) -> Tuple[Any, ...]:
        """Resolve named inputs to ``run``'s positional argument order.

        Raises ``ValueError`` naming the expected signature when an input is
        missing or unknown — the typed replacement for the legacy positional
        ``(args, kwargs)`` workload tuples.
        """
        unknown = sorted(set(inputs) - set(self.inputs))
        missing = [name for name in self.inputs if name not in inputs]
        if unknown or missing:
            problems = []
            if missing:
                problems.append(f"missing {missing}")
            if unknown:
                problems.append(f"unknown {unknown}")
            raise ValueError(
                f"operator {self.name!r} takes inputs {list(self.inputs)}: "
                + ", ".join(problems)
            )
        return tuple(inputs[name] for name in self.inputs)


_REGISTRY: Dict[str, OperatorSpec] = {}
_builtin_registered = False


def register(spec: OperatorSpec) -> OperatorSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"operator {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> OperatorSpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown operator {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def resolve_tier(tier: Union[TierSpec, str]) -> TierSpec:
    """Accept a TierSpec or a tier name from Table I / TESTBED."""
    return resolve_tier_name(tier)


def resolve_hierarchy(hierarchy: Any) -> HierarchySpec:
    """Normalize a hierarchy argument to a :class:`HierarchySpec`.

    Accepts a spec, a live :class:`repro_torch.remote.simulator.MemoryHierarchy`,
    or a sequence of levels where each level is a tier (TierSpec or name from
    the known tables) or a ``(tier, capacity_pages)`` pair — e.g.
    ``[("dram", 64), ("rdma", 256), "ssd"]``.
    """
    if isinstance(hierarchy, HierarchySpec):
        return hierarchy
    if getattr(hierarchy, "is_hierarchy", False):
        return hierarchy.spec
    return hierarchy_spec(*hierarchy)


def plan_operator(
    op: str,
    stats: WorkloadStats,
    tier: Union[TierSpec, str],
    m_pages: float,
    policy: str = "remop",
) -> OperatorPlan:
    """Plan ``op``'s buffers for a workload on a tier under one policy.

    ``m_pages`` is the operator's local budget M (the EHJ I/O pool M_B); tau
    comes from the tier's ``tau_pages``.  ``policy`` selects the REMOP optimum
    or one of the paper's baselines (see ``get(op).policies``).
    """
    spec = get(op)
    if policy not in spec.policies:
        raise ValueError(
            f"operator {op!r} has no policy {policy!r}; available: {spec.policies}"
        )
    if m_pages < spec.min_pages:
        raise ValueError(
            f"operator {op!r} needs m_pages >= {spec.min_pages} "
            f"(one page per buffer pool at minimum), got {m_pages}"
        )
    return spec.planner(stats, resolve_tier(tier).tau_pages, float(m_pages), policy)


def model_latency(
    op: str,
    stats: WorkloadStats,
    tier: Union[TierSpec, str],
    m_pages: float,
    policy: str = "remop",
) -> float:
    """Modeled latency cost L = D + tau*C for ``op`` planned with ``m_pages``.

    This is the objective the query-level memory arbiter minimizes when it
    splits one global budget across a pipeline (see ``engine.pipeline``).
    """
    spec = get(op)
    if spec.model is None:
        raise ValueError(f"operator {op!r} has no latency model")
    return spec.model(stats, resolve_tier(tier).tau_pages, float(m_pages), policy)


def model_costs(
    op: str,
    stats: WorkloadStats,
    tier: Union[TierSpec, str],
    m_pages: float,
    policy: str = "remop",
) -> Tuple[float, float]:
    """Modeled (D, C) for ``op`` planned with ``m_pages`` on ``tier``.

    The structured decomposition behind :func:`model_latency`
    (L = D + tau*C) — what ``Session.explain`` reports per operator.
    """
    spec = get(op)
    if spec.costs is None:
        raise ValueError(f"operator {op!r} has no cost model")
    return spec.costs(stats, resolve_tier(tier).tau_pages, float(m_pages), policy)


# --------------------------------------------------------------------------
# Built-in operators
# --------------------------------------------------------------------------


def _plan_bnlj(stats: WorkloadStats, tau: float, m: float, policy: str) -> BNLJPlan:
    if policy == "conventional":
        return bnlj_conventional(m)
    return bnlj_plan(m, tau, selectivity=stats.selectivity)


def _plan_ems(stats: WorkloadStats, tau: float, m: float, policy: str) -> EMSPlan:
    if policy == "conventional":
        return ems_conventional(m)
    if policy == "duckdb":
        return ems_duckdb(m)
    return ems_plan(stats.size_r, m, tau, k_cap=stats.k_cap)


def _plan_ehj(stats: WorkloadStats, tau: float, m: float, policy: str) -> EHJPlan:
    if policy == "conventional":
        return ehj_starved(m, stats.partitions, stats.sigma)
    return ehj_plan(
        stats.size_r, stats.size_s, stats.out, m, stats.partitions, stats.sigma
    )


def _plan_eagg(stats: WorkloadStats, tau: float, m: float, policy: str) -> EAggPlan:
    if policy == "conventional":
        return eagg_starved(m, stats.partitions, stats.sigma)
    return eagg_plan(stats.size_r, stats.out, m, stats.partitions, stats.sigma)


# Cost models: closed-form (D, C) of the policy's plan at budget m; the
# latency models below collapse them to L = D + tau*C.  Each L is (weakly)
# decreasing in m, which is what the arbiter's greedy marginal-cost descent
# assumes; the (D, C) split is what ``Session.explain`` reports per operator.


def _costs_bnlj(
    stats: WorkloadStats, tau: float, m: float, policy: str
) -> Tuple[float, float]:
    plan = _plan_bnlj(stats, tau, m, policy)
    return bnlj_costs(stats.size_r, stats.size_s, stats.out, plan)


def _costs_ems(
    stats: WorkloadStats, tau: float, m: float, policy: str
) -> Tuple[float, float]:
    # Run formation + merge passes, one shared closed form (core.policies).
    plan = _plan_ems(stats, tau, m, policy)
    return ems_total_costs(stats.size_r, m, plan)


def _costs_ehj(
    stats: WorkloadStats, tau: float, m: float, policy: str
) -> Tuple[float, float]:
    plan = _plan_ehj(stats, tau, m, policy)
    d = sum(ehj_data_costs(stats.size_r, stats.size_s, stats.out, plan.sigma))
    c = sum(ehj_round_costs(stats.size_r, stats.size_s, stats.out, plan))
    return d, c


def _costs_eagg(
    stats: WorkloadStats, tau: float, m: float, policy: str
) -> Tuple[float, float]:
    plan = _plan_eagg(stats, tau, m, policy)
    d = sum(eagg_data_costs(stats.size_r, stats.out, plan.sigma))
    c = sum(eagg_round_costs(stats.size_r, stats.out, plan))
    return d, c


def _model_from(costs: CostModel) -> LatencyModel:
    def model(stats: WorkloadStats, tau: float, m: float, policy: str) -> float:
        d, c = costs(stats, tau, m, policy)
        return d + tau * c

    return model


_model_bnlj = _model_from(_costs_bnlj)
_model_ems = _model_from(_costs_ems)
_model_ehj = _model_from(_costs_ehj)
_model_eagg = _model_from(_costs_eagg)


# Spill footprints: pages an operator parks on its placement tier over a run
# (nothing is freed mid-operator, so this is also the peak residency the
# hierarchy arbiter must fit under the tier's capacity).  Evaluated at the
# placement tier's tau, because the plan the operator executes is itself
# tau-dependent.


def _fp_bnlj(stats: WorkloadStats, tau: float, m: float) -> float:
    # Only the join output is written back.
    return stats.out


def _fp_ems(stats: WorkloadStats, tau: float, m: float) -> float:
    # Run formation writes N pages of runs; every merge pass writes N more,
    # with the pass count set by the fan-in this tier's tau selects.
    plan = _plan_ems(stats, tau, m, "remop")
    return stats.size_r * (1.0 + ems_passes(stats.size_r, m, plan.k))


def _fp_ehj(stats: WorkloadStats, tau: float, m: float) -> float:
    # Spilled build + probe partitions, plus the join output.
    return stats.sigma * (stats.size_r + stats.size_s) + stats.out


def _fp_eagg(stats: WorkloadStats, tau: float, m: float) -> float:
    # Spilled raw partitions, plus the group output.
    return stats.sigma * stats.size_r + stats.out


# Per-stream decompositions of the footprints above (same totals).  The
# stream names match the ``tier=`` mapping each operator's data plane takes,
# so fractional placement can route e.g. EHJ build partitions to DRAM while
# the staged probe spills to SSD.


def _sfp_bnlj(stats: WorkloadStats, tau: float, m: float) -> Dict[str, float]:
    return {"output": stats.out}


def _sfp_ems(stats: WorkloadStats, tau: float, m: float) -> Dict[str, float]:
    plan = _plan_ems(stats, tau, m, "remop")
    passes = ems_passes(stats.size_r, m, plan.k)
    return {"runs": stats.size_r * passes, "output": stats.size_r}


def _sfp_ehj(stats: WorkloadStats, tau: float, m: float) -> Dict[str, float]:
    return {
        "build": stats.sigma * stats.size_r,
        "stage": stats.sigma * stats.size_s,
        "output": stats.out,
    }


def _sfp_eagg(stats: WorkloadStats, tau: float, m: float) -> Dict[str, float]:
    return {"partitions": stats.sigma * stats.size_r, "output": stats.out}


# Ship-pages vs. ship-compute hooks: price the operator's pushable stream at
# the candidate placement tier with the closed forms (core.policies) and
# return the verdict.  The l_delta (<= 0) folds into the arbiter's modeled L.


def _scale_choice(ch: PushdownChoice, k: int) -> PushdownChoice:
    """Scale a per-pass/per-partition verdict to ``k`` repetitions."""
    if k == 1:
        return ch
    return dataclasses.replace(
        ch, l_ship=ch.l_ship * k, l_push=ch.l_push * k,
        d_saved=ch.d_saved * k, c_pushdown=ch.c_pushdown * k,
        scanned=ch.scanned * k,
    )


def _pushdown_bnlj(
    stats: WorkloadStats, level: TierLevel, m: float, policy: str
) -> Optional[PushdownChoice]:
    # The probe-side filter annotation: every outer pass re-reads the inner
    # stream in p_s-page rounds; the per-pass verdict scales by the pass
    # count (the decision itself is pass-invariant).
    if stats.pushdown_sel is None:
        return None
    plan = _plan_bnlj(stats, level.tier.tau_pages, m, policy)
    p_r = max(1, int(round(plan.outer_pages)))
    p_s = max(1, int(round(plan.inner_pages)))
    n = max(int(round(stats.size_s)), 0)
    passes = max(math.ceil(stats.size_r / p_r), 1)
    ch = pushdown_or_ship(
        n, stats.pushdown_sel, level, level.tier.tau_pages, batch_pages=p_s
    )
    return _scale_choice(ch, passes)


def _pushdown_eagg(
    stats: WorkloadStats, level: TierLevel, m: float, policy: str
) -> Optional[PushdownChoice]:
    # P2 re-reads each spilled partition (~size_r/P raw pages); a pushed
    # partial aggregation ships ~out/P group pages in one round instead.
    plan = _plan_eagg(stats, level.tier.tau_pages, m, policy)
    n_spilled = int(round(plan.sigma * plan.partitions))
    if n_spilled <= 0:
        return None
    n_q = max(int(round(stats.size_r / plan.partitions)), 0)
    if n_q <= 0:
        return None
    out_q = stats.out / plan.partitions
    r_r2 = max(int(round(plan.p2[0])), 1) if plan.p2 else 1
    ch = pushdown_or_ship(
        n_q, 1.0, level, level.tier.tau_pages, batch_pages=r_r2,
        op="reduce", out_pages=out_q,
    )
    return _scale_choice(ch, n_spilled)


def _pdkw_bnlj(stats: WorkloadStats, ch: PushdownChoice) -> Dict[str, Any]:
    return {"inner_filter": stats.pushdown_sel, "pushdown": ch.push}


def _pdkw_eagg(stats: WorkloadStats, ch: PushdownChoice) -> Dict[str, Any]:
    return {"pushdown": ch.push}


# Estimated output pages at plan time: what the operator's result stream is
# expected to occupy, per its WorkloadStats — the planning-time mirror of the
# ``measured_stats`` feedback hooks above.


def _out_pages_from_out(stats: WorkloadStats) -> float:
    return stats.out


def _out_pages_ems(stats: WorkloadStats) -> float:
    # A sort permutes its input: the final run is the input's size.
    return stats.size_r


def _ensure_builtin() -> None:
    """Register the built-in operators on first lookup.

    Deferred (rather than at import) because the operator modules themselves
    import the engine's buffers/scheduler — eager registration would re-enter
    a partially-imported module.
    """
    global _builtin_registered
    if _builtin_registered:
        return

    # The flag is only set once registration succeeds, so a failed deferred
    # import resurfaces as the real ImportError on the next lookup instead of
    # a misleading "unknown operator" KeyError.
    # importlib lookups: the ``repro_torch.remote`` package re-exports the runner
    # *functions* under the same names as the submodules, so plain
    # ``import repro_torch.remote.bnlj as m`` would bind the function instead.
    import importlib

    bnlj_mod = importlib.import_module("repro_torch.remote.bnlj")
    eagg_mod = importlib.import_module("repro_torch.remote.eagg")
    ehj_mod = importlib.import_module("repro_torch.remote.ehj")
    ems_mod = importlib.import_module("repro_torch.remote.ems")

    register(OperatorSpec(
        name="bnlj", plan_type=BNLJPlan,
        policies=("remop", "conventional"),
        planner=_plan_bnlj, run=bnlj_mod.bnlj, oracle=bnlj_mod.bnlj_oracle,
        model=_model_bnlj, footprint=_fp_bnlj, costs=_costs_bnlj,
        inputs=bnlj_mod.INPUTS, input_stats=bnlj_mod.INPUT_STATS,
        measured_stats=bnlj_mod.bnlj_measured, output_of=bnlj_mod.bnlj_output,
        output_pages=_out_pages_from_out,
        streams=bnlj_mod.STREAMS, stream_footprints=_sfp_bnlj,
        pushdown=_pushdown_bnlj, pushdown_kwargs=_pdkw_bnlj,
    ))
    register(OperatorSpec(
        name="ems", plan_type=EMSPlan,
        policies=("remop", "conventional", "duckdb"),
        planner=_plan_ems, run=ems_mod.ems_sort, oracle=ems_mod.ems_oracle,
        model=_model_ems, footprint=_fp_ems, costs=_costs_ems,
        inputs=ems_mod.INPUTS, input_stats=ems_mod.INPUT_STATS,
        measured_stats=ems_mod.ems_measured, output_of=ems_mod.ems_output,
        output_pages=_out_pages_ems,
        streams=ems_mod.STREAMS, stream_footprints=_sfp_ems,
    ))
    register(OperatorSpec(
        name="ehj", plan_type=EHJPlan,
        policies=("remop", "conventional"),
        planner=_plan_ehj, run=ehj_mod.ehj, oracle=ehj_mod.ehj_oracle,
        model=_model_ehj, footprint=_fp_ehj, costs=_costs_ehj,
        inputs=ehj_mod.INPUTS, input_stats=ehj_mod.INPUT_STATS,
        measured_stats=ehj_mod.ehj_measured, output_of=ehj_mod.ehj_output,
        output_pages=_out_pages_from_out,
        streams=ehj_mod.STREAMS, stream_footprints=_sfp_ehj,
    ))
    register(OperatorSpec(
        name="eagg", plan_type=EAggPlan,
        policies=("remop", "conventional"),
        planner=_plan_eagg, run=eagg_mod.eagg, oracle=eagg_mod.eagg_oracle,
        model=_model_eagg, footprint=_fp_eagg, costs=_costs_eagg,
        inputs=eagg_mod.INPUTS, input_stats=eagg_mod.INPUT_STATS,
        measured_stats=eagg_mod.eagg_measured, output_of=eagg_mod.eagg_output,
        output_pages=_out_pages_from_out,
        streams=eagg_mod.STREAMS, stream_footprints=_sfp_eagg,
        pushdown=_pushdown_eagg, pushdown_kwargs=_pdkw_eagg,
    ))
    _builtin_registered = True
