"""Query-level memory arbiter: split one page budget across a pipeline.

REMOP's §III policies optimize a *single* operator's buffers for a given
budget M.  A real spilling query runs several operators against one shared
budget, so the remaining degree of freedom is the split M = sum_i M_i.  The
arbiter minimizes the total modeled latency cost

    sum_i L_i(M_i)     s.t.  sum_i M_i = M,  M_i >= min_i

where each ``L_i`` is the operator's policy-aware closed-form cost
(``D + tau*C`` of the plan the policy would pick at budget ``M_i`` — the
``model`` hook on :class:`repro_torch.engine.registry.OperatorSpec`).  Each L_i is
(weakly) decreasing and near-convex in M_i, so a greedy marginal-cost descent
in page quanta is near-optimal; the even split is also evaluated and the
better of the two is returned, so the arbiter is never worse than splitting
the budget evenly.

This module is pure algorithm: it knows nothing about operators or tiers,
only items with a minimum and a latency function of their budget.  The
engine-facing wrapper is :func:`repro_torch.engine.pipeline.plan_pipeline`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ArbiterItem:
    """One pipeline member: a name, its floor, and its modeled cost L(m)."""

    name: str
    min_pages: float
    latency_of: Callable[[float], float]


def even_split(items: Sequence[ArbiterItem], budget: float) -> List[float]:
    """Budget/n each, with any item below its floor topped up from the rest."""
    _check_feasible(items, budget)
    n = len(items)
    alloc = [budget / n] * n
    # Top up floored items; shave the surplus pro rata from the unfloored.
    deficit = sum(max(it.min_pages - a, 0.0) for it, a in zip(items, alloc))
    if deficit > 0.0:
        surplus_idx = [i for i, it in enumerate(items) if alloc[i] > it.min_pages]
        headroom = sum(alloc[i] - items[i].min_pages for i in surplus_idx)
        for i, it in enumerate(items):
            if alloc[i] <= it.min_pages:
                alloc[i] = it.min_pages
            else:
                alloc[i] -= deficit * (alloc[i] - it.min_pages) / headroom
    return alloc


def greedy_split(
    items: Sequence[ArbiterItem], budget: float, step: float = 1.0
) -> List[float]:
    """Marginal-cost descent: repeatedly give one page quantum to the item
    whose modeled latency drops the most for it."""
    _check_feasible(items, budget)
    alloc = [it.min_pages for it in items]
    cur = [it.latency_of(a) for it, a in zip(items, alloc)]
    remaining = budget - sum(alloc)
    while remaining > 1e-9:
        s = min(step, remaining)
        best, best_gain, best_next = 0, -float("inf"), cur[0]
        for i, it in enumerate(items):
            nxt = it.latency_of(alloc[i] + s)
            gain = cur[i] - nxt
            if gain > best_gain:
                best, best_gain, best_next = i, gain, nxt
        alloc[best] += s
        cur[best] = best_next
        remaining -= s
    return alloc


def arbitrate(
    items: Sequence[ArbiterItem], budget: float, step: float = 1.0
) -> Tuple[List[float], float]:
    """Best of greedy marginal-cost descent and the (clamped) even split.

    Returns ``(allocations, total modeled latency)``; allocations sum to
    ``budget`` exactly and respect every item's floor.
    """
    candidates = [greedy_split(items, budget, step=step)]
    if len(items) > 1:
        candidates.append(even_split(items, budget))
    scored = [
        (sum(it.latency_of(a) for it, a in zip(items, alloc)), alloc)
        for alloc in candidates
    ]
    total, alloc = min(scored, key=lambda pair: pair[0])
    return alloc, total


def _check_feasible(items: Sequence[ArbiterItem], budget: float) -> None:
    if not items:
        raise ValueError("empty pipeline: nothing to arbitrate")
    floor = sum(it.min_pages for it in items)
    if budget < floor:
        raise ValueError(
            f"budget {budget} pages is below the pipeline floor {floor} "
            f"(minima: {[(it.name, it.min_pages) for it in items]})"
        )


# --------------------------------------------------------------------------
# Hierarchy-aware arbitration: jointly assign (pages, tier) per operator
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HierarchyItem:
    """One pipeline member on a memory hierarchy.

    ``latency_of(m, t)`` is the modeled cost of running with budget ``m``
    placed on tier index ``t`` (L = D + tau_t * C of the policy's plan);
    ``footprint_of(m, t)`` estimates the spill pages the item parks on tier
    ``t`` — tier-dependent because the executed plan is (the tier's tau
    picks e.g. the EMS fan-in, hence pass count) — which is what tier
    capacities constrain.

    The closure is also where operator pushdown enters arbitration: the
    engine folds the ship-vs-push delta ``min(L_push - L_ship, 0)`` for
    tier ``t`` into ``latency_of`` (see ``engine.pipeline._modeled_latency``),
    so a compute-capable tier with a slower wire can still win placement
    when executing the scan tier-side saves more volume than the extra tau
    costs.  The arbiter itself stays pure — pushdown is just another term
    in the per-(m, t) cost surface it descends.
    """

    name: str
    min_pages: float
    latency_of: Callable[[float, int], float]
    footprint_of: Callable[[float, int], float] = lambda m, t: 0.0


def _placement_feasible(
    items: Sequence[HierarchyItem],
    alloc: Sequence[float],
    placement: Sequence[int],
    capacities: Sequence[float],
) -> bool:
    used = [0.0] * len(capacities)
    for it, m, t in zip(items, alloc, placement):
        used[t] += it.footprint_of(m, t)
    return all(u <= c + 1e-9 for u, c in zip(used, capacities))


def _soft_split(
    pages: float, capacities: Sequence[float], start: int
) -> List[float]:
    """First-fit waterfall that dumps any residual on the bottom tier.

    The eviction-aware planner's split: unlike
    :func:`repro_torch.core.policies.tiered_split` it never raises — an evictor
    keeps the runtime write path unblocked, so planning prices impossible
    residuals at the bottom tier instead of failing.
    """
    placed = [0.0] * len(capacities)
    remaining = float(pages)
    for t in range(start, len(capacities)):
        free = capacities[t]
        take = remaining if math.isinf(free) else min(remaining, max(free, 0.0))
        placed[t] = take
        remaining -= take
        if remaining <= 0.0:
            break
    if remaining > 0.0:
        placed[-1] += remaining
    return placed


def _evictable_items(
    items: Sequence[HierarchyItem], capacities: Sequence[float]
) -> List[HierarchyItem]:
    """Wrap items with eviction-aware cost and footprint.

    With an evictor attached, a tier's capacity is *soft*: spill beyond it
    is demoted to lower tiers in background rounds rather than blocking, so

      * the modeled latency of placing an item on tier ``t`` blends the
        per-tier taus by the share of its footprint that actually stays on
        each tier (``_soft_split`` over free capacity), and
      * only the share resident on ``t`` counts against ``t``'s capacity.

    Each item is split against the free capacities independently (ignoring
    the other items' shares) — a deliberate planning approximation; the
    runtime evictor resolves the true interleaving.
    """
    caps = list(capacities)

    def wrap(it: HierarchyItem) -> HierarchyItem:
        def latency_of(m: float, t: int, it=it) -> float:
            fp = it.footprint_of(m, t)
            if fp <= 0.0:
                return it.latency_of(m, t)
            placed = _soft_split(fp, caps, t)
            return sum(
                share / fp * it.latency_of(m, u)
                for u, share in enumerate(placed)
                if share > 0.0
            )

        def footprint_of(m: float, t: int, it=it) -> float:
            fp = it.footprint_of(m, t)
            if fp <= 0.0:
                return fp
            return _soft_split(fp, caps, t)[t]

        return HierarchyItem(
            name=it.name, min_pages=it.min_pages,
            latency_of=latency_of, footprint_of=footprint_of,
        )

    return [wrap(it) for it in items]


def arbitrate_hierarchy(
    items: Sequence[HierarchyItem],
    budget: float,
    capacities: Sequence[float],
    step: float = 1.0,
    occupied: Sequence[float] | None = None,
    eviction: bool = False,
    pinned_tiers: Sequence[int | None] | None = None,
) -> Tuple[List[float], List[int], float]:
    """Split one page budget AND place each item on a hierarchy tier.

    Greedy marginal-cost descent over joint (grant a page quantum, choose a
    tier) moves, with capacity-feasible placements tracked by footprint; the
    best feasible *single-tier* placement (every item on one tier, pages
    split by :func:`arbitrate`) is also evaluated, so the result is never
    worse than the best single-tier placement.

    ``occupied`` gives per-tier pages already consumed — the *measured*
    residency of a partially-executed pipeline — so a mid-query
    re-arbitration places the remaining items into the capacity that is
    actually left, not the capacity the original plan assumed.

    ``eviction=True`` plans for a hierarchy with a background evictor
    attached: capacities become *soft* (an item may target a tier its
    footprint overflows — the evictor demotes the overflow in hidden
    migration rounds), the modeled cost of a placement blends per-tier taus
    by where the footprint actually comes to rest, and non-bottom
    ``occupied`` pages are treated as evictable cold data that sinks to the
    bottom tier instead of blocking placements.

    ``pinned_tiers`` (one entry per item, ``None`` = free) fixes an item's
    tier: the descent still grants it budget quanta but never moves it off
    its pinned tier — how per-task ``placement=`` pins flow through a
    frontier re-arbitration without losing the joint budget split.

    Returns ``(allocations, tier indices, total modeled latency)``;
    allocations sum to ``budget`` and respect every item's floor, and the
    placement fits every tier's remaining capacity.  When no candidate
    satisfies both (every tier finite and footprint-full), raises
    ``ValueError`` instead of returning an assignment the runtime hierarchy
    could not honor.
    """
    if not items:
        raise ValueError("empty pipeline: nothing to arbitrate")
    floor = sum(it.min_pages for it in items)
    if budget < floor:
        raise ValueError(
            f"budget {budget} pages is below the pipeline floor {floor} "
            f"(minima: {[(it.name, it.min_pages) for it in items]})"
        )
    n_tiers = len(capacities)
    if n_tiers == 0:
        raise ValueError("empty hierarchy: nothing to place on")
    if occupied is not None:
        if len(occupied) != n_tiers:
            raise ValueError(
                f"occupied has {len(occupied)} tiers, capacities {n_tiers}"
            )
        if eviction and n_tiers > 1:
            # Cold residency above the backstop is evictable: it sinks to
            # the bottom tier rather than blocking fast-tier placements.
            occupied = [0.0] * (n_tiers - 1) + [
                occupied[-1] + sum(occupied[:-1])
            ]
        capacities = [
            c if math.isinf(c) else max(c - o, 0.0)
            for c, o in zip(capacities, occupied)
        ]
    if eviction:
        items = _evictable_items(items, capacities)
    if pinned_tiers is not None:
        if len(pinned_tiers) != len(items):
            raise ValueError(
                f"{len(pinned_tiers)} pinned tiers for {len(items)} items"
            )
        for it, pt in zip(items, pinned_tiers):
            if pt is not None and not 0 <= pt < n_tiers:
                raise ValueError(
                    f"item {it.name!r} pinned to tier {pt}, hierarchy has "
                    f"{n_tiers} tiers"
                )
    else:
        pinned_tiers = [None] * len(items)

    candidates: List[Tuple[List[float], List[int]]] = [
        _greedy_joint(items, budget, capacities, step, pinned_tiers)
    ]
    # Single-tier baselines: all (unpinned) items on tier t, pages split by
    # the 1-D arbiter.  Guarantees "never worse than best single tier".
    for t in range(n_tiers):
        tiers = [t if pt is None else pt for pt in pinned_tiers]
        flat = [
            ArbiterItem(it.name, it.min_pages,
                        lambda m, it=it, ti=ti: it.latency_of(m, ti))
            for it, ti in zip(items, tiers)
        ]
        alloc, _ = arbitrate(flat, budget, step=step)
        candidates.append((alloc, tiers))

    # Only capacity-feasible, fully-allocated assignments may win: the
    # greedy pass can stop early (capacity exhausted) or fall back to an
    # over-full tier, and a single-tier baseline can overflow its tier.
    candidates = [
        (a, p) for a, p in candidates
        if _placement_feasible(items, a, p, capacities)
        and abs(sum(a) - budget) <= 1e-6
    ]
    if not candidates:
        raise ValueError(
            f"no capacity-feasible (pages, tier) assignment: capacities "
            f"{list(capacities)} cannot hold the pipeline's spill footprints "
            f"at budget {budget} (give the bottom tier math.inf capacity for "
            f"an unbounded backstop)"
        )

    def total_of(alloc: Sequence[float], placement: Sequence[int]) -> float:
        return sum(
            it.latency_of(m, t) for it, m, t in zip(items, alloc, placement)
        )

    scored = [(total_of(a, p), a, p) for a, p in candidates]
    total, alloc, placement = min(scored, key=lambda triple: triple[0])
    return list(alloc), list(placement), total


def _greedy_joint(
    items: Sequence[HierarchyItem],
    budget: float,
    capacities: Sequence[float],
    step: float,
    pinned_tiers: Sequence[int | None] | None = None,
) -> Tuple[List[float], List[int]]:
    """Greedy descent over joint (item gets a quantum, on some tier) moves."""
    n_tiers = len(capacities)
    if pinned_tiers is None:
        pinned_tiers = [None] * len(items)
    alloc = [it.min_pages for it in items]
    used = [0.0] * n_tiers
    placement: List[int] = []

    def tiers_of(i: int) -> range | Tuple[int]:
        pt = pinned_tiers[i]
        return range(n_tiers) if pt is None else (pt,)

    def fits(i: int, m: float, t: int) -> bool:
        fp = items[i].footprint_of(m, t)
        cur = used[t]
        if placement[i] == t:
            cur -= items[i].footprint_of(alloc[i], t)
        return cur + fp <= capacities[t] + 1e-9

    # Initial placement at the floors: cheapest feasible tier per item.
    for i, it in enumerate(items):
        best_t, best_l = None, float("inf")
        for t in tiers_of(i):
            if used[t] + it.footprint_of(alloc[i], t) > capacities[t] + 1e-9:
                continue
            latency = it.latency_of(alloc[i], t)
            if latency < best_l:
                best_t, best_l = t, latency
        if best_t is None:  # nothing fits: fall back to the roomiest tier
            # (the resulting assignment is filtered out as infeasible by
            # arbitrate_hierarchy unless a later move repairs it)
            best_t = (pinned_tiers[i] if pinned_tiers[i] is not None else max(
                range(n_tiers), key=lambda t: capacities[t] - used[t]))
        placement.append(best_t)
        used[best_t] += it.footprint_of(alloc[i], best_t)

    cur = [it.latency_of(a, t) for it, a, t in zip(items, alloc, placement)]
    remaining = budget - sum(alloc)
    while remaining > 1e-9:
        s = min(step, remaining)
        best = None  # (gain, i, t, next_latency)
        for i, it in enumerate(items):
            for t in tiers_of(i):
                if not fits(i, alloc[i] + s, t):
                    continue
                nxt = it.latency_of(alloc[i] + s, t)
                gain = cur[i] - nxt
                if best is None or gain > best[0]:
                    best = (gain, i, t, nxt)
        if best is None:  # no capacity-feasible grant anywhere: stop early
            break
        _, i, t, nxt = best
        used[placement[i]] -= items[i].footprint_of(alloc[i], placement[i])
        alloc[i] += s
        placement[i] = t
        used[t] += items[i].footprint_of(alloc[i], t)
        cur[i] = nxt
        remaining -= s

    # Final reassignment sweep: move items to cheaper tiers while it helps.
    improved = True
    while improved:
        improved = False
        for i, it in enumerate(items):
            for t in tiers_of(i):
                if t == placement[i] or not fits(i, alloc[i], t):
                    continue
                nxt = it.latency_of(alloc[i], t)
                if nxt < cur[i] - 1e-12:
                    used[placement[i]] -= it.footprint_of(alloc[i], placement[i])
                    placement[i] = t
                    used[t] += it.footprint_of(alloc[i], t)
                    cur[i] = nxt
                    improved = True
    return alloc, placement
