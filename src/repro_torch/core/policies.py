"""REMOP operator buffer-allocation policies (paper §III).

Each operator family gets:
  * closed-form / numerical cost functions ``D(params)``, ``C(params)`` and the
    latency objective ``L = D + tau * C``;
  * the paper's optimal policy (Properties 4, 5, 6; Tables III, IV, VI);
  * the conventional / DuckDB baselines it is compared against (Table VII).

All sizes are in *pages* unless noted.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import ClassVar, List, Sequence, Tuple

# ==========================================================================
# Generic allocator (Property 6 machinery)
# ==========================================================================


def waterfill(coeffs: Sequence[float], budget: float) -> Tuple[List[float], float]:
    """Minimize sum_j a_j / R_j subject to sum_j R_j = budget.

    By Cauchy-Schwarz the optimum is R_j proportional to sqrt(a_j) with minimum
    value (sum_j sqrt(a_j))^2 / budget (paper Property 6).

    Returns:
      (allocation list, minimal round cost C*).
    """
    roots = [math.sqrt(max(a, 0.0)) for a in coeffs]
    total = sum(roots)
    if total == 0.0 or budget <= 0.0:
        return [budget / max(len(coeffs), 1)] * len(coeffs), 0.0
    alloc = [budget * r / total for r in roots]
    c_star = total * total / budget
    return alloc, c_star


def round_cost(coeffs: Sequence[float], alloc: Sequence[float]) -> float:
    """Evaluate sum_j a_j / R_j for a concrete allocation."""
    c = 0.0
    for a, r in zip(coeffs, alloc):
        if a == 0.0:
            continue
        if r <= 0.0:
            return math.inf
        c += a / r
    return c


def _golden_min(f, lo: float, hi: float, iters: int = 200) -> float:
    """Golden-section minimizer for a unimodal objective on [lo, hi]."""
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
        if abs(b - a) < 1e-12:
            break
    return (a + b) / 2.0


# ==========================================================================
# Blocked nested-loop join (§III-A)
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class BNLJPlan:
    op: ClassVar[str] = "bnlj"  # engine.registry.OperatorPlan tag
    m: float  # total budget (pages)
    r_in: float  # input-region fraction
    p_r: float  # outer fraction of the input region
    # Derived absolute sizes.
    @property
    def input_pages(self) -> float:
        return self.r_in * self.m

    @property
    def output_pages(self) -> float:
        return self.m - self.input_pages

    @property
    def outer_pages(self) -> float:
        return self.p_r * self.input_pages

    @property
    def inner_pages(self) -> float:
        return (1.0 - self.p_r) * self.input_pages


def bnlj_costs_exact(
    size_r: int, size_s: int, out: float, p_r_pages: int, p_s_pages: int, r_out_pages: int
) -> Tuple[float, float]:
    """Exact (ceil-based) D and C for BNLJ — matches the §II-C worked example.

    D_read = ceil(|R|/P_R)*|S| + |R|;  C_read = ceil(|R|/P_R)*ceil(|S|/P_S)
    + ceil(|R|/P_R); writes add O pages in ceil(O/R_out) rounds.
    """
    blocks_r = math.ceil(size_r / p_r_pages)
    blocks_s = math.ceil(size_s / p_s_pages)
    d = blocks_r * size_s + size_r + out
    c = blocks_r * blocks_s + blocks_r + (math.ceil(out / r_out_pages) if out else 0)
    return float(d), float(c)


def bnlj_costs(
    size_r: float, size_s: float, out: float, plan: BNLJPlan
) -> Tuple[float, float]:
    """Smooth approximations of D and C used by the optimizer (§III-A b)."""
    p_r_pages = max(plan.outer_pages, 1e-9)
    p_s_pages = max(plan.inner_pages, 1e-9)
    r_out = max(plan.output_pages, 1e-9)
    d = size_r + size_r * size_s / p_r_pages + out
    c = size_r * size_s / (p_r_pages * p_s_pages) + size_r / p_r_pages + out / r_out
    return d, c


def bnlj_latency(size_r, size_s, out, plan: BNLJPlan, tau: float) -> float:
    d, c = bnlj_costs(size_r, size_s, out, plan)
    return d + tau * c


def bnlj_split_opt(r_in_pages: float, tau: float) -> float:
    """Property 4: p_R*/p_S* = sqrt(1 + R_in/tau), with p_R* + p_S* = 1."""
    if tau <= 0.0:
        return 1.0  # volume-dominated limit: outer-heavy
    ratio = math.sqrt(1.0 + r_in_pages / tau)
    return ratio / (1.0 + ratio)


def bnlj_rin_objective(r_in: float, a: float, b: float) -> float:
    """Objective g(r_in) from §III-A(d), parameterized by alpha=M/tau, beta=fM.

    g = 1/(p_R* r_in) + 1/(alpha r_in^2 p_R*(1-p_R*)) + beta/(alpha (1-r_in)),
    with p_R* from Property 4 evaluated at R_in/tau = r_in * alpha.
    """
    if not (0.0 < r_in < 1.0):
        return math.inf
    p_r = _p_r_of(r_in, a)
    return (
        1.0 / (p_r * r_in)
        + 1.0 / (a * r_in * r_in * p_r * (1.0 - p_r))
        + b / (a * (1.0 - r_in))
    )


def _p_r_of(r_in: float, a: float) -> float:
    # R_in / tau = r_in * M / tau = r_in * alpha.
    ratio = math.sqrt(1.0 + r_in * a)
    return ratio / (1.0 + ratio)


def bnlj_rin_opt(a: float, b: float) -> float:
    """Optimal input fraction r_in*(alpha, beta) — reproduces Table III."""
    return _golden_min(lambda r: bnlj_rin_objective(r, a, b), 1e-6, 1.0 - 1e-6)


def bnlj_plan(
    m: float, tau: float, selectivity: float = 0.0
) -> BNLJPlan:
    """Full REMOP BNLJ policy: r_in from Table III, p_R from Property 4."""
    if tau <= 0.0:
        # Volume-dominated: conventional outer-heavy allocation.
        return bnlj_conventional(m)
    a = m / tau
    b = selectivity * m
    r_in = bnlj_rin_opt(a, b)
    p_r = bnlj_split_opt(r_in * m, tau)
    return BNLJPlan(m=m, r_in=r_in, p_r=p_r)


def bnlj_conventional(m: float) -> BNLJPlan:
    """Disk-oriented default: P_R = M-2, P_S = 1, R_out = 1 (§III-A e)."""
    r_in = (m - 1.0) / m
    p_r = (m - 2.0) / (m - 1.0)
    return BNLJPlan(m=m, r_in=r_in, p_r=p_r)


# ==========================================================================
# k-way external merge sort (§III-B)
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class EMSPlan:
    op: ClassVar[str] = "ems"  # engine.registry.OperatorPlan tag
    m: float
    k: int
    r_in: float

    @property
    def input_pages(self) -> float:
        return self.r_in * self.m

    @property
    def output_pages(self) -> float:
        return self.m - self.input_pages

    @property
    def per_run_pages(self) -> float:
        return self.input_pages / self.k


def ems_split_opt(k: int) -> float:
    """Property 5: R_in : R_out = sqrt(k) : 1  =>  r_in = sqrt(k)/(sqrt(k)+1)."""
    s = math.sqrt(k)
    return s / (s + 1.0)


def ems_passes(n: float, m: float, k: int) -> int:
    runs = math.ceil(n / m)
    if runs <= 1:
        return 0
    return max(1, math.ceil(math.log(runs) / math.log(k)))


def ems_costs(n: float, m: float, plan: EMSPlan) -> Tuple[float, float, int]:
    """(D, C, passes) for the merge phase (§III-B b).

    Per pass: D = 2N; C = k*N/R_in + N/R_out (refills through R_in/k-page
    buffers plus output flushes).
    """
    p = ems_passes(n, m, plan.k)
    d = 2.0 * n * p
    c_pass = plan.k * n / max(plan.input_pages, 1e-9) + n / max(plan.output_pages, 1e-9)
    return d, c_pass * p, p


def ems_costs_exact(n: int, m: int, k: int, r_in_pages: int) -> Tuple[float, float, int]:
    """Exact (ceil/floor) merge-phase costs — matches the §II-C worked example.

    Per pass: reads refill through floor(R_in/k)-page per-run buffers and the
    output flushes through R_out = M - R_in pages, so
    C_pass = ceil(N / floor(R_in/k)) + ceil(N / R_out); D_pass = 2N.
    """
    r_out = m - r_in_pages
    per_run = max(1, r_in_pages // k)
    p = ems_passes(n, m, k)
    c_pass = math.ceil(n / per_run) + math.ceil(n / max(r_out, 1))
    return float(2 * n * p), float(c_pass * p), p


def ems_latency(n: float, m: float, plan: EMSPlan, tau: float) -> float:
    d, c, _ = ems_costs(n, m, plan)
    return d + tau * c


def ems_run_formation_costs(n: float, m: float) -> Tuple[float, float]:
    """(D, C) of run formation (§III-B a): one read + one write round per
    M-page chunk, each chunk moving its pages twice (in to sort, out as a run).

    This is the single closed form shared by the registry's EMS latency model,
    the session ``explain()`` report, and the benchmarks; it matches the
    simulated ledger of :func:`repro_torch.remote.ems.ems_sort` with
    ``count_run_formation=True`` exactly (one ``read``/``write`` scheduler
    round per chunk, D = 2N).
    """
    chunks = math.ceil(n / max(m, 1.0))
    return 2.0 * n, 2.0 * chunks


def ems_total_costs(n: float, m: float, plan: EMSPlan) -> Tuple[float, float]:
    """(D, C) of the whole sort: run formation plus all merge passes."""
    d_merge, c_merge, _ = ems_costs(n, m, plan)
    d_rf, c_rf = ems_run_formation_costs(n, m)
    return d_merge + d_rf, c_merge + c_rf


def ems_total_latency(n: float, m: float, plan: EMSPlan, tau: float) -> float:
    """L = D + tau*C of the whole sort including run formation."""
    d, c = ems_total_costs(n, m, plan)
    return d + tau * c


def ems_h(k: float, a: float) -> float:
    """h(k) = [2 + (sqrt(k)+1)^2 / alpha] / log2(k) (§III-B d)."""
    if k <= 1.0:
        return math.inf
    return (2.0 + (math.sqrt(k) + 1.0) ** 2 / a) / math.log2(k)


@functools.lru_cache(maxsize=65536)
def ems_kopt(a: float, k_max: int = 1 << 20) -> int:
    """Optimal integer fan-in k*(alpha) — reproduces Table IV.

    As alpha -> 0 (RTT-dominated) k* = 4; as alpha grows, k* grows toward the
    maximum feasible fan-in.  Memoized: the arbiter's marginal-cost descent
    re-evaluates the EMS plan at every candidate budget, and alpha = m/tau
    takes only ~budget x tiers distinct values per sweep.
    """
    if a <= 0.0:
        return 4
    best_k, best_h = 2, ems_h(2, a)
    # h is unimodal in k; scan integers with geometric stride then refine.
    k = 2
    while k <= k_max:
        h = ems_h(k, a)
        if h < best_h:
            best_k, best_h = k, h
        k += max(1, k // 64)
    for kk in range(max(2, best_k - 70), min(k_max, best_k + 70) + 1):
        h = ems_h(kk, a)
        if h < best_h:
            best_k, best_h = kk, h
    return best_k


def ems_plan(n: float, m: float, tau: float, k_cap: int | None = None) -> EMSPlan:
    """Full REMOP EMS policy: k from Table IV, split from Property 5."""
    if tau <= 0.0:
        k = max(2, int(m - 1))
    else:
        k = ems_kopt(m / tau)
    if k_cap is not None:
        k = min(k, k_cap)
    k = max(2, min(k, max(2, int(m - 1))))
    return EMSPlan(m=m, k=k, r_in=ems_split_opt(k))


def ems_conventional(m: float) -> EMSPlan:
    """Max fan-in: k = M-1, one page per input and output (§III-B e)."""
    k = max(2, int(m) - 1)
    return EMSPlan(m=m, k=k, r_in=(m - 1.0) / m)


def ems_duckdb(m: float) -> EMSPlan:
    """DuckDB v1.0.0: 2-way merge, R_in = 2M/3, R_out = M/3."""
    return EMSPlan(m=m, k=2, r_in=2.0 / 3.0)


# ==========================================================================
# External hash join (§III-C)
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class EHJPlan:
    op: ClassVar[str] = "ehj"  # engine.registry.OperatorPlan tag
    m_b: float  # I/O buffer-pool budget (pages)
    partitions: int  # radix P
    sigma: float  # spilled partition fraction (system-determined)
    # Per-phase allocations [R_r, R_w] / [R_r, R_s, R_o] / [R_r, R_o].
    p1: Tuple[float, ...] = ()
    p2: Tuple[float, ...] = ()
    p3: Tuple[float, ...] = ()


def ehj_phase_coeffs(
    b: float, q: float, out: float, partitions: int, sigma: float
) -> Tuple[Tuple[float, ...], Tuple[float, ...], Tuple[float, ...]]:
    """Round-cost coefficients a_j per phase (Table V numerators)."""
    p1 = (b, sigma * sigma * partitions * b)
    p2 = (q, sigma * sigma * partitions * q, (1.0 - sigma) * out)
    p3 = (sigma * (b + q), sigma * out)
    return p1, p2, p3


def ehj_data_costs(b: float, q: float, out: float, sigma: float) -> Tuple[float, float, float]:
    """Per-phase D_i (Table V): allocation-independent."""
    d1 = (1.0 + sigma) * b
    d2 = (1.0 + sigma) * q + (1.0 - sigma) * out
    d3 = sigma * (b + q) + sigma * out
    return d1, d2, d3


def ehj_plan(
    b: float, q: float, out: float, m_b: float, partitions: int, sigma: float
) -> EHJPlan:
    """Property 6: per-phase allocation R_j proportional to sqrt(a_j)."""
    c1, c2, c3 = ehj_phase_coeffs(b, q, out, partitions, sigma)
    a1, _ = waterfill(c1, m_b)
    a2, _ = waterfill(c2, m_b)
    a3, _ = waterfill(c3, m_b)
    return EHJPlan(
        m_b=m_b, partitions=partitions, sigma=sigma,
        p1=tuple(a1), p2=tuple(a2), p3=tuple(a3),
    )


def ehj_starved(m_b: float, partitions: int, sigma: float) -> EHJPlan:
    """Disk-oriented baseline: maximal read block, 1-page write pools.

    The DuckDB-default analogue the paper compares Property 6 against
    (Table VII): nearly the whole budget goes to the read block while every
    write/staging/output pool gets a single page.
    """
    return EHJPlan(
        m_b=m_b, partitions=partitions, sigma=sigma,
        p1=(m_b - 1.0, 1.0), p2=(m_b - 2.0, 1.0, 1.0), p3=(m_b - 1.0, 1.0),
    )


def ehj_round_costs(
    b: float, q: float, out: float, plan: EHJPlan
) -> Tuple[float, float, float]:
    """Evaluate Table V's C_i for a concrete plan."""
    c1, c2, c3 = ehj_phase_coeffs(b, q, out, plan.partitions, plan.sigma)
    return (
        round_cost(c1, plan.p1),
        round_cost(c2, plan.p2),
        round_cost(c3, plan.p3),
    )


def ehj_optimal_round_costs(
    b: float, q: float, out: float, m_b: float, partitions: int, sigma: float
) -> Tuple[float, float, float]:
    """Closed forms C_i* from Table VI."""
    p = partitions
    c1 = b * (1.0 + sigma * math.sqrt(p)) ** 2 / m_b
    c2 = (math.sqrt(q) + sigma * math.sqrt(p * q) + math.sqrt((1.0 - sigma) * out)) ** 2 / m_b
    c3 = sigma * (math.sqrt(b + q) + math.sqrt(out)) ** 2 / m_b
    return c1, c2, c3


def ehj_latency(b: float, q: float, out: float, plan: EHJPlan, tau: float) -> float:
    d = sum(ehj_data_costs(b, q, out, plan.sigma))
    c = sum(ehj_round_costs(b, q, out, plan))
    return d + tau * c


# ==========================================================================
# External (grace-style) hash aggregation
# ==========================================================================
#
# Same Property-6 structure as EHJ, one relation and two phases.  P1 scans the
# N-page input through R_r, aggregates resident partitions in memory and
# spills the others through a per-partition-sliced R_w pool; resident groups
# flush through R_o.  P2 re-reads each spilled partition through R_r and
# flushes its aggregated groups through R_o.  With spilled fraction sigma over
# P partitions and OUT pages of group output, the Table-V-style terms are
#
#   phase  pools        D_i                              a_j (C_j = a_j / R_j)
#   P1     R_r,R_w,R_o  (1+sigma)N + (1-sigma)OUT        N, sigma^2 P N, (1-sigma)OUT
#   P2     R_r,R_o      sigma (N + OUT)                  sigma N, sigma OUT


@dataclasses.dataclass(frozen=True)
class EAggPlan:
    op: ClassVar[str] = "eagg"  # engine.registry.OperatorPlan tag
    m_b: float  # I/O buffer-pool budget (pages)
    partitions: int  # radix P
    sigma: float  # spilled partition fraction (system-determined)
    # Per-phase allocations [R_r, R_w, R_o] / [R_r, R_o].
    p1: Tuple[float, ...] = ()
    p2: Tuple[float, ...] = ()


def eagg_phase_coeffs(
    n: float, out: float, partitions: int, sigma: float
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Round-cost coefficients a_j per phase (Table V analogue)."""
    p1 = (n, sigma * sigma * partitions * n, (1.0 - sigma) * out)
    p2 = (sigma * n, sigma * out)
    return p1, p2


def eagg_data_costs(n: float, out: float, sigma: float) -> Tuple[float, float]:
    """Per-phase D_i: allocation-independent."""
    d1 = (1.0 + sigma) * n + (1.0 - sigma) * out
    d2 = sigma * (n + out)
    return d1, d2


def eagg_plan(
    n: float, out: float, m_b: float, partitions: int, sigma: float
) -> EAggPlan:
    """Property 6 applied per phase: R_j proportional to sqrt(a_j)."""
    c1, c2 = eagg_phase_coeffs(n, out, partitions, sigma)
    a1, _ = waterfill(c1, m_b)
    a2, _ = waterfill(c2, m_b)
    return EAggPlan(
        m_b=m_b, partitions=partitions, sigma=sigma, p1=tuple(a1), p2=tuple(a2)
    )


def eagg_starved(m_b: float, partitions: int, sigma: float) -> EAggPlan:
    """Disk-oriented baseline: maximal read block, 1-page write/output pools."""
    return EAggPlan(
        m_b=m_b, partitions=partitions, sigma=sigma,
        p1=(m_b - 2.0, 1.0, 1.0), p2=(m_b - 1.0, 1.0),
    )


def eagg_round_costs(n: float, out: float, plan: EAggPlan) -> Tuple[float, float]:
    """Evaluate the per-phase C_i for a concrete plan."""
    c1, c2 = eagg_phase_coeffs(n, out, plan.partitions, plan.sigma)
    return round_cost(c1, plan.p1), round_cost(c2, plan.p2)


def eagg_optimal_round_costs(
    n: float, out: float, m_b: float, partitions: int, sigma: float
) -> Tuple[float, float]:
    """Closed forms C_i* (Property 6 / Table VI analogue)."""
    c1 = (
        math.sqrt(n)
        + sigma * math.sqrt(partitions * n)
        + math.sqrt((1.0 - sigma) * out)
    ) ** 2 / m_b
    c2 = sigma * (math.sqrt(n) + math.sqrt(out)) ** 2 / m_b
    return c1, c2


def eagg_costs_exact(
    n_pages: int,
    rows_per_page: int,
    spilled_rows: Sequence[int],
    resident_groups: int,
    spilled_groups: int,
    plan: EAggPlan,
) -> Tuple[float, float]:
    """Exact (ceil-based) D and C mirroring the engine's round semantics.

    ``spilled_rows`` are the per-spilled-partition row counts (skew-aware);
    ``resident_groups``/``spilled_groups`` the group-output row counts flushed
    in P1/P2.  Replicates the integer slice/batch sizing of
    :class:`repro_torch.engine.BufferPool` / :class:`repro_torch.engine.PageCursor`, so
    the simulated ledger of :func:`repro_torch.remote.eagg.eagg` matches exactly.
    """
    n_spilled = max(len(spilled_rows), 1)
    r_r1, r_w1, r_o1 = plan.p1
    r_r2, r_o2 = plan.p2

    def pool_rounds(rows: int, slice_pages: int) -> Tuple[int, int]:
        """(pages written, write rounds) for one stream through one pool slice."""
        if rows <= 0:
            return 0, 0
        slice_rows = slice_pages * rows_per_page
        full, rem = divmod(rows, slice_rows)
        pages = full * slice_pages + math.ceil(rem / rows_per_page)
        return pages, full + (1 if rem else 0)

    d = float(n_pages)
    c = math.ceil(n_pages / max(1, int(round(r_r1))))  # P1 input scan

    slice_w = max(1, int(r_w1 / n_spilled))
    batch2 = max(1, int(round(r_r2)))
    for rows in spilled_rows:  # P1 spill writes + P2 re-reads
        pages, rounds = pool_rounds(rows, slice_w)
        d += 2 * pages
        c += rounds + (math.ceil(pages / batch2) if pages else 0)

    for groups, r_o in ((resident_groups, r_o1), (spilled_groups, r_o2)):
        pages, rounds = pool_rounds(groups, max(1, int(r_o)))
        d += pages
        c += rounds
    return d, float(c)


def eagg_latency(n: float, out: float, plan: EAggPlan, tau: float) -> float:
    d = sum(eagg_data_costs(n, out, plan.sigma))
    c = sum(eagg_round_costs(n, out, plan))
    return d + tau * c


# ==========================================================================
# Tiered placement (memory hierarchy)
# ==========================================================================
#
# The paper's Table I prices several media; read as an ordered hierarchy
# (DRAM -> RDMA -> SSD) the planning question becomes *where* spilled pages
# live, not just how buffers split.  The closed forms below mirror the
# runtime router (`repro_torch.remote.simulator.MemoryHierarchy`): spill volume
# fills the cheapest (topmost) tier's free capacity first and overflows
# downward, and a write round that straddles a capacity boundary pays one
# round on every tier it lands on.


def tiered_split(
    pages: float,
    capacities: Sequence[float],
    occupied: Sequence[float] | None = None,
    start: int = 0,
) -> List[float]:
    """Cheapest-tier-first waterfall of ``pages`` over per-tier free capacity.

    Returns pages placed per tier (index-aligned with ``capacities``); tiers
    above ``start`` receive nothing.  Raises ``ValueError`` when the pages
    overflow the whole hierarchy (give the bottom tier ``math.inf`` capacity
    to model an unbounded backstop).
    """
    occ = [0.0] * len(capacities) if occupied is None else list(occupied)
    if len(occ) != len(capacities):
        raise ValueError("occupied and capacities must align")
    placed = [0.0] * len(capacities)
    remaining = float(pages)
    for t in range(start, len(capacities)):
        if remaining <= 0.0:
            break
        free = capacities[t] - occ[t]
        free = remaining if math.isinf(free) else max(math.floor(free), 0)
        take = min(remaining, free)
        placed[t] = take
        remaining -= take
    if remaining > 1e-9:
        raise ValueError(
            f"{pages} pages overflow the hierarchy "
            f"(capacities {list(capacities)}, occupied {occ})"
        )
    return placed


def waterfall_io(
    write_pages: float,
    round_pages: int,
    capacities: Sequence[float],
    occupied: Sequence[float] | None = None,
    start: int = 0,
) -> List[Tuple[float, float]]:
    """Exact per-tier (D, C) of a uniform-round write stream routed first-fit.

    A stream of ``write_pages`` pages arrives in rounds of ``round_pages``
    (the last round may be partial) targeting tier ``start``; the router
    places each round's pages into the first free capacity at-or-below the
    target, so stream page ``i`` lands deterministically and round
    ``floor(i / round_pages)`` pays one round on every tier it touches —
    exactly :class:`repro_torch.remote.simulator.MemoryHierarchy` write semantics
    (integral capacities/occupancy assumed, as in the page-granular store).
    """
    if round_pages < 1:
        raise ValueError(f"round_pages must be >= 1, got {round_pages}")
    placed = tiered_split(write_pages, capacities, occupied, start)
    per_tier: List[Tuple[float, float]] = []
    offset = 0.0  # stream offset of the first page landing on this tier
    for d in placed:
        if d <= 0:
            per_tier.append((0.0, 0.0))
            continue
        first_round = math.floor(offset / round_pages)
        last_round = math.floor((offset + d - 1) / round_pages)
        per_tier.append((float(d), float(last_round - first_round + 1)))
        offset += d
    return per_tier


def tiered_latency_cost(
    per_tier_dc: Sequence[Tuple[float, ...]],
    taus: Sequence[float],
    overlap_migration: bool = False,
) -> float:
    """Hierarchy-wide L = sum_t (D_t + tau_t * C_t) (Definition 3 per tier).

    Entries are ``(D, C)`` pairs (:func:`waterfall_io`) or ``(D, C,
    C_hidden)`` triples (:func:`eviction_waterfall_io`); with
    ``overlap_migration=True`` the hidden background-migration rounds pay no
    tau, mirroring ``latency_seconds(overlap_migration=True)``.
    """
    total = 0.0
    for entry, tau in zip(per_tier_dc, taus):
        d, c = entry[0], entry[1]
        hidden = entry[2] if len(entry) > 2 else 0.0
        paying = c - hidden if overlap_migration else c
        total += d + tau * max(paying, 0.0)
    return total


def eviction_waterfall_io(
    write_pages: float,
    round_pages: int,
    capacities: Sequence[float],
    occupied: Sequence[float] | None = None,
    start: int = 0,
) -> List[Tuple[float, float, float]]:
    """Exact per-tier (D, C, C_hidden) of a write stream under proactive eviction.

    The eviction-aware counterpart of :func:`waterfall_io`: the stream's
    ``write_pages`` arrive in rounds of ``round_pages`` targeting tier
    ``start``, and instead of waterfalling overflow downward, an evictor
    demotes the tier's coldest resident pages (pre-existing ``occupied``
    pages or the stream's own oldest pages) one tier down in **one background
    migration batch per overflowing round**, recursively making room below —
    exactly :class:`repro_torch.engine.eviction.Evictor` semantics.  Every write
    round therefore lands whole on the target tier; each demotion batch is
    one hidden read round on the ledger it leaves and one hidden write round
    on the ledger it enters.

    Returns one ``(D, C, C_hidden)`` triple per tier (D sums reads and
    writes, matching ``ledger.d_total``/``c_total``/``c_migration_hidden``
    for a hierarchy that runs only this stream).  Raises ``ValueError`` when
    a tier lacks evictable residents to cover a deficit or the bottom tier
    overflows — callers fall back to :func:`waterfall_io` semantics there.
    """
    if round_pages < 1:
        raise ValueError(f"round_pages must be >= 1, got {round_pages}")
    n = len(capacities)
    occ = [0.0] * n if occupied is None else list(occupied)
    if len(occ) != n:
        raise ValueError("occupied and capacities must align")
    res = list(occ)
    d = [0.0] * n
    c = [0.0] * n
    hidden = [0.0] * n

    def admit(t: int, amount: float) -> None:
        """Make room for ``amount`` pages arriving on tier ``t``."""
        free = capacities[t] - res[t]
        if math.isinf(free) or free >= amount:
            return
        if t == n - 1:
            raise ValueError(
                f"{amount} pages overflow the bottom tier "
                f"(capacities {list(capacities)}, resident {res})"
            )
        deficit = math.ceil(amount - free)
        if deficit > res[t]:
            raise ValueError(
                f"tier {t} holds {res[t]} evictable pages but needs to "
                f"demote {deficit}; not an eviction-covered stream"
            )
        admit(t + 1, deficit)
        d[t] += deficit  # read round leaving t (background: RTT hidden)
        c[t] += 1
        hidden[t] += 1
        d[t + 1] += deficit  # write round entering t+1 (hidden)
        c[t + 1] += 1
        hidden[t + 1] += 1
        res[t] -= deficit
        res[t + 1] += deficit

    remaining = float(write_pages)
    while remaining > 0:
        s = min(float(round_pages), remaining)
        admit(start, s)
        d[start] += s
        c[start] += 1
        res[start] += s
        remaining -= s
    return list(zip(d, c, hidden))


# ==========================================================================
# Operator pushdown (compute-capable tiers)
# ==========================================================================
#
# Farview/PIMDAL-style near-memory execution: a compute-capable TierLevel
# (``compute_pps`` pages/s, ``pushdown_ops``) can run a filter or a partial
# reduction over its resident pages and ship only results.  Ship-the-pages
# and ship-the-compute then price against each other in the same L units:
#
#   ship:  L = n + tau * ceil(n / batch)
#   push:  L = kept + tau * ceil(n / batch) + kappa * n        (filter)
#          L = out  + tau * 1               + kappa * n        (reduce)
#
# with kappa = level.compute_tau_pages (one scanned page's tier compute in
# L-pages) and kept = floor(n * sel) — the deterministic page-granular rule
# shared with ``MemoryHierarchy.scan_filtered`` (``pushdown_keep``), which is
# what makes these forms exact against the simulated ledger.


@dataclasses.dataclass(frozen=True)
class PushdownCosts:
    """Exact ledger prediction of one pushed scan over ``scanned`` pages."""

    d_ship: float  # result pages shipped back (d_pushdown)
    c_rounds: int  # request rounds (c_pushdown)
    scanned: float  # pages processed at the tier (d_pushdown + saved)
    compute_l: float  # tier compute in L units (kappa * scanned)
    compute_seconds: float  # tier compute wall time (scanned / compute_pps)

    @property
    def d_saved(self) -> float:
        return self.scanned - self.d_ship

    def latency_cost(self, tau: float) -> float:
        """L = D + tau*C + kappa*scanned of the pushed execution."""
        return self.d_ship + tau * self.c_rounds + self.compute_l


def pushdown_costs(
    n_pages: int,
    selectivity: float,
    level,
    batch_pages: int | None = None,
) -> PushdownCosts:
    """Exact costs of pushing a ``selectivity`` filter over ``n_pages``
    resident on compute-capable ``level`` (a ``TierLevel``), requested in
    ``batch_pages`` chunks (default: one round).

    Matches ``MemoryHierarchy.scan_filtered`` ledger-exactly:
    ``d_pushdown = floor(n * sel)``, ``c_pushdown = ceil(n / batch)``,
    ``d_pushdown_saved = n - floor(n * sel)``.
    """
    if n_pages < 0:
        raise ValueError(f"n_pages must be >= 0, got {n_pages}")
    if not math.isfinite(selectivity) or not 0.0 < selectivity <= 1.0:
        raise ValueError(
            f"selectivity must be finite and in (0, 1], got {selectivity}"
        )
    if not level.can_push("filter"):
        raise ValueError(
            f"tier {level.tier.name!r} cannot execute pushdown op 'filter'"
        )
    batch = int(n_pages) if batch_pages is None else int(batch_pages)
    if n_pages and batch <= 0:
        raise ValueError(f"batch_pages must be > 0, got {batch_pages}")
    kept = float(math.floor(n_pages * selectivity))
    rounds = math.ceil(n_pages / batch) if n_pages else 0
    return PushdownCosts(
        d_ship=kept,
        c_rounds=rounds,
        scanned=float(n_pages),
        compute_l=level.compute_tau_pages * n_pages if n_pages else 0.0,
        compute_seconds=level.compute_seconds(float(n_pages)),
    )


def pushdown_reduce_costs(n_pages: int, out_pages: float, level) -> PushdownCosts:
    """Exact costs of a pushed partial reduction: one request round ships
    ``out_pages`` result pages instead of ``n_pages`` raw ones
    (``MemoryHierarchy.read_reduced`` semantics)."""
    if n_pages < 0:
        raise ValueError(f"n_pages must be >= 0, got {n_pages}")
    if not level.can_push("reduce"):
        raise ValueError(
            f"tier {level.tier.name!r} cannot execute pushdown op 'reduce'"
        )
    return PushdownCosts(
        d_ship=float(out_pages),
        c_rounds=1 if n_pages else 0,
        scanned=float(n_pages),
        compute_l=level.compute_tau_pages * n_pages if n_pages else 0.0,
        compute_seconds=level.compute_seconds(float(n_pages)),
    )


@dataclasses.dataclass(frozen=True)
class PushdownChoice:
    """A round-aware ship-pages vs. ship-compute arbitration verdict."""

    op: str  # "filter" or "reduce"
    push: bool  # True: execute at the tier; False: ship the pages
    l_ship: float  # L of shipping the raw pages
    l_push: float  # L of the pushed execution (inf on a non-capable tier)
    d_saved: float  # pages that skip the trip when pushed (0 if shipped)
    c_pushdown: int  # request rounds stamped when pushed (0 if shipped)
    scanned: float  # pages the tier would process when pushed

    @property
    def l_delta(self) -> float:
        """L change of the decision vs. ship-only (<= 0 by construction)."""
        return min(self.l_push - self.l_ship, 0.0)

    @property
    def mode(self) -> str:
        return "push" if self.push else "ship"


def pushdown_or_ship(
    n_pages: int,
    selectivity: float,
    level,
    tau: float,
    batch_pages: int | None = None,
    op: str = "filter",
    out_pages: float | None = None,
) -> PushdownChoice:
    """Price ship-the-pages against ship-the-compute for one stream.

    ``op="filter"``: push ships ``floor(n * sel)`` pages in the same
    ``ceil(n / batch)`` rounds as the ship path, plus tier compute on all
    ``n`` scanned pages.  ``op="reduce"``: push ships ``out_pages`` result
    pages in one round (``selectivity`` is ignored).  A tier that cannot
    execute ``op`` always ships (``l_push = inf``); ties ship too, so the
    chooser is never worse than ship-only and declines pushdown whenever the
    tier's compute is too slow to pay for the volume it saves.
    """
    if n_pages < 0:
        raise ValueError(f"n_pages must be >= 0, got {n_pages}")
    batch = int(n_pages) if batch_pages is None else int(batch_pages)
    if n_pages and batch <= 0:
        raise ValueError(f"batch_pages must be > 0, got {batch_pages}")
    ship_rounds = math.ceil(n_pages / batch) if n_pages else 0
    l_ship = n_pages + tau * ship_rounds
    if n_pages == 0 or not level.can_push(op):
        return PushdownChoice(op=op, push=False, l_ship=l_ship,
                              l_push=math.inf, d_saved=0.0, c_pushdown=0,
                              scanned=0.0)
    if op == "filter":
        pc = pushdown_costs(n_pages, selectivity, level, batch_pages=batch)
    elif op == "reduce":
        if out_pages is None:
            raise ValueError("op='reduce' needs out_pages=")
        pc = pushdown_reduce_costs(n_pages, out_pages, level)
    else:
        raise ValueError(f"unknown pushdown op {op!r}")
    l_push = pc.latency_cost(tau)
    push = l_push < l_ship - 1e-12
    return PushdownChoice(
        op=op, push=push, l_ship=l_ship, l_push=l_push,
        d_saved=pc.d_saved if push else 0.0,
        c_pushdown=pc.c_rounds if push else 0,
        scanned=pc.scanned if push else 0.0,
    )
