"""REMOP latency cost model (paper §II).

The central object is Eq. (1):

    Latency = sum_i (d_i / BW + RTT) = D / BW + C * RTT

where ``D`` is total data volume, ``C`` the number of *transfer rounds*, and
``(BW, RTT)`` characterize the tier holding spilled data.  Definition 3
normalizes this to the dimensionless latency cost

    L = D + tau * C,        tau = BW * RTT / unit

measured in the same unit as ``D`` (pages or bytes).  ``tau -> 0`` recovers the
classical min-volume objective; large ``tau`` makes round count first-order.

Tier constants come from the paper's Table I (order-of-magnitude media) and
Table IX (the CloudLab testbed), plus the card-side tiers of one NVIDIA H100
(``H100_TIERS``, ``H100``): device memory to shared memory, NVLink, PCIe
host offload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, Optional, Tuple

# --------------------------------------------------------------------------
# Tier specifications
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """A storage/memory tier reachable from the operator's local budget.

    Attributes:
      name: human-readable identifier.
      bandwidth: sustained transfer bandwidth, bytes/second.
      rtt: fixed per-round overhead, seconds (network RTT, DMA issue
        overhead, collective launch latency, ... depending on the tier).
      page_bytes: the batching unit used when expressing D in pages.
    """

    name: str
    bandwidth: float
    rtt: float
    page_bytes: int = 256 * 1024  # DuckDB block size used by the paper.

    @property
    def tau_bytes(self) -> float:
        """tau with D measured in bytes: RTT expressed as equivalent bytes."""
        return self.bandwidth * self.rtt

    @property
    def tau_pages(self) -> float:
        """tau with D measured in pages (the paper's convention)."""
        return self.bandwidth * self.rtt / self.page_bytes

    def latency_seconds(self, d_pages: float, c_rounds: float) -> float:
        """Eq. (1): D/BW + C*RTT with D given in pages."""
        return d_pages * self.page_bytes / self.bandwidth + c_rounds * self.rtt

    def latency_seconds_bytes(self, d_bytes: float, c_rounds: float) -> float:
        return d_bytes / self.bandwidth + c_rounds * self.rtt


def latency_cost(d: float, c: float, tau: float) -> float:
    """Definition 3: L = D + tau * C (unit must match between d and tau)."""
    return d + tau * c


# Paper Table I (order of magnitude) -----------------------------------------
TABLE_I: Dict[str, TierSpec] = {
    "dram": TierSpec("dram", bandwidth=25.6e9, rtt=100e-9),
    "ssd": TierSpec("ssd", bandwidth=0.53e9, rtt=100e-6),
    "tcp": TierSpec("tcp", bandwidth=1.25e9, rtt=500e-6),
    "rdma": TierSpec("rdma", bandwidth=6.8e9, rtt=1e-6),
}

# Paper Table IX (CloudLab c6220 testbed) ------------------------------------
TESTBED: Dict[str, TierSpec] = {
    # 10 GbE TCP, RTT 0.155 ms.
    "remon_tcp": TierSpec("remon_tcp", bandwidth=1.25e9, rtt=155e-6),
    # 48.6 Gb/s InfiniBand RDMA, RTT 1.16 us.
    "infiniswap_rdma": TierSpec("infiniswap_rdma", bandwidth=6.075e9, rtt=1.16e-6),
    # Local SSD spill (DuckDB temp files) for the backend comparison.
    "disk": TierSpec("disk", bandwidth=0.53e9, rtt=100e-6),
}

def resolve_tier_name(tier: "TierSpec | str") -> TierSpec:
    """Resolve a tier name against Table I / TESTBED / H100 tiers.

    Lives next to the tables so every lookup (engine registry, hierarchy
    constructors) shares one copy; ``TierSpec`` inputs pass through.
    """
    if isinstance(tier, TierSpec):
        return tier
    for table in (TABLE_I, TESTBED, H100_TIERS):
        if tier in table:
            return table[tier]
    known = sorted(set(TABLE_I) | set(TESTBED) | set(H100_TIERS))
    raise KeyError(f"unknown tier {tier!r}; known: {known}")


# Card-side tiers of one H100 SXM. -------------------------------------------
# Bandwidths are data-sheet figures (NVIDIA H100 SXM data sheet).  The "RTT"
# of each tier is the fixed cost of one round of its mechanism, and every one
# of them is a PLACEHOLDER chosen for this card, not measured: staging one
# tile from device memory into shared memory (a round trip to HBM plus a
# barrier), launching one NCCL collective over NVLink, one host<->device copy
# over PCIe.  page_bytes is only the unit in which D is counted in pages.
H100_DMA_OVERHEAD_S = 0.5e-6  # placeholder
H100_COLLECTIVE_LAUNCH_S = 5e-6  # placeholder
H100_PCIE_ROUND_S = 10e-6  # placeholder
H100_TIERS: Dict[str, TierSpec] = {
    "hbm_dma": TierSpec("hbm_dma", bandwidth=3.35e12, rtt=H100_DMA_OVERHEAD_S,
                        page_bytes=1024),
    # NVLink 4: 900 GB/s to the other cards of the host, 450 GB/s each way.
    "nvlink": TierSpec("nvlink", bandwidth=450e9, rtt=H100_COLLECTIVE_LAUNCH_S,
                       page_bytes=1024),
    # PCIe Gen5 x16: 64 GB/s each way.
    "pcie_host": TierSpec("pcie_host", bandwidth=64e9, rtt=H100_PCIE_ROUND_S,
                          page_bytes=4096),
}


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """Hardware constants of one NVIDIA H100 SXM for ``core.planner``.

    The attribute names are the ones the planner reads (they first named a
    TPU's memories); each comment says what the figure is on Hopper.
    Data-sheet figures are from the NVIDIA H100 SXM data sheet; the two
    ``*_s`` overheads are placeholders (see ``H100_TIERS``).
    """

    name: str = "h100-sxm"
    peak_flops: float = 989e12  # dense bf16 tensor-core FLOP/s (data sheet)
    hbm_bandwidth: float = 3.35e12  # HBM3 bytes/s (data sheet)
    ici_bandwidth: float = 450e9  # NVLink bytes/s, one direction (data sheet)
    vmem_bytes: int = 232_448  # shared memory one CTA can use, 227 KB (data sheet)
    sms: int = 132  # streaming multiprocessors (data sheet)
    hbm_bytes: int = 80 * 1024**3  # device memory, "80GB" (data sheet): five 16 GiB HBM3 stacks
    dma_overhead_s: float = H100_DMA_OVERHEAD_S  # one tile staging round: placeholder
    collective_launch_s: float = H100_COLLECTIVE_LAUNCH_S  # one NCCL launch: placeholder

    @property
    def tau_dma_bytes(self) -> float:
        """Per-staging-round fixed cost as equivalent HBM bytes (REMOP tau)."""
        return self.hbm_bandwidth * self.dma_overhead_s

    @property
    def tau_ici_bytes(self) -> float:
        """Per-collective fixed cost as equivalent NVLink bytes."""
        return self.ici_bandwidth * self.collective_launch_s


H100 = H100Spec()


# --------------------------------------------------------------------------
# Transfer ledger — D/C accounting shared by the simulator and the planner
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LedgerSnapshot:
    """Immutable point-in-time copy of a :class:`TransferLedger`.

    Produced by ``TransferLedger.snapshot()``; ``TransferLedger.delta`` turns
    two snapshots (or the live ledger and one snapshot) into the D/C counts
    attributable to a region of execution.  Operators report their per-call
    accounting this way instead of copying the mutable ledger.
    """

    d_read: float = 0.0
    d_write: float = 0.0
    c_read: int = 0
    c_write: int = 0
    c_prefetch_hidden: int = 0
    # Migration rounds overlapped with compute (§IV-E applied to background
    # demotion): they still count in c_read/c_write but pay no RTT when the
    # caller opts into ``overlap_migration``.
    c_migration_hidden: int = 0
    # Pushdown accounting (operator off-loading to a compute-capable tier):
    # ``c_pushdown`` request rounds (a subset of ``c_read``) carried back only
    # result pages, ``d_pushdown`` of them (a subset of ``d_read``), while
    # ``d_pushdown_saved`` pages were scanned at the tier and never shipped.
    # Pages processed by tier compute = d_pushdown + d_pushdown_saved.
    c_pushdown: int = 0
    d_pushdown: float = 0.0
    d_pushdown_saved: float = 0.0

    @property
    def d_total(self) -> float:
        return self.d_read + self.d_write

    @property
    def c_total(self) -> int:
        return self.c_read + self.c_write

    @property
    def d_pushdown_scanned(self) -> float:
        """Pages processed by tier compute (shipped results + saved pages)."""
        return self.d_pushdown + self.d_pushdown_saved

    def __add__(self, other: "LedgerSnapshot") -> "LedgerSnapshot":
        """Field-wise sum: accumulate per-region deltas into one snapshot."""
        if not isinstance(other, LedgerSnapshot):
            return NotImplemented
        return LedgerSnapshot(
            d_read=self.d_read + other.d_read,
            d_write=self.d_write + other.d_write,
            c_read=self.c_read + other.c_read,
            c_write=self.c_write + other.c_write,
            c_prefetch_hidden=self.c_prefetch_hidden + other.c_prefetch_hidden,
            c_migration_hidden=self.c_migration_hidden + other.c_migration_hidden,
            c_pushdown=self.c_pushdown + other.c_pushdown,
            d_pushdown=self.d_pushdown + other.d_pushdown,
            d_pushdown_saved=self.d_pushdown_saved + other.d_pushdown_saved,
        )

    def latency_cost(self, tau: float) -> float:
        return latency_cost(self.d_total, self.c_total, tau)

    def to_dict(self) -> Dict[str, float]:
        """Counter-per-key serialization (bench JSON, server responses).

        Spelled as an explicit dict literal — not ``dataclasses.asdict`` —
        so the LED109 contract check can verify statically that every
        counter survives serialization.
        """
        return {
            "d_read": self.d_read,
            "d_write": self.d_write,
            "c_read": self.c_read,
            "c_write": self.c_write,
            "c_prefetch_hidden": self.c_prefetch_hidden,
            "c_migration_hidden": self.c_migration_hidden,
            "c_pushdown": self.c_pushdown,
            "d_pushdown": self.d_pushdown,
            "d_pushdown_saved": self.d_pushdown_saved,
        }


@dataclasses.dataclass
class TransferLedger:
    """Counts transferred pages (D) and transfer rounds (C), split by direction.

    This is the bookkeeping abstraction behind Definitions 1 and 2: the
    remote-memory simulator increments it on every batched swap-in/flush-out,
    and the analytical policies produce closed-form predictions that tests
    compare against it.
    """

    d_read: float = 0.0
    d_write: float = 0.0
    c_read: int = 0
    c_write: int = 0
    # Rounds whose RTT was hidden by the prefetch double buffer (§IV-E).
    c_prefetch_hidden: int = 0
    # Migration rounds overlapped with operator compute (background demotion
    # modeled the way §IV-E models prefetch); disjoint from prefetch hiding.
    c_migration_hidden: int = 0
    # Pushdown rounds (subset of c_read): the request shipped a predicate or
    # partial down and only result pages (d_pushdown, subset of d_read) back;
    # d_pushdown_saved pages stayed at the tier instead of making the trip.
    c_pushdown: int = 0
    d_pushdown: float = 0.0
    d_pushdown_saved: float = 0.0

    @property
    def d_total(self) -> float:
        return self.d_read + self.d_write

    @property
    def c_total(self) -> int:
        return self.c_read + self.c_write

    @property
    def d_pushdown_scanned(self) -> float:
        """Pages processed by tier compute (shipped results + saved pages)."""
        return self.d_pushdown + self.d_pushdown_saved

    def read(self, pages: float) -> None:
        self.d_read += pages
        self.c_read += 1

    def write(self, pages: float) -> None:
        self.d_write += pages
        self.c_write += 1

    def pushdown(self, shipped: float, saved: float) -> None:
        """One pushdown request round: ``shipped`` result pages made the
        trip, ``saved`` scanned pages did not.  Counts as a read round."""
        self.d_read += shipped
        self.c_read += 1
        self.d_pushdown += shipped
        self.c_pushdown += 1
        self.d_pushdown_saved += saved

    def snapshot(self) -> LedgerSnapshot:
        """Freeze the current counters (Definition 1/2 state) for later deltas."""
        return LedgerSnapshot(
            d_read=self.d_read,
            d_write=self.d_write,
            c_read=self.c_read,
            c_write=self.c_write,
            c_prefetch_hidden=self.c_prefetch_hidden,
            c_migration_hidden=self.c_migration_hidden,
            c_pushdown=self.c_pushdown,
            d_pushdown=self.d_pushdown,
            d_pushdown_saved=self.d_pushdown_saved,
        )

    def delta(self, since: LedgerSnapshot) -> LedgerSnapshot:
        """Counters accumulated since ``since`` (a prior ``snapshot()``)."""
        return LedgerSnapshot(
            d_read=self.d_read - since.d_read,
            d_write=self.d_write - since.d_write,
            c_read=self.c_read - since.c_read,
            c_write=self.c_write - since.c_write,
            c_prefetch_hidden=self.c_prefetch_hidden - since.c_prefetch_hidden,
            c_migration_hidden=self.c_migration_hidden - since.c_migration_hidden,
            c_pushdown=self.c_pushdown - since.c_pushdown,
            d_pushdown=self.d_pushdown - since.d_pushdown,
            d_pushdown_saved=self.d_pushdown_saved - since.d_pushdown_saved,
        )

    def merge(self, other: "TransferLedger") -> None:
        self.d_read += other.d_read
        self.d_write += other.d_write
        self.c_read += other.c_read
        self.c_write += other.c_write
        self.c_prefetch_hidden += other.c_prefetch_hidden
        self.c_migration_hidden += other.c_migration_hidden
        self.c_pushdown += other.c_pushdown
        self.d_pushdown += other.d_pushdown
        self.d_pushdown_saved += other.d_pushdown_saved

    def latency_seconds(
        self,
        tier: TierSpec,
        prefetch: bool = False,
        overlap_migration: bool = False,
        compute_pps: Optional[float] = None,
    ) -> float:
        """Eq. (1) over the ledger; hidden rounds pay no RTT when opted in.

        ``prefetch`` drops the double-buffered read rounds' RTT (§IV-E);
        ``overlap_migration`` drops the RTT of migration rounds performed in
        the background (demotions overlapped with operator compute).  The
        bandwidth term always pays in full — overlap hides latency, not
        volume.  ``compute_pps`` (a compute-capable tier's processing rate)
        adds the tier-side compute time of pushdown-scanned pages.
        """
        c_paying = self.c_total
        if prefetch:
            c_paying -= self.c_prefetch_hidden
        if overlap_migration:
            c_paying -= self.c_migration_hidden
        seconds = tier.latency_seconds(self.d_total, max(c_paying, 0))
        if compute_pps:
            seconds += self.d_pushdown_scanned / compute_pps
        return seconds

    def latency_cost(self, tau: float) -> float:
        return latency_cost(self.d_total, self.c_total, tau)

    def reset(self) -> None:
        self.d_read = self.d_write = 0.0
        self.c_read = self.c_write = 0
        self.c_prefetch_hidden = 0
        self.c_migration_hidden = 0
        self.c_pushdown = 0
        self.d_pushdown = 0.0
        self.d_pushdown_saved = 0.0


# --------------------------------------------------------------------------
# Memory hierarchy — ordered tiers with capacities (Table I as a *hierarchy*)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierLevel:
    """One level of a memory hierarchy: a tier plus its page capacity.

    ``capacity_pages`` bounds how many pages the level's store may hold;
    ``math.inf`` marks an effectively unbounded backstop (the bottom tier).

    A level may additionally be *compute-capable* (Farview/PIMDAL-style
    near-memory processing): ``compute_pps`` is the tier's processing rate in
    pages/second and ``pushdown_ops`` names the operations it can execute on
    resident pages (``"filter"``, ``"reduce"``).  ``None``/empty means no
    capability — plain DRAM and SSD levels default off; RDMA/CXL-style
    disaggregated tiers opt in per hierarchy.
    """

    tier: TierSpec
    capacity_pages: float = math.inf
    compute_pps: Optional[float] = None
    pushdown_ops: FrozenSet[str] = frozenset()

    def __post_init__(self) -> None:
        if self.capacity_pages <= 0:
            raise ValueError(
                f"tier {self.tier.name!r} needs capacity_pages > 0, "
                f"got {self.capacity_pages}"
            )
        object.__setattr__(self, "pushdown_ops",
                           frozenset(self.pushdown_ops))
        if self.compute_pps is not None and self.compute_pps <= 0:
            raise ValueError(
                f"tier {self.tier.name!r} needs compute_pps > 0 (or None), "
                f"got {self.compute_pps}"
            )
        if self.pushdown_ops and self.compute_pps is None:
            raise ValueError(
                f"tier {self.tier.name!r} declares pushdown_ops "
                f"{sorted(self.pushdown_ops)} but no compute_pps rate"
            )

    def can_push(self, op: str) -> bool:
        """Whether this level can execute pushdown op ``op`` on its pages."""
        return self.compute_pps is not None and op in self.pushdown_ops

    @property
    def compute_tau_pages(self) -> float:
        """Tier compute priced in this tier's L units (pages per page scanned).

        ``latency_seconds = L * page_bytes / bandwidth`` per tier, so one
        second of tier compute is worth ``bandwidth / page_bytes`` L-pages;
        scanning one page costs ``1 / compute_pps`` seconds.  ``inf`` for a
        tier with no compute capability.
        """
        if not self.compute_pps:
            return math.inf
        return (self.tier.bandwidth / self.tier.page_bytes) / self.compute_pps

    def compute_seconds(self, pages: float) -> float:
        """Tier-side processing time for ``pages`` scanned pages."""
        if not self.compute_pps:
            return math.inf if pages > 0 else 0.0
        return pages / self.compute_pps


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """An ordered memory hierarchy, fastest (top) tier first.

    The order is the *placement priority*: the paper's Table I read as a
    DRAM -> RDMA -> SSD waterfall.  Planning fills the cheapest (topmost)
    tier first given per-level capacities; the runtime analogue is
    :class:`repro_torch.remote.simulator.MemoryHierarchy`.
    """

    levels: Tuple[TierLevel, ...]

    def __post_init__(self) -> None:
        if not self.levels:
            raise ValueError("a hierarchy needs at least one tier level")
        names = [lv.tier.name for lv in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in hierarchy: {names}")

    def __len__(self) -> int:
        return len(self.levels)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(lv.tier.name for lv in self.levels)

    @property
    def taus(self) -> Tuple[float, ...]:
        return tuple(lv.tier.tau_pages for lv in self.levels)

    @property
    def capacities(self) -> Tuple[float, ...]:
        return tuple(lv.capacity_pages for lv in self.levels)

    def index(self, tier: "int | str") -> int:
        """Resolve a tier name or index to its level index."""
        if isinstance(tier, str):
            try:
                return self.names.index(tier)
            except ValueError:
                raise KeyError(
                    f"hierarchy has no tier {tier!r}; tiers: {list(self.names)}"
                ) from None
        idx = int(tier)
        if not -len(self.levels) <= idx < len(self.levels):
            raise KeyError(f"tier index {idx} out of range for {list(self.names)}")
        return idx % len(self.levels)

    def level(self, tier: "int | str") -> TierLevel:
        return self.levels[self.index(tier)]


def hierarchy_spec(
    *levels: "TierLevel | TierSpec | str | Tuple[TierSpec | str, float]",
) -> HierarchySpec:
    """Build a :class:`HierarchySpec` from tier / ``(tier, cap)`` levels.

    Tiers are ``TierSpec``\\ s or names resolved against Table I / TESTBED,
    e.g. ``hierarchy_spec(("dram", 64), ("rdma", 1024), "ssd")``;
    a bare tier gets unbounded capacity.  A fully-specified
    :class:`TierLevel` passes through unchanged — the way compute-capable
    levels (``compute_pps``/``pushdown_ops``) enter a hierarchy.  The single
    normalization point for every hierarchy constructor
    (``make_hierarchy``, ``resolve_hierarchy``).
    """
    built = []
    for lv in levels:
        if isinstance(lv, TierLevel):
            built.append(lv)
        elif isinstance(lv, (tuple, list)):
            tier, cap = lv
            built.append(TierLevel(resolve_tier_name(tier), float(cap)))
        else:
            built.append(TierLevel(resolve_tier_name(lv)))
    return HierarchySpec(tuple(built))


def _sum_snapshots(snaps: "Tuple[LedgerSnapshot, ...]") -> LedgerSnapshot:
    return LedgerSnapshot(
        d_read=sum(s.d_read for s in snaps),
        d_write=sum(s.d_write for s in snaps),
        c_read=sum(s.c_read for s in snaps),
        c_write=sum(s.c_write for s in snaps),
        c_prefetch_hidden=sum(s.c_prefetch_hidden for s in snaps),
        c_migration_hidden=sum(s.c_migration_hidden for s in snaps),
        c_pushdown=sum(s.c_pushdown for s in snaps),
        d_pushdown=sum(s.d_pushdown for s in snaps),
        d_pushdown_saved=sum(s.d_pushdown_saved for s in snaps),
    )


@dataclasses.dataclass(frozen=True)
class HierarchySnapshot:
    """Per-tier :class:`LedgerSnapshot`\\ s of one hierarchy, top tier first.

    The aggregate D/C properties make a hierarchy snapshot a drop-in for a
    single ledger's snapshot wherever only totals matter (operator result
    reporting), while ``tier()`` exposes the per-tier split; the per-tier
    ledgers always sum to the hierarchy-wide totals by construction.
    """

    tiers: Tuple[Tuple[str, LedgerSnapshot], ...]

    def tier(self, name: str) -> LedgerSnapshot:
        for n, snap in self.tiers:
            if n == name:
                return snap
        raise KeyError(
            f"snapshot has no tier {name!r}; tiers: {[n for n, _ in self.tiers]}"
        )

    @property
    def total(self) -> LedgerSnapshot:
        return _sum_snapshots(tuple(s for _, s in self.tiers))

    def __add__(self, other: "HierarchySnapshot") -> "HierarchySnapshot":
        """Tier-wise sum of two snapshots of the *same* hierarchy.

        The per-tenant ledger accounting of the multi-tenant server
        accumulates task deltas this way; tier names must match pairwise.
        """
        if not isinstance(other, HierarchySnapshot):
            return NotImplemented
        names = [n for n, _ in self.tiers]
        other_names = [n for n, _ in other.tiers]
        if names != other_names:
            raise ValueError(
                f"cannot add snapshots of different hierarchies: "
                f"{names} vs {other_names}"
            )
        return HierarchySnapshot(tiers=tuple(
            (n, a + b) for (n, a), (_, b) in zip(self.tiers, other.tiers)
        ))

    @classmethod
    def zero(cls, spec: "HierarchySpec") -> "HierarchySnapshot":
        """An all-zero snapshot shaped like ``spec`` (accumulator seed)."""
        return cls(tiers=tuple((n, LedgerSnapshot()) for n in spec.names))

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        """Per-tier counter dicts keyed by tier name, plus the aggregate
        under ``"total"`` (which per-tier shares sum to by construction)."""
        out = {name: snap.to_dict() for name, snap in self.tiers}
        out["total"] = self.total.to_dict()
        return out

    # Aggregate pass-throughs (keep operator reporting tier-agnostic).
    @property
    def d_read(self) -> float:
        return sum(s.d_read for _, s in self.tiers)

    @property
    def d_write(self) -> float:
        return sum(s.d_write for _, s in self.tiers)

    @property
    def c_read(self) -> int:
        return sum(s.c_read for _, s in self.tiers)

    @property
    def c_write(self) -> int:
        return sum(s.c_write for _, s in self.tiers)

    @property
    def c_prefetch_hidden(self) -> int:
        return sum(s.c_prefetch_hidden for _, s in self.tiers)

    @property
    def c_migration_hidden(self) -> int:
        return sum(s.c_migration_hidden for _, s in self.tiers)

    @property
    def c_pushdown(self) -> int:
        return sum(s.c_pushdown for _, s in self.tiers)

    @property
    def d_pushdown(self) -> float:
        return sum(s.d_pushdown for _, s in self.tiers)

    @property
    def d_pushdown_saved(self) -> float:
        return sum(s.d_pushdown_saved for _, s in self.tiers)

    @property
    def d_total(self) -> float:
        return self.d_read + self.d_write

    @property
    def c_total(self) -> int:
        return self.c_read + self.c_write

    def latency_cost(self, tau: "float | HierarchySpec") -> float:
        """Hierarchy-aware L: per-tier D + tau_t * C summed over tiers.

        A scalar ``tau`` prices every round the same (the single-tier
        degenerate case); a :class:`HierarchySpec` prices each tier's rounds
        with that tier's ``tau_pages`` plus — for compute-capable tiers —
        the pushdown-scanned pages at ``compute_tau_pages`` each.
        """
        if isinstance(tau, HierarchySpec):
            total = 0.0
            for name, t in zip(tau.names, tau.taus):
                snap = self.tier(name)
                total += snap.latency_cost(t)
                scanned = snap.d_pushdown_scanned
                if scanned > 0:
                    total += tau.level(name).compute_tau_pages * scanned
            return total
        return self.total.latency_cost(tau)

    def latency_seconds(
        self,
        spec: HierarchySpec,
        prefetch: bool = False,
        overlap_migration: bool = False,
    ) -> float:
        """Eq. (1) summed per tier with each tier's (BW, RTT) constants.

        ``overlap_migration`` drops the RTT of background migration rounds
        (``c_migration_hidden``), mirroring how ``prefetch`` drops the
        double-buffered read rounds' RTT.  A compute-capable tier's
        pushdown-scanned pages add their tier-side processing time.
        """
        total = 0.0
        for name, snap in self.tiers:
            level = spec.level(name)
            c = snap.c_total
            if prefetch:
                c -= snap.c_prefetch_hidden
            if overlap_migration:
                c -= snap.c_migration_hidden
            total += level.tier.latency_seconds(snap.d_total, max(c, 0))
            if level.compute_pps:
                total += snap.d_pushdown_scanned / level.compute_pps
        return total


def alpha(m_pages: float, tau: float) -> float:
    """Memory-scaled network parameter alpha = M / tau (Table II)."""
    if tau <= 0:
        return math.inf
    return m_pages / tau


def beta(selectivity: float, m_pages: float) -> float:
    """Selectivity-memory parameter beta = f * M (Table II)."""
    return selectivity * m_pages
