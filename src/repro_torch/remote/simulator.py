"""Simulated remote-memory tier (paper §IV-F, REMON/Infiniswap analogue).

Pages are real numpy arrays held in a remote store; operators move them in
*batched transfer rounds* through a :class:`repro_torch.core.TransferLedger`, so the
paper's D/C accounting is measured, not assumed.  Latency follows Eq. (1)
exactly: ``D/BW + C*RTT`` with the tier's constants (Table I / Table IX).

The store is content-addressed by integer page ids; a relation or run is a
list of page ids.  ``read_batch``/``write_batch`` are the only ways data
crosses the boundary — one call is one transfer round, whatever its size,
mirroring REMON's batched evict/fetch interface.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cost_model import (
    HierarchySnapshot,
    HierarchySpec,
    TierSpec,
    TransferLedger,
)


def pushdown_keep(position: int, selectivity: float) -> bool:
    """Deterministic page-granular filter: keep the page at ``position``.

    Zone-map-style Bresenham rule — keep page ``i`` iff
    ``floor((i+1)*sel) > floor(i*sel)`` — so exactly ``floor(n*sel)`` of any
    ``n`` consecutive positions survive *regardless of batching*.  Both the
    simulator and the closed forms (:func:`repro_torch.core.policies.pushdown_costs`)
    use this rule, which is what makes them exactly comparable.
    """
    return math.floor((position + 1) * selectivity) > math.floor(
        position * selectivity
    )


def _check_selectivity(selectivity) -> float:
    s = float(selectivity)
    if not math.isfinite(s) or not 0.0 < s <= 1.0:
        raise ValueError(
            f"filter selectivity must be finite and in (0, 1], got {selectivity}"
        )
    return s


class RemoteMemory:
    """A remote tier holding pages, with round/volume accounting."""

    def __init__(self, tier: TierSpec, _alloc: Optional[Iterator[int]] = None):
        self.tier = tier
        self.ledger = TransferLedger()
        self._store: dict[int, np.ndarray] = {}
        # Page-id allocator; a MemoryHierarchy passes one shared counter so
        # ids are unique hierarchy-wide and survive tier migration.
        self._alloc = itertools.count() if _alloc is None else _alloc

    # -- allocation ---------------------------------------------------------

    @property
    def pages_resident(self) -> int:
        """Number of pages currently held by the remote store."""
        return len(self._store)

    def put_local(self, pages: Sequence[np.ndarray]) -> List[int]:
        """Seed the store without accounting (initial data placement)."""
        ids = []
        for p in pages:
            i = next(self._alloc)
            self._store[i] = np.asarray(p)
            ids.append(i)
        return ids

    def peek_batch(self, page_ids: Sequence[int]) -> List[np.ndarray]:
        """Oracle-side reads without accounting (no transfer round)."""
        return [self._store[i] for i in page_ids]

    # -- batched transfer rounds ---------------------------------------------

    def read_batch(self, page_ids: Sequence[int], prefetched: bool = False) -> List[np.ndarray]:
        """One swap-in round: fetch a batch of pages (Definition 2)."""
        if not page_ids:
            return []
        self.ledger.read(float(len(page_ids)))
        if prefetched:
            self.ledger.c_prefetch_hidden += 1
        return [self._store[i] for i in page_ids]

    def write_batch(self, pages: Sequence[np.ndarray]) -> List[int]:
        """One flush-out round: write a batch of pages."""
        if not len(pages):
            return []
        ids = self.put_local(pages)
        self.ledger.write(float(len(pages)))
        return ids

    def free(self, page_ids: Iterable[int]) -> None:
        """Drop pages from the store; unknown ids raise ``KeyError``.

        Silently ignoring unknown ids would hide double-free bugs in
        operators, so misuse fails loudly instead.
        """
        ids = list(page_ids)
        missing = [i for i in ids if i not in self._store]
        if missing:
            raise KeyError(
                f"cannot free page ids not resident on {self.tier.name!r}: "
                f"{missing} (double free or wrong tier?)"
            )
        for i in ids:
            del self._store[i]

    # -- reporting ------------------------------------------------------------

    def latency_seconds(
        self, prefetch: bool = False, overlap_migration: bool = False
    ) -> float:
        return self.ledger.latency_seconds(
            self.tier, prefetch=prefetch, overlap_migration=overlap_migration
        )

    def latency_cost(self) -> float:
        return self.ledger.latency_cost(self.tier.tau_pages)

    def reset_accounting(self) -> None:
        self.ledger.reset()


class MemoryHierarchy:
    """An ordered stack of remote tiers with capacities and per-tier ledgers.

    The runtime counterpart of :class:`repro_torch.core.cost_model.HierarchySpec`
    (paper Table I read as a DRAM -> RDMA -> SSD waterfall): each level owns a
    :class:`RemoteMemory` store and its :class:`TransferLedger`; page ids are
    allocated from one shared counter, so a page keeps its id as it migrates
    between tiers and a hierarchy-wide placement map resolves reads.

    Transfer semantics:

      * ``write_batch(pages, tier=t)`` routes the batch to tier ``t``,
        waterfalling overflow to lower tiers when ``t`` is at capacity — each
        tier that receives pages accounts exactly one write round.
      * ``read_batch(ids)`` resolves each page's tier from placement; each
        tier touched accounts exactly one read round.
      * ``migrate(ids, dst)`` moves a batch between tiers in *migration
        rounds*: every adjacent-tier hop is one read round on the ledger it
        leaves and one write round on the ledger it enters (one round on each
        ledger it crosses).

    A single-tier hierarchy therefore reproduces a bare :class:`RemoteMemory`
    ledger exactly: every batch lands on the only tier in one round.
    """

    is_hierarchy = True  # structural marker (avoids import cycles in engine)

    def __init__(self, spec: HierarchySpec):
        self.spec = spec
        self._alloc = itertools.count()
        self.tiers: List[RemoteMemory] = [
            RemoteMemory(lv.tier, _alloc=self._alloc) for lv in spec.levels
        ]
        self._placement: Dict[int, int] = {}
        # Page access recency (one tick per batched access, shared across
        # tiers): the substrate eviction policies rank victims by.  Migration
        # is not an access — a demoted page keeps its coldness.
        self._access_clock = 0
        self._access: Dict[int, int] = {}
        # Pluggable eviction hook (see repro_torch.engine.eviction.Evictor): when
        # set, write_batch asks it to make room on the target tier by
        # demoting cold pages *before* waterfalling new pages downward.
        self.evictor = None

    # -- resolution ----------------------------------------------------------

    def tier_index(self, tier: Union[int, str, None]) -> int:
        return 0 if tier is None else self.spec.index(tier)

    def tier(self, tier: Union[int, str]) -> RemoteMemory:
        return self.tiers[self.spec.index(tier)]

    def tier_of(self, page_id: int) -> str:
        """The tier name currently holding ``page_id``."""
        try:
            return self.spec.names[self._placement[page_id]]
        except KeyError:
            raise KeyError(f"page {page_id} is not resident in the hierarchy") from None

    @property
    def pages_resident(self) -> int:
        return sum(rm.pages_resident for rm in self.tiers)

    def tier_resident(self, tier: Union[int, str]) -> int:
        return self.tier(tier).pages_resident

    def capacity_left(self, tier: Union[int, str]) -> float:
        idx = self.spec.index(tier)
        return self.spec.levels[idx].capacity_pages - self.tiers[idx].pages_resident

    # -- access recency (eviction policy substrate) --------------------------

    def _touch(self, page_ids: Sequence[int]) -> None:
        """Mark a batched access: one clock tick shared by the whole batch."""
        self._access_clock += 1
        for i in page_ids:
            self._access[i] = self._access_clock

    @property
    def access_clock(self) -> int:
        return self._access_clock

    def last_access(self, page_id: int) -> int:
        """Clock tick of the page's last access (0 = never accessed)."""
        return self._access.get(page_id, 0)

    def is_resident(self, page_id: int) -> bool:
        """Whether the page is currently held by any tier."""
        return page_id in self._placement

    def pages_on(self, tier: Union[int, str]) -> List[int]:
        """Resident page ids on a tier, in stable (allocation) order."""
        idx = self.spec.index(tier)
        return sorted(i for i, t in self._placement.items() if t == idx)

    def resident_ids(self) -> List[int]:
        """All resident page ids hierarchy-wide, in allocation order.

        The multi-tenant server diffs this around each task execution to
        attribute page ownership per tenant.
        """
        return sorted(self._placement)

    # -- allocation (no accounting) ------------------------------------------

    def put_local(
        self, pages: Sequence[np.ndarray], tier: Union[int, str, None] = None
    ) -> List[int]:
        """Seed pages on a tier without accounting; default: the bottom tier.

        Seeding models data already resident before the operator runs (input
        relations), so it defaults to the capacity-rich backstop tier and
        leaves upper tiers free for spill placement.  Capacities hold here
        too: overflow waterfalls to lower tiers (no transfer rounds — the
        data never moved), so occupancy can never exceed what the closed
        forms (``tiered_split``/``waterfall_io``) assume.
        """
        idx = len(self.tiers) - 1 if tier is None else self.spec.index(tier)
        ids: List[int] = []
        remaining = list(pages)
        while remaining:
            if idx >= len(self.tiers):
                raise RuntimeError(
                    f"hierarchy full: {len(remaining)} seeded pages overflow "
                    f"the bottom tier {self.spec.names[-1]!r}"
                )
            free = self.spec.levels[idx].capacity_pages - self.tiers[idx].pages_resident
            take = len(remaining) if math.isinf(free) else min(len(remaining), max(int(free), 0))
            if take > 0:
                chunk_ids = self.tiers[idx].put_local(remaining[:take])
                for i in chunk_ids:
                    self._placement[i] = idx
                ids.extend(chunk_ids)
                remaining = remaining[take:]
            idx += 1
        self._touch(ids)
        return ids

    def peek_batch(self, page_ids: Sequence[int]) -> List[np.ndarray]:
        """Oracle-side reads without accounting (no transfer round)."""
        return [
            self.tiers[self._placement[i]]._store[i] for i in page_ids
        ]

    def free(self, page_ids: Iterable[int]) -> None:
        """Drop pages wherever they reside; unknown ids raise ``KeyError``."""
        ids = list(page_ids)
        missing = [i for i in ids if i not in self._placement]
        if missing:
            raise KeyError(
                f"cannot free page ids not resident in the hierarchy: {missing}"
            )
        for i in ids:
            self.tiers[self._placement.pop(i)].free([i])
            self._access.pop(i, None)

    # -- batched transfer rounds ---------------------------------------------

    def read_batch(
        self, page_ids: Sequence[int], prefetched: bool = False
    ) -> List[np.ndarray]:
        """One swap-in round per tier the batch touches, placement-resolved."""
        if not len(page_ids):
            return []
        by_tier: Dict[int, List[int]] = {}
        for i in page_ids:
            if i not in self._placement:
                raise KeyError(f"page {i} is not resident in the hierarchy")
            by_tier.setdefault(self._placement[i], []).append(i)
        fetched: Dict[int, np.ndarray] = {}
        for idx in sorted(by_tier):
            ids = by_tier[idx]
            for i, page in zip(ids, self.tiers[idx].read_batch(ids, prefetched)):
                fetched[i] = page
        self._touch(list(page_ids))
        return [fetched[i] for i in page_ids]

    def write_batch(
        self, pages: Sequence[np.ndarray], tier: Union[int, str, None] = None
    ) -> List[int]:
        """One flush-out round per tier receiving pages, waterfalling overflow.

        The batch targets ``tier`` (default: the top tier); pages beyond the
        target's remaining capacity cascade to the next tier down, each
        receiving tier accounting exactly one write round for its share.
        With an :attr:`evictor` attached, the evictor first demotes cold
        pages off the target tier (background migration rounds), so the hot
        batch lands on its target instead of waterfalling; any residual
        overflow still cascades as before.
        """
        if not len(pages):
            return []
        idx = self.tier_index(tier)
        if self.evictor is not None:
            self.evictor.make_room(idx, len(pages))
        ids: List[int] = []
        remaining = list(pages)
        while remaining:
            if idx >= len(self.tiers):
                raise RuntimeError(
                    f"hierarchy full: {len(remaining)} pages overflow the "
                    f"bottom tier {self.spec.names[-1]!r}"
                )
            free = self.spec.levels[idx].capacity_pages - self.tiers[idx].pages_resident
            take = len(remaining) if math.isinf(free) else min(len(remaining), max(int(free), 0))
            if take > 0:
                chunk_ids = self.tiers[idx].write_batch(remaining[:take])
                for i in chunk_ids:
                    self._placement[i] = idx
                ids.extend(chunk_ids)
                remaining = remaining[take:]
            idx += 1
        self._touch(ids)
        if self.evictor is not None:
            self.evictor.maintain()
        return ids

    # -- migration rounds ----------------------------------------------------

    def migrate(
        self,
        page_ids: Sequence[int],
        dst: Union[int, str],
        background: bool = False,
    ) -> None:
        """Move a batch to ``dst`` in adjacent-tier migration rounds.

        Pages keep their ids.  Every adjacent hop is one read round on the
        ledger it leaves and one write round on the ledger it enters, so a
        two-level demotion crosses three ledgers with the middle one charged
        on both sides.  The destination must have room for the whole batch
        (pass-through tiers need none); short batches raise ``ValueError``.

        ``background=True`` models migration overlapped with operator
        compute (§IV-E applied to demotion): every round of every hop is
        additionally recorded in that ledger's ``c_migration_hidden``, so
        ``latency_seconds(overlap_migration=True)`` charges it no RTT.  The
        volume term still pays in full, and migration never refreshes page
        recency — a demoted page stays as cold as it was.
        """
        if not len(page_ids):
            return
        dst_idx = self.spec.index(dst)
        by_tier: Dict[int, List[int]] = {}
        for i in page_ids:
            if i not in self._placement:
                raise KeyError(f"page {i} is not resident in the hierarchy")
            by_tier.setdefault(self._placement[i], []).append(i)
        incoming = sum(len(v) for t, v in by_tier.items() if t != dst_idx)
        free = self.capacity_left(dst_idx)
        if not math.isinf(free) and incoming > free:
            raise ValueError(
                f"tier {self.spec.names[dst_idx]!r} cannot hold {incoming} "
                f"migrated pages (capacity left: {free})"
            )
        for src_idx in sorted(by_tier):
            if src_idx == dst_idx:
                continue
            ids = by_tier[src_idx]
            step = 1 if dst_idx > src_idx else -1
            cur = src_idx
            while cur != dst_idx:
                nxt = cur + step
                src_rm, dst_rm = self.tiers[cur], self.tiers[nxt]
                pages = [src_rm._store[i] for i in ids]
                src_rm.ledger.read(float(len(ids)))  # one round leaving `cur`
                dst_rm.ledger.write(float(len(ids)))  # one round entering `nxt`
                if background:
                    src_rm.ledger.c_migration_hidden += 1
                    dst_rm.ledger.c_migration_hidden += 1
                for i, page in zip(ids, pages):
                    del src_rm._store[i]
                    dst_rm._store[i] = page
                    self._placement[i] = nxt
                cur = nxt

    # -- operator pushdown (compute-capable tiers) ---------------------------

    def _pushdown_level(self, tier: Union[int, str], op: str):
        """Resolve + capability-check a tier for pushdown op ``op``."""
        idx = self.spec.index(tier)
        level = self.spec.levels[idx]
        if not level.can_push(op):
            raise ValueError(
                f"tier {self.spec.names[idx]!r} cannot execute pushdown op "
                f"{op!r} (compute_pps={level.compute_pps}, "
                f"pushdown_ops={sorted(level.pushdown_ops)})"
            )
        return idx, level

    def _resident_on(self, idx: int, page_ids: Sequence[int]) -> None:
        stray = [i for i in page_ids if self._placement.get(i) != idx]
        if stray:
            raise ValueError(
                f"pushdown needs every page resident on tier "
                f"{self.spec.names[idx]!r}; not there: {stray[:8]}"
                f"{'...' if len(stray) > 8 else ''}"
            )

    def scan_filtered(
        self,
        tier: Union[int, str],
        page_ids: Sequence[int],
        selectivity: Optional[float] = None,
        predicate=None,
        keep_ids: Optional[Iterable[int]] = None,
        batch_pages: Optional[int] = None,
    ) -> Tuple[List[int], List[np.ndarray]]:
        """Execute a filter *at* a compute-capable tier; ship only survivors.

        Every page in ``page_ids`` must be resident on ``tier`` and the tier
        must be capable of the ``"filter"`` op (non-capable tiers raise).
        The selection is one of: a scalar ``selectivity`` applied with the
        deterministic positional rule (:func:`pushdown_keep`, positions
        within ``page_ids``), a ``predicate(page) -> bool``, or an explicit
        ``keep_ids`` set (the placement-aware scheduler fallback uses this to
        preserve a globally consistent keep decision across tiers).

        Accounting: every ``batch_pages`` chunk (default: all pages, one
        round) is one pushdown request round — ``c_read``/``c_pushdown`` +1,
        ``d_read``/``d_pushdown`` += survivors shipped, ``d_pushdown_saved``
        += pages scanned at the tier but never shipped.  All scanned pages
        count as accessed (the tier touched them).
        """
        modes = sum(x is not None for x in (selectivity, predicate, keep_ids))
        if modes != 1:
            raise ValueError(
                "scan_filtered needs exactly one of selectivity=, "
                "predicate=, keep_ids="
            )
        idx, _level = self._pushdown_level(tier, "filter")
        ids = [int(i) for i in page_ids]
        if not ids:
            return [], []
        self._resident_on(idx, ids)
        if selectivity is not None:
            sel = _check_selectivity(selectivity)
        keep_set = None if keep_ids is None else frozenset(int(i) for i in keep_ids)
        batch = len(ids) if batch_pages is None else int(batch_pages)
        if batch <= 0:
            raise ValueError(f"batch_pages must be > 0, got {batch_pages}")
        rm = self.tiers[idx]
        kept_ids: List[int] = []
        kept_pages: List[np.ndarray] = []
        for start in range(0, len(ids), batch):
            chunk = ids[start : start + batch]
            if predicate is not None:
                kept = [i for i in chunk if predicate(rm._store[i])]
            elif keep_set is not None:
                kept = [i for i in chunk if i in keep_set]
            else:
                kept = [
                    i for pos, i in enumerate(chunk, start=start)
                    if pushdown_keep(pos, sel)
                ]
            rm.ledger.pushdown(
                shipped=float(len(kept)), saved=float(len(chunk) - len(kept))
            )
            kept_ids.extend(kept)
            kept_pages.extend(rm._store[i] for i in kept)
        self._touch(ids)
        return kept_ids, kept_pages

    def read_reduced(
        self,
        tier: Union[int, str],
        page_ids: Sequence[int],
        reducer,
        rows_per_page: int,
    ) -> List[np.ndarray]:
        """Execute a partial reduction *at* a compute-capable tier.

        ``reducer(pages) -> rows`` runs over the resident pages at the tier
        (all of ``page_ids`` must live on ``tier``, which must be capable of
        the ``"reduce"`` op); the result rows are packed into
        ``rows_per_page``-row pages and shipped back in **one** pushdown
        round — ``ceil(rows / rows_per_page)`` result pages of ``d_read``
        instead of ``len(page_ids)`` raw ones.  The shipped arrays are
        materialized results, not store pages (the caller owns them).
        """
        idx, _level = self._pushdown_level(tier, "reduce")
        ids = [int(i) for i in page_ids]
        if not ids:
            return []
        if rows_per_page <= 0:
            raise ValueError(f"rows_per_page must be > 0, got {rows_per_page}")
        self._resident_on(idx, ids)
        rm = self.tiers[idx]
        rows = np.asarray(reducer([rm._store[i] for i in ids]))
        out = [
            rows[start : start + rows_per_page]
            for start in range(0, len(rows), rows_per_page)
        ]
        rm.ledger.pushdown(
            shipped=float(len(out)),
            saved=float(max(len(ids) - len(out), 0)),
        )
        self._touch(ids)
        return out

    def demote(self, page_ids: Sequence[int], background: bool = False) -> None:
        """Migrate a batch one tier down (all pages must share a tier)."""
        self._hop(page_ids, +1, background=background)

    def promote(self, page_ids: Sequence[int], background: bool = False) -> None:
        """Migrate a batch one tier up (all pages must share a tier)."""
        self._hop(page_ids, -1, background=background)

    def _hop(
        self, page_ids: Sequence[int], step: int, background: bool = False
    ) -> None:
        if not len(page_ids):
            return
        tiers = {self._placement.get(i) for i in page_ids}
        if None in tiers or len(tiers) != 1:
            raise ValueError(
                "demote/promote needs a batch resident on one tier; got "
                f"placements {sorted('?' if t is None else self.spec.names[t] for t in tiers)}"
            )
        (src_idx,) = tiers
        dst_idx = src_idx + step
        if not 0 <= dst_idx < len(self.tiers):
            raise ValueError(
                f"cannot move {'down' if step > 0 else 'up'} from "
                f"{'bottom' if step > 0 else 'top'} tier {self.spec.names[src_idx]!r}"
            )
        self.migrate(page_ids, dst_idx, background=background)

    # -- reporting ------------------------------------------------------------

    def snapshot(self) -> HierarchySnapshot:
        return HierarchySnapshot(tiers=tuple(
            (name, rm.ledger.snapshot())
            for name, rm in zip(self.spec.names, self.tiers)
        ))

    def delta(self, since: HierarchySnapshot) -> HierarchySnapshot:
        return HierarchySnapshot(tiers=tuple(
            (name, rm.ledger.delta(since.tier(name)))
            for name, rm in zip(self.spec.names, self.tiers)
        ))

    def latency_seconds(
        self, prefetch: bool = False, overlap_migration: bool = False
    ) -> float:
        """Eq. (1) summed over tiers, each with its own (BW, RTT).

        Compute-capable tiers additionally pay their pushdown-scanned pages'
        processing time (``d_pushdown_scanned / compute_pps``).
        """
        return sum(
            rm.ledger.latency_seconds(
                rm.tier, prefetch=prefetch,
                overlap_migration=overlap_migration,
                compute_pps=lv.compute_pps,
            )
            for rm, lv in zip(self.tiers, self.spec.levels)
        )

    def latency_cost(self) -> float:
        """Hierarchy-wide L: per-tier D + tau_t * C summed over tiers.

        Pushdown-scanned pages on compute-capable tiers are priced at that
        tier's ``compute_tau_pages`` each (tier compute in L units).
        """
        total = 0.0
        for rm, lv in zip(self.tiers, self.spec.levels):
            total += rm.latency_cost()
            scanned = rm.ledger.d_pushdown_scanned
            if scanned > 0:
                total += lv.compute_tau_pages * scanned
        return total

    def reset_accounting(self) -> None:
        for rm in self.tiers:
            rm.reset_accounting()


def make_hierarchy(
    *levels: Union[TierSpec, str, Tuple[Union[TierSpec, str], float]],
) -> MemoryHierarchy:
    """Build a :class:`MemoryHierarchy` from tier / ``(tier, cap)`` levels.

    Tiers are ``TierSpec``\\ s or names from Table I / TESTBED,
    e.g. ``make_hierarchy(("dram", 64), ("rdma", 1024), "ssd")``.
    """
    from repro_torch.core.cost_model import hierarchy_spec

    return MemoryHierarchy(hierarchy_spec(*levels))


@dataclasses.dataclass
class Relation:
    """A paged relation: `pages[i]` is a page id; tuples are (key, payload)."""

    page_ids: List[int]
    rows_per_page: int
    total_rows: int

    def __len__(self) -> int:
        return len(self.page_ids)


def as_relation(remote, value, rows_per_page: Optional[int] = None) -> Relation:
    """Coerce ``value`` (a ``Relation`` or a page-id list) into a ``Relation``.

    Session task DAGs chain operators by page-id lists — a ``TaskOutput``
    resolves to the upstream operator's flushed output pages — while the
    relational operators (BNLJ/EHJ/EAGG) take ``Relation`` inputs.  Row
    geometry is recovered by peeking the pages oracle-side: bookkeeping,
    not a transfer round, so ledgers are unaffected.
    """
    if isinstance(value, Relation):
        return value
    ids = [int(p) for p in value]
    if not ids:
        return Relation(page_ids=[], rows_per_page=rows_per_page or 1, total_rows=0)
    pages = remote.peek_batch(ids)
    total = int(sum(len(p) for p in pages))
    rpp = rows_per_page or max(len(p) for p in pages)
    return Relation(page_ids=ids, rows_per_page=int(rpp), total_rows=total)


def _seed_pages(remote, pages, tier) -> List[int]:
    """Route seeding to a tier when asked (hierarchies only)."""
    if tier is None:
        return remote.put_local(pages)
    if not getattr(remote, "is_hierarchy", False):
        raise ValueError(
            f"tier={tier!r} seeding needs a MemoryHierarchy target; a single "
            f"tier has no placement choice"
        )
    return remote.put_local(pages, tier=tier)


def make_relation(
    remote: RemoteMemory,
    n_rows: int,
    rows_per_page: int,
    key_domain: int,
    payload_width: int = 1,
    seed: int = 0,
    sorted_keys: bool = False,
    tier: Union[int, str, None] = None,
) -> Relation:
    """Materialize a synthetic relation in remote memory (§V-A b workloads).

    Keys are drawn uniformly from [0, key_domain); join selectivity between two
    such relations is ~1/key_domain per tuple pair, matching the paper's
    key-domain-controlled selectivity.

    ``tier`` places the relation on a specific hierarchy tier (a *hot* cached
    table already resident on DRAM/RDMA); the default is the capacity-rich
    bottom tier, the cold-base-table convention of ``put_local``.
    """
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_domain, size=n_rows, dtype=np.int64)
    if sorted_keys:
        keys = np.sort(keys)
    payload = np.arange(n_rows, dtype=np.int64)[:, None] * np.ones(
        (1, payload_width), dtype=np.int64
    )
    pages = []
    for start in range(0, n_rows, rows_per_page):
        sl = slice(start, min(start + rows_per_page, n_rows))
        pages.append(np.concatenate([keys[sl, None], payload[sl]], axis=1))
    ids = _seed_pages(remote, pages, tier)
    return Relation(page_ids=ids, rows_per_page=rows_per_page, total_rows=n_rows)


def make_key_pages(
    remote: RemoteMemory,
    n_pages: int,
    rows_per_page: int,
    key_domain: int = 1 << 30,
    seed: int = 0,
    tier: Union[int, str, None] = None,
) -> List[int]:
    """Key-only pages (1-D int64) for sort workloads (§V-B b)."""
    rng = np.random.default_rng(seed)
    pages = [
        rng.integers(0, key_domain, size=rows_per_page, dtype=np.int64)
        for _ in range(n_pages)
    ]
    return _seed_pages(remote, pages, tier)


def load_pages(
    remote: RemoteMemory,
    pages: Sequence[np.ndarray],
    tier: Union[int, str, None] = None,
) -> List[int]:
    """Seed numpy pages taken from another store (its ``peek_batch``).

    The pages are copied and seeded in order, without accounting, exactly as
    the generators above seed theirs: on a fresh store they receive the same
    page ids, and with the same ``tier`` the same placement, as they had in
    the store they were seeded into first.  This is how state carries over
    from the JAX package's stores into the port.
    """
    return _seed_pages(remote, [np.array(p, copy=True) for p in pages], tier)


def relation_rows(remote: RemoteMemory, rel: Relation) -> np.ndarray:
    """Oracle-side full materialization (no accounting): rows as one array."""
    return np.concatenate(remote.peek_batch(rel.page_ids), axis=0)
