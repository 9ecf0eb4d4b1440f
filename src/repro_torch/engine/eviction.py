"""Proactive eviction: demote cold pages to keep fast-tier headroom.

Without an evictor, :class:`repro_torch.remote.simulator.MemoryHierarchy` only *waterfalls* on
overflow: when a spill stream outgrows its target tier, the *new* (hot) pages
cascade to slower tiers and pay those tiers' rounds synchronously — the worst
pages go to the worst place at the worst time.  The eviction subsystem
inverts that: an :class:`Evictor` attached to the hierarchy demotes *cold*
pages out of the way in **background migration rounds** (RTT hidden via
``c_migration_hidden``, the §IV-E prefetch model applied to demotion), so hot
spill streams land — and are re-read — on the fast tier.

Three policies over the recency the hierarchy tracks per page:

``LRUPolicy``
  Coldest-first by last batched access (writes and reads tick a shared
  clock; migration never refreshes recency).

``ClockPolicy``
  Second-chance clock: a circular hand sweeps resident pages; a page
  accessed since the hand last passed is spared once, otherwise evicted.

``DeadAfterFlushPolicy``
  Spill-stream aware: :class:`repro_torch.engine.buffers.BufferPool` hints when a
  stream is fully flushed, marking its pages *dead* — complete, not being
  appended to, and not read since the flush.  Dead pages are first-choice
  victims; anything else falls back to LRU order.  A page read after its
  flush hint sheds the dead mark (recency moved past the hint).

The :class:`Evictor` is the mechanism: ``make_room(tier, need)`` runs before
every hierarchy write, demoting one victim batch per overflowing write (and
recursively making room below), so the write's own pages never cascade while
cold pages exist above.  The closed-form counterpart is
:func:`repro_torch.core.policies.eviction_waterfall_io`.
"""

from __future__ import annotations

import math
from typing import (
    Dict,
    FrozenSet,
    Hashable,
    List,
    Optional,
    Protocol,
    Sequence,
    Union,
    runtime_checkable,
)


@runtime_checkable
class EvictionPolicy(Protocol):
    """Victim selection over one hierarchy tier's resident pages."""

    name: str

    def victims(self, hierarchy, tier_index: int, n_pages: int) -> List[int]:
        """Up to ``n_pages`` page ids resident on ``tier_index``, coldest
        first.  May return fewer (nothing evictable); never pages from
        another tier."""
        ...

    def stream_flushed(self, hierarchy, page_ids: Sequence[int]) -> None:
        """Hint: a spill stream owning ``page_ids`` is fully flushed."""
        ...


class LRUPolicy:
    """Least-recently-used: rank by the hierarchy's batched access clock."""

    name = "lru"

    def victims(self, hierarchy, tier_index: int, n_pages: int) -> List[int]:
        if n_pages <= 0:
            return []
        resident = hierarchy.pages_on(tier_index)
        resident.sort(key=lambda i: (hierarchy.last_access(i), i))
        return resident[:n_pages]

    def stream_flushed(self, hierarchy, page_ids: Sequence[int]) -> None:
        pass


class ClockPolicy:
    """Second-chance clock over page access recency.

    The hand sweeps resident page ids in circular order; a page whose last
    access is newer than when the hand last passed it gets a second chance
    (its reference state refreshes), otherwise it is evicted.  Equivalent to
    the classic one-bit clock with the hierarchy's access clock standing in
    for the reference bit.
    """

    name = "clock"

    def __init__(self) -> None:
        self._seen: Dict[int, int] = {}
        self._hand: int = -1

    def victims(self, hierarchy, tier_index: int, n_pages: int) -> List[int]:
        if n_pages <= 0:
            return []
        # Drop sweep state for pages freed since the last call, so the
        # dict tracks live pages rather than every id ever seen.
        self._seen = {
            i: v for i, v in self._seen.items() if hierarchy.is_resident(i)
        }
        resident = hierarchy.pages_on(tier_index)
        if not resident:
            return []
        # Rotate so the sweep resumes just past the hand's last position.
        start = 0
        for pos, i in enumerate(resident):
            if i > self._hand:
                start = pos
                break
        order = resident[start:] + resident[:start]
        chosen: List[int] = []
        # Two full sweeps suffice: the first clears every reference, the
        # second must find victims.
        for i in order * 2:
            if len(chosen) >= n_pages:
                break
            if i in chosen:
                continue
            last = hierarchy.last_access(i)
            if last > self._seen.get(i, -1):
                self._seen[i] = last  # second chance: clear the reference
            else:
                chosen.append(i)
            self._hand = i
        return chosen

    def stream_flushed(self, hierarchy, page_ids: Sequence[int]) -> None:
        pass


class DeadAfterFlushPolicy:
    """Prefer pages of fully-flushed spill streams; fall back to LRU.

    ``BufferPool`` reports each stream's pages when the stream is force-
    flushed (complete); those pages are dead weight on the fast tier until
    something reads them again — a read after the hint revives the page.
    """

    name = "dead"

    def __init__(self, fallback: Optional[EvictionPolicy] = None) -> None:
        # flush-time access clock per hinted page: dead iff not read since.
        self._flushed_at: Dict[int, int] = {}
        self._fallback = fallback or LRUPolicy()

    def victims(self, hierarchy, tier_index: int, n_pages: int) -> List[int]:
        if n_pages <= 0:
            return []
        # Forget hints for pages freed since the last call (bounds the dict
        # by live pages, not pages ever hinted).
        self._flushed_at = {
            i: v for i, v in self._flushed_at.items()
            if hierarchy.is_resident(i)
        }
        dead = [
            i for i in hierarchy.pages_on(tier_index)
            if i in self._flushed_at
            and hierarchy.last_access(i) <= self._flushed_at[i]
        ]
        dead.sort(key=lambda i: (hierarchy.last_access(i), i))
        chosen = dead[:n_pages]
        if len(chosen) < n_pages:
            taken = set(chosen)
            for i in self._fallback.victims(hierarchy, tier_index, n_pages):
                if i not in taken:
                    chosen.append(i)
                    if len(chosen) >= n_pages:
                        break
        return chosen

    def stream_flushed(self, hierarchy, page_ids: Sequence[int]) -> None:
        clock = hierarchy.access_clock
        for i in page_ids:
            self._flushed_at[i] = clock


_POLICIES = {
    "lru": LRUPolicy,
    "clock": ClockPolicy,
    "dead": DeadAfterFlushPolicy,
}


def make_policy(policy: Union[str, EvictionPolicy]) -> EvictionPolicy:
    """Resolve a policy name (``lru``/``clock``/``dead``) or pass through."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown eviction policy {policy!r}; "
                f"known: {sorted(_POLICIES)}"
            ) from None
    if not isinstance(policy, EvictionPolicy):
        raise TypeError(
            f"eviction policy must be a name or an EvictionPolicy, "
            f"got {type(policy).__name__}"
        )
    return policy


class Evictor:
    """Background demotion engine attached to one :class:`MemoryHierarchy`.

    ``make_room(tier, need)`` runs before every hierarchy write targeting
    ``tier``: while the tier lacks ``need`` free pages, the policy's coldest
    victims are demoted one tier down as **one background migration batch**
    (recursively making room below first), so the incoming hot batch lands on
    its target.  ``headroom`` additionally keeps that many pages free on
    every non-bottom tier after each write (``maintain``), pre-paying
    demotions before the next burst instead of on its critical path.

    ``overlap=True`` (the default) issues demotions as background migrations:
    their rounds are recorded in ``c_migration_hidden`` and pay no RTT under
    ``latency_seconds(overlap_migration=True)``.  Counters ``pages_demoted``
    and ``demote_batches`` expose the measured eviction effort (each batch is
    one migration round on each ledger it crosses).

    ``promote`` enables the inverse flow for *re-hot* pages: each
    ``maintain`` sweep moves up to that many pages per tier — pages a slower
    tier holds that have been accessed more recently than the coldest
    resident of the tier above — one tier up as one background migration
    batch (same ``c_migration_hidden`` accounting as demotion).  Promotion
    makes room above through the same scan-resistant victim selection, so it
    can never evict a page an active scan window protects.  Counters
    ``pages_promoted`` and ``promote_batches`` expose the effort.
    """

    def __init__(
        self,
        hierarchy,
        policy: Union[str, EvictionPolicy] = "lru",
        *,
        overlap: bool = True,
        headroom: float = 0.0,
        promote: float = 0.0,
    ) -> None:
        if not getattr(hierarchy, "is_hierarchy", False):
            raise ValueError(
                "an Evictor needs a MemoryHierarchy; single-tier stores "
                "have nowhere to demote to"
            )
        if headroom < 0:
            raise ValueError(f"headroom must be >= 0 pages, got {headroom}")
        if promote < 0:
            raise ValueError(f"promote must be >= 0 pages, got {promote}")
        self.hierarchy = hierarchy
        self.policy = make_policy(policy)
        self.overlap = bool(overlap)
        self.headroom = float(headroom)
        self.promote = float(promote)
        self.pages_demoted = 0
        self.demote_batches = 0
        self.scan_spared = 0
        self.pages_promoted = 0
        self.promote_batches = 0
        # Active sequential-scan windows, keyed per cursor: pages a consumer
        # is about to read.  Victim selection skips them (scan resistance).
        self._scan_windows: Dict[Hashable, FrozenSet[int]] = {}

    def counters(self) -> Dict[str, int]:
        """Measured eviction effort so far (monotone)."""
        return {
            "pages_demoted": self.pages_demoted,
            "demote_batches": self.demote_batches,
            "scan_spared": self.scan_spared,
            "pages_promoted": self.pages_promoted,
            "promote_batches": self.promote_batches,
        }

    # -- scan resistance -----------------------------------------------------

    def scan_hint(self, key: Hashable, page_ids: Sequence[int]) -> None:
        """Declare the pages a sequential scan (``key``) has yet to read.

        Pure LRU demotes exactly the run pages an EMS merge is about to read
        next — their last access was the flush that wrote them, so they rank
        coldest right when they are hottest.  While a window is active its
        pages are skipped by victim selection; the consumer re-hints with the
        shrinking remainder after each read round and an empty window (or
        :meth:`scan_done`) lifts the protection.
        """
        ids = frozenset(int(i) for i in page_ids)
        if ids:
            self._scan_windows[key] = ids
        else:
            self._scan_windows.pop(key, None)

    def scan_done(self, key: Hashable) -> None:
        """Drop a scan window (missing keys are ignored)."""
        self._scan_windows.pop(key, None)

    def scan_pages(self) -> FrozenSet[int]:
        """Union of all active scan windows (the currently unevictable set)."""
        if not self._scan_windows:
            return frozenset()
        return frozenset().union(*self._scan_windows.values())

    def _select_victims(self, tier_index: int, deficit: int) -> List[int]:
        """Policy victims minus active scan windows, still ``deficit`` deep.

        Asks the policy for enough extra candidates to cover the protected
        pages it may rank first, so sparing a scan never shrinks the demotion
        batch while colder unprotected pages exist.
        """
        protected = self.scan_pages()
        if not protected:
            return self.policy.victims(self.hierarchy, tier_index, deficit)
        on_tier = self.hierarchy.pages_on(tier_index)
        n_protected = sum(1 for i in on_tier if i in protected)
        ranked = self.policy.victims(
            self.hierarchy, tier_index, deficit + n_protected
        )
        victims = [i for i in ranked if i not in protected][:deficit]
        self.scan_spared += sum(1 for i in ranked[:deficit] if i in protected)
        return victims

    def make_room(self, tier_index: int, need: float) -> None:
        """Demote cold victims until ``tier_index`` has ``need`` free pages.

        The bottom tier is the backstop (nothing below to demote to); a
        policy that returns no victims leaves the residual overflow to the
        hierarchy's normal waterfall.
        """
        h = self.hierarchy
        if tier_index >= len(h.tiers) - 1:
            return
        free = h.capacity_left(tier_index)
        if math.isinf(free) or free >= need:
            return
        deficit = int(math.ceil(need - free))
        victims = self._select_victims(tier_index, deficit)
        if not victims:
            return
        self.make_room(tier_index + 1, len(victims))
        room_below = h.capacity_left(tier_index + 1)
        if not math.isinf(room_below):
            # The tier below could not clear enough (no victims of its own):
            # demote only what fits; the residual overflow waterfalls.
            victims = victims[: max(int(room_below), 0)]
        if not victims:
            return
        h.demote(victims, background=self.overlap)
        self.pages_demoted += len(victims)
        self.demote_batches += 1

    def maintain(self) -> None:
        """Restore ``headroom`` free pages on every non-bottom tier, then
        promote re-hot pages back up (when ``promote`` is enabled)."""
        if self.headroom > 0:
            for t in range(len(self.hierarchy.tiers) - 1):
                self.make_room(t, self.headroom)
        self.promote_hot()

    # -- re-hot promotion ----------------------------------------------------

    def _promote_candidates(self, tier_index: int, limit: int) -> List[int]:
        """Hottest pages on ``tier_index`` that outrank the tier above.

        A page qualifies when its last batched access is strictly newer than
        the coldest resident of the tier above (swapping the two improves
        recency locality); on an empty upper tier, any accessed page does.
        """
        h = self.hierarchy
        below = h.pages_on(tier_index)
        if not below:
            return []
        above = h.pages_on(tier_index - 1)
        floor = min((h.last_access(i) for i in above), default=0)
        hot = [i for i in below if h.last_access(i) > floor]
        hot.sort(key=lambda i: (-h.last_access(i), i))
        return hot[:limit]

    def promote_hot(self) -> None:
        """One promotion sweep: re-hot pages move one tier up per call.

        Room above is made through :meth:`make_room` — the same
        scan-resistant victim selection as demotion — so a promotion can
        displace cold pages but never a scan-protected one; when the upper
        tier cannot clear enough space the batch is truncated to what fits.
        """
        if self.promote <= 0:
            return
        h = self.hierarchy
        for t in range(len(h.tiers) - 1, 0, -1):
            batch = self._promote_candidates(t, int(self.promote))
            if not batch:
                continue
            self.make_room(t - 1, len(batch))
            # Room-making may itself have cascaded demotions through tier
            # ``t`` (clock/dead policies don't rank by recency), displacing
            # some candidates: promote only pages still resident here.
            batch = [i for i in batch
                     if h.is_resident(i) and h.tier_of(i) == h.spec.names[t]]
            free = h.capacity_left(t - 1)
            if not math.isinf(free):
                batch = batch[: max(int(free), 0)]
            if not batch:
                continue
            h.promote(batch, background=self.overlap)
            self.pages_promoted += len(batch)
            self.promote_batches += 1

    def stream_flushed(self, page_ids: Sequence[int]) -> None:
        """Forward a BufferPool fully-flushed-stream hint to the policy."""
        self.policy.stream_flushed(self.hierarchy, page_ids)
