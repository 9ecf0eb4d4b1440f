"""Transfer scheduler: the tier router owning all round accounting.

Every batched read/write an operator issues flows through one
:class:`TransferScheduler`, which

  * routes it to its target — a single
    :class:`repro_torch.remote.simulator.RemoteMemory` tier or a whole
    :class:`repro_torch.remote.simulator.MemoryHierarchy` — as exactly one transfer
    round per tier touched (Definition 2).  On a hierarchy, writes name a
    tier (falling back to the scheduler's default placement) and reads
    resolve each page's tier from the hierarchy's placement map,
  * records §IV-E prefetch hiding in one place: a round issued with
    ``prefetch=True`` models the double buffer fetching one batch ahead, so
    its RTT is hidden (``ledger.c_prefetch_hidden``).  Stream consumers
    (:class:`repro_torch.engine.buffers.PageCursor`) enforce the rule that a
    stream's *first* round is never marked,
  * exposes ledger ``snapshot()`` / ``delta()`` so callers report per-region
    D/C counts without copying the mutable ledger — a
    :class:`repro_torch.core.cost_model.LedgerSnapshot` for a single tier, a
    :class:`repro_torch.core.cost_model.HierarchySnapshot` (per-tier ledgers that
    sum to the hierarchy-wide D/C) for a hierarchy, and
  * can *coalesce* adjacent read batches into fewer rounds
    (:meth:`read_coalesced`) when a caller trades buffer space for rounds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import HierarchySnapshot, LedgerSnapshot, TransferLedger

Snapshot = Union[LedgerSnapshot, HierarchySnapshot]

TierSpec = Union[int, str, None]


def stream_tiers(
    tier: Union[TierSpec, Dict[str, TierSpec], Sequence[TierSpec]],
    streams: Sequence[str],
) -> Dict[str, TierSpec]:
    """Normalize an operator ``tier=`` spec into a ``{stream: tier}`` map.

    Operators declare their spill streams (``OperatorSpec.streams``) and
    accept ``tier=`` as either

      * a scalar (index / name / ``None``) — every stream on that tier, the
        pre-fractional behaviour,
      * a dict keyed by stream name — missing streams fall back to ``None``
        (the scheduler's default placement); unknown keys raise, or
      * a sequence aligned with ``streams`` — one entry per stream.

    The result always has exactly one entry per declared stream.
    """
    if isinstance(tier, dict):
        unknown = sorted(set(tier) - set(streams))
        if unknown:
            raise ValueError(
                f"unknown stream(s) {unknown} in tier spec; "
                f"operator streams are {list(streams)}"
            )
        return {s: tier.get(s) for s in streams}
    if isinstance(tier, (list, tuple)):
        if len(tier) != len(streams):
            raise ValueError(
                f"tier list has {len(tier)} entries for {len(streams)} "
                f"stream(s) {list(streams)}"
            )
        return dict(zip(streams, tier))
    return {s: tier for s in streams}


class TransferScheduler:
    """Schedules batched transfer rounds against one remote target.

    ``target`` is a single ``RemoteMemory`` tier or a ``MemoryHierarchy``;
    ``tier`` names the default placement for writes on a hierarchy (index or
    tier name; ignored for a single-tier target).  A single-tier hierarchy
    behaves exactly like the bare tier: same rounds, same ledgers.
    """

    def __init__(self, target, tier: Union[int, str, None] = None):
        self.remote = target
        self.is_hierarchy: bool = bool(getattr(target, "is_hierarchy", False))
        self.default_tier: Union[int, str, None] = tier
        self._checkpoints: Dict[str, Snapshot] = {}
        if self.is_hierarchy:
            # Resolve early so a bad placement fails at construction.
            self.default_tier = target.tier_index(tier)

    # -- ledger accounting ---------------------------------------------------

    @property
    def ledger(self) -> TransferLedger:
        """The single tier's ledger (default-placement tier on a hierarchy)."""
        if self.is_hierarchy:
            return self.remote.tiers[self.default_tier].ledger
        return self.remote.ledger

    def snapshot(self) -> Snapshot:
        if self.is_hierarchy:
            return self.remote.snapshot()
        return self.remote.ledger.snapshot()

    def delta(self, since: Snapshot) -> Snapshot:
        if self.is_hierarchy:
            return self.remote.delta(since)
        return self.remote.ledger.delta(since)

    # -- named checkpoints ---------------------------------------------------
    #
    # Per-task bookkeeping for the session executor: a checkpoint freezes the
    # ledger state under a label so the per-task delta (and a mid-pipeline
    # re-planner's "what has this task cost so far") can be read back without
    # the caller threading snapshot objects through its control flow.

    def checkpoint(self, label: str) -> Snapshot:
        """Freeze the current ledger state under ``label`` (overwriting)."""
        snap = self.snapshot()
        self._checkpoints[label] = snap
        return snap

    def restore(self, label: str) -> Snapshot:
        """Return the snapshot frozen under ``label``."""
        try:
            return self._checkpoints[label]
        except KeyError:
            raise ValueError(
                f"no checkpoint {label!r}; have {sorted(self._checkpoints)}"
            ) from None

    def since(self, label: str) -> Snapshot:
        """Ledger delta accumulated since ``checkpoint(label)``."""
        return self.delta(self.restore(label))

    def drop_checkpoint(self, label: str) -> None:
        """Forget ``label`` (missing labels are ignored)."""
        self._checkpoints.pop(label, None)

    # -- execution-backend surface -------------------------------------------
    #
    # A target may be an execution backend (repro_torch.remote.backend): pages then
    # mirror as device arrays, transfers are timed host<->device copies, and
    # operator compute can run CUDA kernels.  The scheduler routes those
    # capabilities exactly like it routes transfer rounds — operators ask the
    # scheduler, never the store — and degrades to the deterministic numpy
    # reference on simulator targets.  Nothing here reads a clock: the
    # scheduler stays on the LAY303-deterministic side of the boundary.

    @property
    def wall(self):
        """The target's measured wall clock, or ``None`` on a simulator."""
        return getattr(self.remote, "wall", None)

    def sort_keys(self, keys: np.ndarray) -> np.ndarray:
        """Sort a 1-D key block: the backend's kernel hook, else numpy.

        Both paths return byte-identical sorted keys (bare keys carry no
        payload); only wall-clock accounting differs.
        """
        fn = getattr(self.remote, "sort_keys", None)
        if fn is not None:
            return fn(keys)
        return np.sort(keys, kind="stable")

    def partitions(self, rows: np.ndarray, parts: np.ndarray):
        """Group a row block by partition id, ascending, stable within groups.

        Returns ``[(q, rows_of_q), ...]`` — on a backend via the dispatch
        kernels, else the numpy reference; outputs are byte-identical.
        """
        fn = getattr(self.remote, "partition_rows", None)
        if fn is not None:
            return fn(rows, parts)
        return [(int(q), rows[parts == q]) for q in np.unique(parts)]

    # -- transfer rounds -----------------------------------------------------

    def read(
        self,
        page_ids: Sequence[int],
        *,
        prefetch: bool = False,
    ) -> List[np.ndarray]:
        """One swap-in round (per tier touched, on a hierarchy).

        ``prefetch=True`` marks the round as overlapped by the double buffer
        (its RTT is hidden).  A stream's first round can never be hidden —
        there is nothing to overlap it with — so stream consumers pass
        ``prefetch`` only from the second round on (see ``PageCursor``).
        """
        if not len(page_ids):
            return []
        return self.remote.read_batch(page_ids, prefetched=prefetch)

    def read_coalesced(
        self,
        id_batches: Sequence[Sequence[int]],
        *,
        max_pages: Optional[int] = None,
        prefetch: bool = False,
    ) -> List[np.ndarray]:
        """Merge adjacent read batches into as few rounds as possible.

        Consecutive batches are fused into rounds of at most ``max_pages``
        pages (unbounded when ``None``) — batches larger than the bound are
        split, so a caller can size its local buffer to ``max_pages`` —
        trading local buffer space for rounds, the engine-level version of
        REMON's batched fetch.  Returns all pages in the original order.
        """
        if max_pages is not None and max_pages < 1:
            raise ValueError(
                f"read_coalesced needs max_pages >= 1 (or None for unbounded "
                f"rounds), got {max_pages}"
            )
        pages: List[np.ndarray] = []
        pending: List[int] = []
        issued = 0

        def flush(ids: List[int]) -> None:
            nonlocal issued
            pages.extend(self.read(ids, prefetch=prefetch and issued > 0))
            issued += 1

        for batch in id_batches:
            pending.extend(batch)
            if max_pages is not None:
                while len(pending) >= max_pages:
                    flush(pending[:max_pages])
                    pending = pending[max_pages:]
        if pending:
            flush(pending)
        return pages

    def read_filtered(
        self,
        page_ids: Sequence[int],
        *,
        selectivity: Optional[float] = None,
        predicate=None,
        batch_pages: Optional[int] = None,
        pushdown: bool = True,
    ) -> List[np.ndarray]:
        """Filtered stream read: push the filter to capable tiers, else ship.

        The keep decision is made *globally* — a scalar ``selectivity`` uses
        the deterministic positional rule over the whole ``page_ids`` list
        (``repro_torch.remote.simulator.pushdown_keep``), a ``predicate(page)`` is
        evaluated per page — so the surviving pages are identical whatever
        tier each page happens to sit on.  The stream is processed in
        ``batch_pages`` chunks (default: one chunk); per chunk, each tier's
        pages cost one round:

          * a tier capable of the ``"filter"`` op (and ``pushdown=True``)
            executes the filter in place and ships only survivors — a
            ``c_pushdown`` round with ``d_pushdown_saved`` accounting;
          * any other tier ships the whole group (a plain read round) and
            the filter runs locally.

        With ``pushdown=False``, or when no tier is capable (e.g. a bare
        single tier), the rounds and volumes are byte-for-byte identical to
        reading the stream plain in the same chunks — pushdown degrades to
        the ship path, never changes results.
        """
        from repro_torch.remote.simulator import _check_selectivity, pushdown_keep

        ids = [int(i) for i in page_ids]
        if not ids:
            return []
        if (selectivity is None) == (predicate is None):
            raise ValueError(
                "read_filtered needs exactly one of selectivity=, predicate="
            )
        batch = len(ids) if batch_pages is None else int(batch_pages)
        if batch <= 0:
            raise ValueError(f"batch_pages must be > 0, got {batch_pages}")
        keep = None
        if selectivity is not None:
            sel = _check_selectivity(selectivity)
            keep = frozenset(
                i for pos, i in enumerate(ids) if pushdown_keep(pos, sel)
            )
        kept: Dict[int, np.ndarray] = {}
        for start in range(0, len(ids), batch):
            chunk = ids[start : start + batch]
            if not self.is_hierarchy:
                for i, page in zip(chunk, self.remote.read_batch(chunk)):
                    if predicate(page) if predicate is not None else i in keep:
                        kept[i] = page
                continue
            by_tier: Dict[str, List[int]] = {}
            for i in chunk:
                by_tier.setdefault(self.remote.tier_of(i), []).append(i)
            for name in sorted(by_tier, key=self.remote.spec.index):
                group = by_tier[name]
                if pushdown and self.remote.spec.level(name).can_push("filter"):
                    if predicate is not None:
                        kids, kpages = self.remote.scan_filtered(
                            name, group, predicate=predicate
                        )
                    else:
                        kids, kpages = self.remote.scan_filtered(
                            name, group, keep_ids=keep
                        )
                    kept.update(zip(kids, kpages))
                else:
                    for i, page in zip(group, self.remote.read_batch(group)):
                        if predicate(page) if predicate is not None \
                                else i in keep:
                            kept[i] = page
        return [kept[i] for i in ids if i in kept]

    def stream_flushed(self, page_ids: Sequence[int]) -> None:
        """Hint: a spill stream owning ``page_ids`` is fully flushed.

        Forwarded to the hierarchy's attached evictor (if any) so
        spill-stream-aware eviction policies (``dead``) can mark the pages
        as first-choice demotion victims.  A no-op on bare tiers and on
        hierarchies without an evictor.
        """
        evictor = getattr(self.remote, "evictor", None)
        if evictor is not None and len(page_ids):
            evictor.stream_flushed(list(page_ids))

    def scan_hint(self, key, page_ids: Sequence[int]) -> None:
        """Hint: a sequential scan ``key`` has ``page_ids`` left to read.

        Forwarded to the hierarchy's attached evictor so victim selection
        spares pages an active scan is about to read (scan resistance —
        pure LRU would demote exactly the merge-run pages whose last access
        was the flush that wrote them).  A no-op without an evictor.
        """
        evictor = getattr(self.remote, "evictor", None)
        if evictor is not None:
            evictor.scan_hint(key, page_ids)

    def scan_done(self, key) -> None:
        """Drop a scan window previously declared via :meth:`scan_hint`."""
        evictor = getattr(self.remote, "evictor", None)
        if evictor is not None:
            evictor.scan_done(key)

    def write(
        self,
        pages: Sequence[np.ndarray],
        *,
        tier: Union[int, str, None] = None,
    ) -> List[int]:
        """One flush-out round; returns the new remote page ids.

        On a hierarchy the batch targets ``tier`` (default: the scheduler's
        placement tier), waterfalling overflow to lower tiers — each tier
        receiving pages accounts one round.
        """
        if self.is_hierarchy:
            return self.remote.write_batch(
                pages, tier=self.default_tier if tier is None else tier
            )
        return self.remote.write_batch(pages)
