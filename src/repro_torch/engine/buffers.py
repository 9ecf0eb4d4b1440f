"""Shared spill buffers: capacity-triggered write pools and streamed read cursors.

These two classes carry *all* of the operators' round accounting:

``BufferPool``
  A write pool of ``capacity_pages`` shared by ``n_streams`` output streams
  (partitions, runs, the single result stream).  Each stream owns a slice of
  ``floor(capacity/n_streams)`` pages; whenever a slice fills, exactly one
  slice worth of rows is flushed in one batched write round, so a stream of
  ``V`` pages costs ``ceil(V / slice)`` write rounds — the ``|stream|/R``
  terms in the paper's C formulas (§III).  ``flush_all`` force-flushes the
  partial remainders, one round per non-empty stream.

``PageCursor``
  Streams a page-id list through a fixed-size read buffer; each refill is one
  read round, so a ``V``-page stream through a ``c``-page buffer costs
  ``ceil(V/c)`` read rounds.  With ``prefetch=True`` the cursor models the
  §IV-E double buffer: every refill after the first is issued one batch ahead
  and its RTT is hidden (accounted by the scheduler).  Sorted-run helpers
  (``safe_bound`` / ``take_upto``) support merge consumers (EMS).
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.engine.scheduler import TransferScheduler


class BufferPool:
    """Per-stream sliced write pool with batched, capacity-triggered flushes.

    On a hierarchy target, ``tier`` names the placement tier for this pool's
    flush rounds (``None`` falls through to the scheduler's default tier) —
    the hook fractional placement uses to route one operator's streams to
    different tiers.
    """

    def __init__(
        self,
        sched: TransferScheduler,
        capacity_pages: float,
        rows_per_page: int,
        n_streams: int = 1,
        tier=None,
    ):
        self.sched = sched
        self.tier = tier
        self.slice_pages = max(1, int(capacity_pages / max(n_streams, 1)))
        self.slice_rows = self.slice_pages * rows_per_page
        self.rows_per_page = rows_per_page
        self._bufs: Dict[Hashable, List[np.ndarray]] = {}
        self._counts: Dict[Hashable, int] = {}
        self._pages: Dict[Hashable, List[int]] = {}
        self.flushes = 0
        self.rows_flushed = 0

    def add(self, rows: np.ndarray, stream: Hashable = 0) -> None:
        """Buffer rows on a stream; flush full slices as batched write rounds."""
        if not len(rows):
            return
        self._bufs.setdefault(stream, []).append(rows)
        self._counts[stream] = self._counts.get(stream, 0) + len(rows)
        if self._counts[stream] >= self.slice_rows:
            self._drain(stream, force=False)

    def _drain(self, stream: Hashable, force: bool) -> None:
        bufs = self._bufs.get(stream, [])
        data = bufs[0] if len(bufs) == 1 else np.concatenate(bufs, axis=0)
        while len(data) >= self.slice_rows:
            self._write_round(stream, data[: self.slice_rows])
            data = data[self.slice_rows :]
        if force and len(data):
            self._write_round(stream, data)
            data = data[:0]
        self._bufs[stream] = [data] if len(data) else []
        self._counts[stream] = len(data)

    def _write_round(self, stream: Hashable, chunk: np.ndarray) -> None:
        pages = [
            chunk[i : i + self.rows_per_page]
            for i in range(0, len(chunk), self.rows_per_page)
        ]
        self._pages.setdefault(stream, []).extend(
            self.sched.write(pages, tier=self.tier)
        )
        self.flushes += 1
        self.rows_flushed += len(chunk)

    def flush_all(self) -> None:
        """Force-flush every stream's remainder: one write round per stream.

        A force-flush means the stream is complete, so each stream's pages
        are reported to the scheduler as a fully-flushed spill stream — the
        "dead after flush" hint eviction policies use to pick first-choice
        demotion victims.
        """
        for stream in list(self._bufs):
            if self._counts.get(stream, 0):
                self._drain(stream, force=True)
        for page_ids in self._pages.values():
            self.sched.stream_flushed(page_ids)

    def buffered_rows(self, stream: Hashable = 0) -> int:
        return self._counts.get(stream, 0)

    def pages(self, stream: Hashable = 0) -> List[int]:
        """Remote page ids flushed for a stream, in flush order."""
        return self._pages.get(stream, [])


class PageCursor:
    """Streamed reads of a page-id list through a fixed-size buffer."""

    def __init__(
        self,
        sched: TransferScheduler,
        page_ids: Sequence[int],
        batch_pages: float,
        *,
        prefetch: bool = False,
        ravel: bool = False,
    ):
        self.sched = sched
        self.page_ids = list(page_ids)
        self.batch_pages = max(1, int(batch_pages))
        self.prefetch = prefetch
        self.ravel = ravel
        self.pos = 0
        self.refills = 0
        self._buf: Optional[np.ndarray] = None
        # Scan resistance: declare the unread window so an attached evictor
        # never demotes pages this cursor is about to read (the EMS merge
        # pattern — run pages rank LRU-coldest exactly when they are next).
        self._scan_key = f"cursor-{id(self)}"
        self.sched.scan_hint(self._scan_key, self.page_ids)

    # -- buffered streaming (merge consumers) --------------------------------

    @property
    def buffered(self) -> int:
        """Rows (or keys, in ravel mode) currently buffered."""
        return 0 if self._buf is None else len(self._buf)

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.page_ids) and self.buffered == 0

    def refill(self) -> bool:
        """One read round: load the next batch into the (empty) buffer."""
        if self.buffered > 0 or self.pos >= len(self.page_ids):
            return self.buffered > 0
        self._buf = self._concat(self._read_next())
        return True

    def safe_bound(self) -> Optional[int]:
        """Largest key below which this stream cannot produce unseen elements.

        ``None`` when nothing is buffered, or when the stream is fully
        buffered (no bound needed).  Assumes a sorted (run) stream.
        """
        if self.buffered == 0 or self.pos >= len(self.page_ids):
            return None
        return int(self._buf[-1])

    def take_upto(self, bound: Optional[int]) -> np.ndarray:
        """Consume buffered elements ``<= bound`` (all of them when ``None``).

        The empty result keeps the buffered dtype when one is known — an
        execution backend streams real (possibly non-int64) pages through
        the same cursors, and a dtype-mismatched empty would poison the
        consumer's concatenation.
        """
        if self.buffered == 0:
            dtype = np.int64 if self._buf is None else self._buf.dtype
            return np.empty((0,), dtype=dtype)
        if bound is None:
            out, self._buf = self._buf, self._buf[:0]
            return out
        idx = int(np.searchsorted(self._buf, bound, side="right"))
        out, self._buf = self._buf[:idx], self._buf[idx:]
        return out

    # -- block streaming (scan consumers) ------------------------------------

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield one concatenated block per read round until exhausted.

        Rows already buffered by ``refill()`` (whose round was already
        charged) are drained first, so mixing the buffered and block APIs
        never drops data.
        """
        if self.buffered:
            buf, self._buf = self._buf, None
            yield buf
        while self.pos < len(self.page_ids):
            yield self._concat(self._read_next())

    def read_all(self) -> np.ndarray:
        """Stream the remaining pages (one round per batch) into one array."""
        return np.concatenate(list(self.blocks()), axis=0)

    def _concat(self, pages: List[np.ndarray]) -> np.ndarray:
        if self.ravel:
            return np.concatenate([p.ravel() for p in pages])
        return pages[0] if len(pages) == 1 else np.concatenate(pages, axis=0)

    def _read_next(self) -> List[np.ndarray]:
        ids = self.page_ids[self.pos : self.pos + self.batch_pages]
        # A stream's first round is never hidden: nothing overlaps it.
        pages = self.sched.read(ids, prefetch=self.prefetch and self.refills > 0)
        self.pos += len(ids)
        self.refills += 1
        # Shrink the protected window to what is still unread; exhausting
        # the stream lifts the protection entirely.
        if self.pos >= len(self.page_ids):
            self.sched.scan_done(self._scan_key)
        else:
            self.sched.scan_hint(self._scan_key, self.page_ids[self.pos:])
        return pages
