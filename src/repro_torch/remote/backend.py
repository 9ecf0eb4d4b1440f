"""Torch execution backend: pages carry device tensors, CUDA kernels run.

Everywhere else in ``remote/`` the store is a *simulator* — pages are host
numpy arrays, transfers are ledger bookkeeping, and latency comes from
Eq. (1) with assumed Table I constants.  This module is the measured
counterpart: a :class:`TorchExecutionBackend` is a drop-in
:class:`~repro_torch.remote.simulator.MemoryHierarchy` whose tiers keep a
copy of each page as a tensor on the backend's device, whose transfer rounds
are real host<->device copies timed with a wall clock, and whose operator
compute hooks run the port's CUDA kernels (``kernels/merge_sort`` for EMS
sorts, ``kernels/merge_sort`` + ``kernels/dispatch`` for EHJ/EAGG
partitioning).

Parity is the correctness oracle: every ledger round counts *exactly* as on
the simulator (the overrides delegate to the simulator paths for all D/C
accounting) and every operator output is byte-identical, because

  * device copies only hold pages that round-trip losslessly through the
    kernels' 32-bit types: int32/float32 pages as they are, int64 pages as
    int32 only when every value fits; everything else stays host-pinned and
    is counted,
  * the kernel hooks fall back to the numpy reference whenever a block is
    not losslessly representable (counted in ``wall.kernel_fallbacks``), and
  * the hooks compute the same functions: sorted keys are sorted keys, and
    a stable partition-id argsort groups rows exactly like per-partition
    boolean masks.

The device is explicit: ``device=None`` is ``cuda:0`` and raises when no
card is present; ``device="cpu"`` keeps the copies on the CPU and runs the
kernels' plain versions.  Host->device copies stage through pinned memory.
This file is the one module of the port that reads a clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.cost_model import HierarchySpec, TierSpec
from repro_torch.kernels.dispatch.dispatch import gather_rows
from repro_torch.kernels.merge_sort.ops import argsort_by_key, remop_sort
from repro_torch.kernels.runtime import resolve_device
from repro_torch.remote.simulator import MemoryHierarchy, RemoteMemory

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _device_page(page: np.ndarray) -> Optional[np.ndarray]:
    """A device-representable view of a host page, or ``None`` when lossy.

    int32/float32 pages mirror as-is; int64 pages mirror as int32 only when
    every value round-trips exactly.  Anything else host-pins — parity with
    the simulator always beats device coverage.
    """
    page = np.asarray(page)
    if page.dtype == np.int64:
        if page.size and (page.min() < _I32_MIN or page.max() > _I32_MAX):
            return None
        return page.astype(np.int32)
    if page.dtype in (np.int32, np.float32):
        return page
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(arrays: Sequence[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """Copy 32-bit host arrays to ``device`` in one round.

    On a card the arrays are packed into one pinned staging buffer and cross
    in a single host->device copy; each result is a view of that device
    buffer.  On the CPU each array is copied.
    """
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if device.type != "cuda":
        return [torch.from_numpy(a.copy()) for a in arrays]
    sizes = [a.nbytes for a in arrays]
    staging = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
    host = staging.numpy()
    off = 0
    for a, size in zip(arrays, sizes):
        host[off:off + size] = a.reshape(-1).view(np.uint8)
        off += size
    flat = staging.to(device, non_blocking=True)
    out = []
    off = 0
    for a, size in zip(arrays, sizes):
        out.append(flat[off:off + size].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape))
        off += size
    return out


def _download(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy device tensors back to host numpy arrays in one round."""
    if tensors[0].device.type != "cuda":
        return [t.numpy().copy() for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    raw = host.numpy()
    out = []
    off = 0
    for t in tensors:
        size = t.numel() * t.element_size()
        np_dtype = np.dtype(str(t.dtype).removeprefix("torch."))
        # Copy out of the pinned buffer: it returns to the allocator's cache.
        out.append(raw[off:off + size].view(np_dtype).reshape(tuple(t.shape)).copy())
        off += size
    return out


# --------------------------------------------------------------------------
# Wall clock: the measured counterpart of the TransferLedger
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TierWall:
    """Measured host<->device transfer time for one tier."""

    h2d_seconds: float = 0.0
    h2d_rounds: int = 0
    h2d_bytes: int = 0
    d2h_seconds: float = 0.0
    d2h_rounds: int = 0
    d2h_bytes: int = 0

    @property
    def seconds(self) -> float:
        return self.h2d_seconds + self.d2h_seconds

    @property
    def rounds(self) -> int:
        return self.h2d_rounds + self.d2h_rounds

    @property
    def bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes

    def to_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d.update(seconds=self.seconds, rounds=self.rounds, bytes=self.bytes)
        return d


class WallClock:
    """Per-tier transfer timings + kernel timings for one backend.

    The wall clock is to measured execution what the
    :class:`~repro_torch.core.cost_model.TransferLedger` is to the
    simulation; unlike the ledger it depends on the machine.
    """

    def __init__(self, tier_names: Sequence[str]):
        self.tiers: Dict[str, TierWall] = {n: TierWall() for n in tier_names}
        self.kernel_seconds = 0.0
        self.kernel_calls = 0
        # Blocks routed back to the numpy reference (lossy int32 round-trip).
        self.kernel_fallbacks = 0
        # Pages never mirrored on device (lossy dtype/range): reads of these
        # serve from the host store, so their rounds have no device timing.
        self.host_pinned_pages = 0

    def record_h2d(self, tier: str, seconds: float, nbytes: int) -> None:
        w = self.tiers[tier]
        w.h2d_seconds += seconds
        w.h2d_rounds += 1
        w.h2d_bytes += nbytes

    def record_d2h(self, tier: str, seconds: float, nbytes: int) -> None:
        w = self.tiers[tier]
        w.d2h_seconds += seconds
        w.d2h_rounds += 1
        w.d2h_bytes += nbytes

    def record_kernel(self, seconds: float) -> None:
        self.kernel_seconds += seconds
        self.kernel_calls += 1

    @property
    def transfer_seconds(self) -> float:
        return sum(w.seconds for w in self.tiers.values())

    @property
    def total_seconds(self) -> float:
        """Measured seconds: all transfers + all kernel invocations."""
        return self.transfer_seconds + self.kernel_seconds

    def to_dict(self) -> Dict[str, object]:
        return {
            "tiers": {n: w.to_dict() for n, w in self.tiers.items()},
            "transfer_seconds": self.transfer_seconds,
            "kernel_seconds": self.kernel_seconds,
            "kernel_calls": self.kernel_calls,
            "kernel_fallbacks": self.kernel_fallbacks,
            "host_pinned_pages": self.host_pinned_pages,
            "wall_seconds": self.total_seconds,
        }


# --------------------------------------------------------------------------
# Backend tiers and the hierarchy
# --------------------------------------------------------------------------


class TorchBackendTier(RemoteMemory):
    """A tier whose pages are mirrored as tensors on the backend's device.

    Every override delegates to :class:`RemoteMemory` first, so the ledger
    accounting (rounds, volumes, prefetch hiding) is byte-identical to the
    simulator; the device copy rides along.  ``write_batch`` is a timed
    host->device round, ``read_batch`` a timed device->host round, and the
    pages a read returns are the *device round-trips* (cast back to the host
    dtype), so the data operators consume really crossed the boundary.
    """

    def __init__(self, tier: TierSpec, wall: WallClock, device: torch.device,
                 _alloc=None):
        super().__init__(tier, _alloc=_alloc)
        self._wall = wall
        self._device = device
        self._dev: Dict[int, torch.Tensor] = {}
        self._in_write = False

    # -- mirroring -----------------------------------------------------------

    def _mirror(self, page_ids: Sequence[int]) -> None:
        views = []
        for i in page_ids:
            v = _device_page(self._store[i])
            if v is None:
                self._wall.host_pinned_pages += 1
            else:
                views.append((i, v))
        if not views:
            return
        nbytes = sum(v.nbytes for _, v in views)
        t0 = time.perf_counter()
        tensors = _upload([v for _, v in views], self._device)
        _sync(self._device)
        elapsed = time.perf_counter() - t0
        if self._in_write:  # seeding (put_local) is not a transfer round
            self._wall.record_h2d(self.tier.name, elapsed, nbytes)
        for (i, _), t in zip(views, tensors):
            self._dev[i] = t

    def put_local(self, pages: Sequence[np.ndarray]) -> List[int]:
        ids = super().put_local(pages)
        self._mirror(ids)
        return ids

    # -- timed transfer rounds ------------------------------------------------

    def write_batch(self, pages: Sequence[np.ndarray]) -> List[int]:
        if not len(pages):
            return []
        self._in_write = True
        try:
            return super().write_batch(pages)  # ledger + put_local -> mirror
        finally:
            self._in_write = False

    def read_batch(self, page_ids: Sequence[int], prefetched: bool = False) -> List[np.ndarray]:
        if not page_ids:
            return []
        host = super().read_batch(page_ids, prefetched)  # identical ledger
        mirrors = [self._dev.get(i) for i in page_ids]
        fetched: List[Optional[np.ndarray]] = [None] * len(page_ids)
        live = [(k, d) for k, d in enumerate(mirrors) if d is not None]
        if live:
            t0 = time.perf_counter()
            pulled = _download([d for _, d in live])
            elapsed = time.perf_counter() - t0
            self._wall.record_d2h(
                self.tier.name, elapsed, sum(p.nbytes for p in pulled)
            )
            for (k, _), p in zip(live, pulled):
                fetched[k] = p
        return [
            h if f is None else f.astype(h.dtype, copy=False)
            for h, f in zip(host, fetched)
        ]

    def free(self, page_ids: Iterable[int]) -> None:
        ids = list(page_ids)
        super().free(ids)
        for i in ids:
            self._dev.pop(i, None)


class TorchExecutionBackend(MemoryHierarchy):
    """A :class:`MemoryHierarchy` executing for real: device pages + kernels.

    Drop-in for every ``MemoryHierarchy`` consumer (``Session``, the
    operators): same placement map, same waterfall, same ledgers — the
    parity tests assert snapshot equality field-for-field — plus a
    :attr:`wall` clock of measured seconds and two compute hooks the
    operators discover through their :class:`~repro_torch.engine.scheduler.
    TransferScheduler` (:meth:`sort_keys`, :meth:`partition_rows`).

    ``device=None`` is ``cuda:0`` and raises ``RuntimeError`` without a card;
    ``device="cpu"`` runs the kernels' plain versions on the CPU.
    """

    is_backend = True  # structural marker (duck-typed like is_hierarchy)

    def __init__(self, spec: HierarchySpec,
                 device: Union[str, torch.device, None] = None):
        super().__init__(spec)
        self.device = resolve_device(device)
        self.wall = WallClock(spec.names)
        # Re-materialize the levels as backend tiers on the shared allocator
        # (no pages exist yet, so swapping the empty stores is safe).
        self.tiers = [
            TorchBackendTier(lv.tier, wall=self.wall, device=self.device,
                             _alloc=self._alloc)
            for lv in spec.levels
        ]

    # -- migration: move the device copies with the pages ---------------------

    def migrate(
        self,
        page_ids: Sequence[int],
        dst: Union[int, str],
        background: bool = False,
    ) -> None:
        old = {i: self._placement.get(i) for i in page_ids}
        super().migrate(page_ids, dst, background=background)
        # The base class pokes tier stores directly; re-home the mirrors.
        # All tiers share one device, so this is a reference move, not a
        # timed copy (the ledger already charged the migration rounds).
        for i in page_ids:
            src, cur = old[i], self._placement[i]
            if src is None or src == cur:
                continue
            dev = self.tiers[src]._dev.pop(i, None)
            if dev is not None:
                self.tiers[cur]._dev[i] = dev

    # -- operator compute hooks ------------------------------------------------

    def sort_keys(self, keys: np.ndarray) -> np.ndarray:
        """EMS hook: sort a 1-D key block with the ``merge_sort`` kernels.

        Byte-identical to ``np.sort(keys, kind="stable")`` — bare keys carry
        no payload, so equal keys are interchangeable.  Blocks that cannot
        round-trip int32 losslessly fall back to numpy (counted).
        """
        keys = np.asarray(keys)
        if keys.ndim != 1 or keys.size < 2:
            return np.sort(keys, kind="stable")
        dev = _device_page(keys) if keys.dtype.kind in "iu" else None
        if dev is None:
            self.wall.kernel_fallbacks += 1
            return np.sort(keys, kind="stable")
        t0 = time.perf_counter()
        (block,) = _upload([dev], self.device)
        out, _ = remop_sort(block)
        _sync(self.device)
        self.wall.record_kernel(time.perf_counter() - t0)
        return _download([out])[0].astype(keys.dtype, copy=False)

    def partition_rows(
        self, rows: np.ndarray, parts: np.ndarray
    ) -> List[Tuple[int, np.ndarray]]:
        """EHJ/EAGG hook: group a row block by partition id via ``dispatch``.

        Returns ``[(q, rows_of_q), ...]`` with ``q`` ascending — exactly
        ``[(q, rows[parts == q]) for q in np.unique(parts)]``, because the
        partition-id argsort is *stable* (within-partition row order is
        preserved) and ``gather_rows`` applies the permutation verbatim.
        """
        rows = np.asarray(rows)
        parts = np.asarray(parts)
        if not len(rows):
            return []
        uniq, counts = np.unique(parts, return_counts=True)
        n = len(parts)
        max_part = int(uniq[-1])
        dev_rows = _device_page(rows) if rows.ndim == 2 else None
        eligible = (
            n >= 2
            and dev_rows is not None
            and parts.dtype.kind in "iu"
            and int(uniq[0]) >= 0
            and max_part * n + n < 2**31
        )
        if not eligible:
            self.wall.kernel_fallbacks += 1
            return [(int(q), rows[parts == q]) for q in uniq]
        t0 = time.perf_counter()
        dev_parts, dev_block = _upload([parts.astype(np.int32), dev_rows], self.device)
        order = argsort_by_key(dev_parts, max_key=max_part)
        gathered = gather_rows(dev_block, order)
        _sync(self.device)
        self.wall.record_kernel(time.perf_counter() - t0)
        ordered = _download([gathered])[0].astype(rows.dtype, copy=False)
        out: List[Tuple[int, np.ndarray]] = []
        start = 0
        for q, c in zip(uniq, counts):
            out.append((int(q), ordered[start:start + int(c)]))
            start += int(c)
        return out


def make_backend(
    *levels: Union[TierSpec, str, Tuple[Union[TierSpec, str], float]],
    device: Union[str, torch.device, None] = None,
) -> TorchExecutionBackend:
    """Build a :class:`TorchExecutionBackend` from tier / ``(tier, cap)`` levels.

    The backend twin of :func:`repro_torch.remote.simulator.make_hierarchy` —
    same tier resolution, e.g. ``make_backend(("dram", 64), "rdma", "ssd")``.
    """
    from repro_torch.core.cost_model import hierarchy_spec

    return TorchExecutionBackend(hierarchy_spec(*levels), device=device)
