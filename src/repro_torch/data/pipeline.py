"""Synthetic batches and a prefetching loader that places them on the device.

``synthetic_batches`` is ``repro``'s (``data/pipeline.py``): numpy's
generator keyed by ``(seed, step)``, so the port's batches equal ``repro``'s
byte for byte and a resumed run draws the batches it would have drawn.

``PrefetchingLoader`` keeps ``repro``'s double buffer (one worker thread,
a queue of ``depth``): while the device consumes batch i, the worker builds
batch i + 1 and moves it.  On a CUDA device it copies from pinned host
memory on a side stream and records an event; the consumer's stream waits
on that event before the batch is used, and each tensor is marked with
``record_stream`` so its memory is not reused while the consumer's stream
may still read it.  On the CPU it yields plain tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def synthetic_batches(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                      start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic per-step synthetic LM batches (resumable by step index)."""
    b, s = shape.global_batch, shape.seq_len
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        tokens = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
        batch = {"tokens": tokens, "targets": tokens}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (b, cfg.frontend_seq, cfg.frontend_dim), dtype=np.float32)
            batch["tokens"] = tokens[:, : s - cfg.frontend_seq]
            batch["targets"] = batch["tokens"]
        if cfg.family == "audio_encdec":
            batch["frames"] = rng.standard_normal(
                (b, s, cfg.frontend_dim), dtype=np.float32)
        yield batch
        step += 1


class PrefetchingLoader:
    """Double-buffered host->device loader (one worker, depth-2 queue);
    ``device`` defaults to the CPU."""

    def __init__(self, iterator, device: Optional[torch.device] = None, depth: int = 2):
        self._iter = iterator
        self._device = torch.device("cpu") if device is None else torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _place(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            placed = {k: v.pin_memory().to(self._device, non_blocking=True)
                      for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return placed, ready

    def _work(self):
        try:
            for batch in self._iter:
                if self._stop.is_set():
                    return
                self._q.put(self._place(batch))
        except Exception as e:  # surface in consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
