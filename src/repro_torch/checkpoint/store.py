"""Checkpoint store: atomic, async, restored into a template's structure.

``repro``'s contract (``checkpoint/store.py``), on the port's trees of
dicts and lists:
  * one ``ckpt_<step>.npz`` a step, each leaf under its path of keys joined
    by ``::`` (list indices as numbers: ``params::layers::3::attn::wq::w``);
  * saves are atomic (write to a tmp file, fsync, rename), so a crash
    mid-save never corrupts the latest checkpoint;
  * ``save`` copies every leaf to the host first (a copy of its own, a
    CPU leaf too: a step that updates the state in place may run while the
    copy is written), then writes, in the background unless ``blocking``;
    one write is outstanding at a time, and
    its error is raised by the next ``wait`` (or ``save``);
  * the newest ``keep`` checkpoints are kept, older ones removed;
  * ``restore`` loads into a template's structure and places each leaf on
    the template leaf's device in its dtype; a missing leaf raises
    ``KeyError``, a shape that differs ``ValueError``.
numpy has no bfloat16, so a bf16 leaf is stored as its 16-bit pattern
(int16) and viewed back as bf16 on restore, bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths

_FLAT_SEP = "::"


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_FLAT_SEP.join(path): _to_host(leaf) for path, leaf in leaves_with_paths(tree)}


def _unflatten_into(template, flat: Dict[str, np.ndarray], path=()):
    if isinstance(template, dict):
        return {k: _unflatten_into(x, flat, path + (str(k),)) for k, x in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(x, flat, path + (str(i),))
                              for i, x in enumerate(template))
    key = _FLAT_SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model "
                         f"{tuple(template.shape)}")
    t = torch.from_numpy(arr)
    if template.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=template.device, dtype=template.dtype)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- paths ---------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def latest_step(self) -> Optional[int]:
        steps = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, state, metadata: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> None:
        """Snapshot to host, then write (optionally in the background)."""
        self.wait()  # one outstanding async save at a time
        host_flat = _flatten(state)  # device->host copy happens here

        def write():
            try:
                tmp = self._path(step) + ".tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, __meta__=json.dumps(metadata or {}), **host_flat)
                    f.flush()
                    os.fsync(f.fileno())
                os.rename(tmp, self._path(step))  # atomic publish
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._worker = threading.Thread(target=write, daemon=True)
            self._worker.start()

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for f in os.listdir(self.directory)
            if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f))
        )
        for s in steps[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # -- restore -----------------------------------------------------------------

    def restore(self, step: int, template):
        """Load into ``template``'s structure, each leaf on the template
        leaf's device and in its dtype; returns (state, metadata)."""
        with np.load(self._path(step), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            flat = {k: z[k] for k in z.files if k != "__meta__"}
        return _unflatten_into(template, flat), meta

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None, None
        state, meta = self.restore(step, template)
        return step, state, meta
