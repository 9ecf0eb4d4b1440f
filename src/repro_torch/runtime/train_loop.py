"""Fault-tolerant training loop: checkpoint/restart + straggler watch.

``repro``'s loop (``runtime/train_loop.py``): deliberately dumb about
*what* it runs (any ``step_fn(state, batch) -> (state, metrics)``) and
strict about *how*: resumable data (step-keyed), atomic async checkpoints,
restart from the latest checkpoint on failure, straggler accounting.  The
port waits for the device where ``repro`` calls ``block_until_ready``
(the step's loss, so a step's time is its device time) and reads tensors
back where ``repro`` calls ``device_get``.  A step that updates its state
in place (``step_fn.donates``, ``make_train_step(..., donate=True)``)
consumes the starting state, as ``repro``'s donated buffers are: a restart
with no checkpoint to resume from then raises rather than start again from
half-updated tensors.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.runtime.ft import RetryPolicy, StragglerWatch

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    async_checkpoint: bool = True
    max_restarts: int = 3


def _host(x):
    """A tensor's value on the host (``device_get``); other values as they are."""
    return x.item() if isinstance(x, torch.Tensor) and x.dim() == 0 else x


def train(
    step_fn: Callable,  # (state, batch) -> (state, metrics)
    state: Any,
    batches: Callable[[int], Iterator],  # start_step -> iterator
    store: Optional[CheckpointStore],
    loop_cfg: LoopConfig,
    metrics_cb: Optional[Callable[[int, Dict], None]] = None,
) -> Any:
    """Run to total_steps with restart-from-checkpoint on failure."""
    watch = StragglerWatch()
    start_state = state
    donates = getattr(step_fn, "donates", False)

    def current_step(s) -> int:
        return int(_host(s["step"]))

    def resume(err):
        step, restored = (None, None) if store is None else store.restore_latest(start_state)[:2]
        if restored is not None:
            log.info("resumed from checkpoint at step %d", step)
            return restored
        if holder["consumed"]:
            raise RuntimeError("no checkpoint to restart from, and the step updated the "
                               "starting state in place") from err
        return start_state

    holder = {"state": state, "consumed": False}

    def body():
        state = holder["state"]
        step = current_step(state)
        it = iter(batches(step))
        while step < loop_cfg.total_steps:
            batch = next(it)
            t0 = time.time()
            holder["consumed"] |= donates
            state, metrics = step_fn(state, batch)
            _host(metrics["loss_total"])  # waits for the step
            dt = time.time() - t0
            step = current_step(state)
            holder["state"] = state
            watch.observe(step, dt)
            if metrics_cb and step % loop_cfg.log_every == 0:
                metrics_cb(step, {k: _host(v) for k, v in metrics.items()})
            if store is not None and step % loop_cfg.checkpoint_every == 0:
                store.save(step, state, {"step": step},
                           blocking=not loop_cfg.async_checkpoint)
        if store is not None:
            store.wait()
            store.save(loop_cfg.total_steps, holder["state"],
                       {"step": loop_cfg.total_steps}, blocking=True)
        return holder["state"]

    def on_restart(attempt, err):
        holder["state"] = resume(err)

    return RetryPolicy(max_restarts=loop_cfg.max_restarts).run(
        body, on_restart=on_restart)
