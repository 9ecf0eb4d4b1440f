"""Fault-tolerance primitives: crash-safe stepping, straggler watch, retry.

At 1000+ nodes the mean time between node failures drops below job length;
the contract here is: (1) all state mutations go through the checkpoint
store's atomic publish, (2) any step may raise (device loss, preemption) and
the loop restarts from the latest checkpoint, (3) slow steps are surfaced to
a straggler callback so the scheduler can trigger hot-spares / re-mesh
(elastic.py) instead of letting one slow host gate the collective.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class StragglerWatch:
    """EWMA step-time watchdog: flags steps slower than `threshold` x mean."""

    threshold: float = 2.0
    alpha: float = 0.1
    mean: Optional[float] = None
    slow_steps: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, seconds: float) -> bool:
        if self.mean is None:
            self.mean = seconds
            return False
        is_slow = seconds > self.threshold * self.mean
        if is_slow:
            self.slow_steps += 1
            log.warning("straggler: step %d took %.3fs (mean %.3fs)",
                        step, seconds, self.mean)
            if self.on_straggler:
                self.on_straggler(step, seconds, self.mean)
        # Slow steps don't poison the mean.
        self.mean = (1 - self.alpha) * self.mean + self.alpha * min(
            seconds, self.threshold * self.mean)
        return is_slow


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_seconds: float = 1.0

    def run(self, fn: Callable[[], None],
            on_restart: Optional[Callable[[int, BaseException], None]] = None):
        """Run fn; on failure invoke on_restart (reload checkpoint) and retry."""
        attempt = 0
        while True:
            try:
                return fn()
            except KeyboardInterrupt:
                raise
            except BaseException as e:
                attempt += 1
                if attempt > self.max_restarts:
                    log.error("giving up after %d restarts", self.max_restarts)
                    raise
                log.warning("step failed (%r); restart %d/%d",
                            e, attempt, self.max_restarts)
                if on_restart:
                    on_restart(attempt, e)
                time.sleep(self.backoff_seconds * attempt)
