"""Straggler mitigation: port of ``repro.train.elastic``'s
``StragglerWatchdog`` (the mesh planner belongs to distribution, not
ported).  On real fleets the symptom is step-time outliers on a subset of
hosts; the watchdog keeps a rolling step-time window and flags
p95-relative outliers, and its hook can rebalance or just alert.  The
detection logic is host-side and fully testable offline."""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["StragglerWatchdog"]


@dataclasses.dataclass
class StragglerWatchdog:
    """Rolling p95 step-time outlier detector with a replace/alert hook."""

    window: int = 64
    threshold: float = 1.5  # step flagged if > threshold * rolling p95
    min_samples: int = 16
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256))
    _flags: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, step_time: float) -> bool:
        """Record one step; True if this step is a straggler event."""
        history = list(self._times)[-self.window :]
        self._times.append(step_time)
        if len(history) < self.min_samples:
            return False
        p95 = float(np.percentile(history, 95))
        if step_time > self.threshold * p95:
            self._flags.append((step, step_time, p95))
            if self.on_straggler is not None:
                self.on_straggler(step, step_time, p95)
            return True
        return False

    @property
    def events(self):
        return tuple(self._flags)
