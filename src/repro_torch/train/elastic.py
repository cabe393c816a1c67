"""Elastic scaling + straggler mitigation (port of ``repro.train.elastic``).

Elastic restart: after losing nodes, the job restarts with a different device
count.  ``plan_mesh`` picks the largest valid (data, model) (or pod-extended)
mesh for the live devices while respecting the arch's TP divisibility; a pure
function of the count (the checkpoint stores whole arrays, so nothing about
it depends on the mesh that wrote it).

Straggler mitigation: on real fleets the symptom is step-time outliers on a
subset of hosts.  ``StragglerWatchdog`` keeps a rolling step-time window and
flags p95-relative outliers; its hook can rebalance or just alert.  The
detection logic is host-side and fully testable offline.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["plan_mesh", "StragglerWatchdog"]


def plan_mesh(n_devices: int, *, prefer_model: int = 16, model_divisors: Sequence[int] = (),
              max_pods: int = 64) -> dict:
    """Choose (pod, data, model) for a live device count.

    ``model_divisors``: unit counts the TP axis should divide (e.g. heads,
    d_ff); the planner degrades model-parallel width before data width.
    Returns ``{"shape": tuple, "axes": tuple}`` (``dist.sharding.Mesh``'s
    sizes and names)."""
    if n_devices <= 0:
        raise ValueError("no devices")
    model = min(prefer_model, n_devices)
    while model > 1:
        if n_devices % model == 0 and all(u % model == 0 for u in model_divisors if u):
            break
        model //= 2
    model = max(model, 1)
    rest = n_devices // model
    # a pod axis of 2..8 when the rest is even and large (the cross-DCN
    # gradient reduction stays a single outer axis)
    pod = 1
    for cand in (2, 4, 8):
        if cand <= max_pods and rest % cand == 0 and rest // cand >= 2:
            pod = cand
            break
    data = rest // pod
    if pod > 1:
        return {"shape": (pod, data, model), "axes": ("pod", "data", "model")}
    return {"shape": (data, model), "axes": ("data", "model")}


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
