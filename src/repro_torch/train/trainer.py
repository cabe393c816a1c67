"""Training loop: step, metrics, checkpointing, watchdog, emergency save
(port of ``repro.train.trainer``; no jit and no buffer donation — the step
runs eagerly and the old state's tensors are freed when nothing holds
them).

The host reads the device once per logged step (every ``log_every``
steps and the last): that read waits for the steps queued before it, so
between two logged steps the host enqueues ahead of the card instead of
stalling on a ``float()`` of every step.  ``step_time`` is the mean
wall-clock time a step over the steps since the previous logged one, and
it is what the straggler watchdog observes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.nn.module import tree_leaves_with_path
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import StragglerWatchdog

__all__ = ["Trainer", "TrainLoopResult"]


@dataclasses.dataclass
class TrainLoopResult:
    state: Any
    history: list
    straggler_events: tuple


def _to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on ``device``; on a card through pinned memory
    and a non-blocking copy, which does not wait for the queued steps."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


class Trainer:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` over a stateless
    batch source (``batch_fn(step) -> dict`` of numpy arrays), on the device
    that holds the state's params."""

    def __init__(
        self,
        step_fn: Callable,
        batch_fn: Callable[[int], dict],
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep: int = 3,
        log_every: int = 10,
        watchdog: Optional[StragglerWatchdog] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.watchdog = watchdog or StragglerWatchdog()
        self._last_state = None

    def maybe_restore(self, state, allow_missing: bool = False, shardings=None):
        """Resume from the latest valid checkpoint if one exists (the data
        stream is stateless, so the step index fully restores the run).
        ``allow_missing`` tolerates state leaves absent from the
        checkpoint (they keep ``state``'s values); ``shardings`` places
        the restored leaves on a live mesh (``checkpoint.restore``)."""
        if self.ckpt_dir is None:
            return state, 0
        if ckpt.latest_step(self.ckpt_dir) is None:
            return state, 0
        tree, step = ckpt.restore(self.ckpt_dir, state, shardings=shardings,
                                  allow_missing=allow_missing)
        return tree, int(step)

    def emergency_save(self):
        if self.ckpt_dir is not None and self._last_state is not None:
            step = int(self._last_state["step"])
            ckpt.save(self.ckpt_dir, self._last_state, step, keep=self.keep)

    def run(self, state, n_steps: int, start_step: Optional[int] = None) -> TrainLoopResult:
        history = []
        start = start_step if start_step is not None else int(state["step"])
        device = tree_leaves_with_path(state["params"])[0][1].device
        t_last, pending = time.perf_counter(), 0
        for i in range(start, start + n_steps):
            batch = _to_device(self.batch_fn(i), device)
            state, metrics = self.step_fn(state, batch)
            self._last_state = state
            pending += 1
            if i % self.log_every == 0 or i == start + n_steps - 1:
                names = list(metrics)
                values = torch.stack([metrics[k].to(device, torch.float32) for k in names]).tolist()
                now = time.perf_counter()  # after the read: the steps are done
                dt = (now - t_last) / pending
                t_last, pending = now, 0
                self.watchdog.observe(i, dt)
                rec = dict(zip(names, values))
                rec.update(step=i, step_time=dt)
                history.append(rec)
            if self.ckpt_dir is not None and (i + 1) % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, state, i + 1, keep=self.keep)
        if self.ckpt_dir is not None:
            ckpt.save(self.ckpt_dir, state, start + n_steps, keep=self.keep)
        return TrainLoopResult(state, history, self.watchdog.events)
