"""Train state: params + optimizer state + step (port of
``repro.train.state``; one device, so no sharding specs and no
gradient-compression residuals)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.nn.module import tree_leaves_with_path
from repro_torch.optim.optimizers import Optimizer

__all__ = ["TrainState", "init_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}

    @staticmethod
    def from_tree(t):
        return TrainState(t["params"], t["opt_state"], t["step"])


def init_state(params, optimizer: Optimizer) -> TrainState:
    """The state at step 0 of ``params`` (a tree of tensors on one device);
    the step is an int32 0-dim tensor on that device."""
    leaf = tree_leaves_with_path(params)[0][1]
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=leaf.device))
