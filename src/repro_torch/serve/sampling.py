"""Token sampling for the serve engine.

Greedy decoding only: ``(..., V)`` logits -> ``(...,)`` int32 token ids by
first-index argmax over the fp32 upcast, identical to ``np.argmax`` on the
same logits (what the parity gates rely on).  ``temperature <=
TEMPERATURE_EPS`` is the greedy limit.  Temperature and top-k sampling draw
from ``jax.random`` in the reference, so they could only ever match it in
distribution; they are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SampleConfig", "sample_tokens", "TEMPERATURE_EPS"]

TEMPERATURE_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """``greedy`` (argmax), ``temperature`` or ``topk`` — the reference's
    modes and checks; only the greedy ones run."""

    method: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.method not in ("greedy", "temperature", "topk"):
            raise ValueError(f"unknown sampling method {self.method!r}")
        if self.method == "topk" and self.top_k <= 0:
            raise ValueError("topk sampling needs top_k > 0")
        if self.method in ("temperature", "topk") and self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")

    @property
    def greedy(self) -> bool:
        return self.method == "greedy" or self.temperature <= TEMPERATURE_EPS


def sample_tokens(logits: torch.Tensor, cfg: SampleConfig) -> torch.Tensor:
    """``(..., V)`` logits -> ``(...,)`` int32 token ids on the logits' device."""
    if not cfg.greedy:
        raise NotImplementedError(f"{cfg.method} sampling is not ported yet")
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
