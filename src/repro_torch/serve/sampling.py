"""Token sampling for the serve engines, on the logits' device.

Port of ``repro.serve.sampling``: ``(..., V)`` logits -> ``(...,)`` int32
token ids inside the engines' decode / prefill steps (and inside the
megastep's captured window), so only token ids reach the host.

* ``greedy``, and any method at ``temperature <= TEMPERATURE_EPS``: the
  first-index argmax over the fp32 upcast, identical to ``np.argmax`` on the
  same logits (what the parity gates rely on); no random draw.
* ``temperature``: a categorical draw of ``softmax(lf / T)``.
* ``topk``: ``top_k`` clamped to the vocab, every logit below the k-th
  largest masked to ``-inf`` (ties with the k-th value stay in, as
  ``lax.top_k`` + ``where`` keeps them), then the temperature draw.

The draw is the Gumbel-max form ``argmax(lf / T - log(-log(u)))`` with ``u``
uniform from the caller's ``torch.Generator`` (``jax.random.categorical``'s
own method), ``u`` kept at or above the smallest normal fp32 so the noise
stays finite.  ``jax.random`` streams cannot be reproduced in PyTorch: the
port matches the reference in distribution and is reproducible from its own
generator's seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SampleConfig", "sample_tokens", "mask_topk", "TEMPERATURE_EPS"]

# Below this, temperature sampling *is* greedy: dividing logits by a vanishing
# temperature inflates them toward +/-inf; argmax is the correct limit.
TEMPERATURE_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """``greedy`` (argmax), ``temperature`` (softmax sampling), or ``topk``
    (mask to the ``top_k`` highest logits, then temperature-sample)."""

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
        """True where ``sample_tokens`` takes the argmax (no random draw)."""
        return self.method == "greedy" or self.temperature <= TEMPERATURE_EPS


def mask_topk(lf: torch.Tensor, top_k: int) -> torch.Tensor:
    """``lf`` with every logit below the row's k-th largest set to ``-inf``
    (``top_k`` clamped to the vocab; ties with the k-th value stay in)."""
    k = min(top_k, lf.shape[-1])
    kth = torch.topk(lf, k, dim=-1).values[..., -1:]
    return lf.masked_fill(lf < kth, float("-inf"))


def sample_tokens(logits: torch.Tensor, cfg: SampleConfig,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``(..., V)`` logits -> ``(...,)`` int32 token ids on the logits' device;
    the non-greedy methods draw ``u`` from ``generator`` (on that device)."""
    lf = logits.to(torch.float32)
    if cfg.greedy:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    if cfg.method == "topk":
        lf = mask_topk(lf, cfg.top_k)
    u = torch.rand(lf.shape, generator=generator, dtype=torch.float32, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(lf / cfg.temperature + gumbel, dim=-1).to(torch.int32)
