"""Step builders over ``models.lm``.

Port of ``repro.models.steps``'s ``build_prefill_step``: one forward over a
prompt or an utterance, returning the last position's logits.  It is the
reference's entry point for an encoder (hubert), which has no serving
engine.  The training steps wait for the port of the training stack.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import Runtime, apply_lm

__all__ = ["build_prefill_step"]


def build_prefill_step(arch: ArchConfig, rt: Optional[Runtime] = None):
    """``prefill_step(params, batch) -> logits[:, -1:, :]`` of one cacheless
    forward over ``batch["tokens"]`` and/or ``batch["frontend_embeds"]``."""
    rt = rt or Runtime()

    def prefill_step(params: dict, batch: dict):
        logits, _ = apply_lm(params, arch, tokens=batch.get("tokens"),
                             frontend_embeds=batch.get("frontend_embeds"), rt=rt)
        return logits[:, -1:, :]

    return prefill_step
