"""Token embeddings + rotary position embeddings (the reference's RoPE
convention: pairs ``(x[2i], x[2i+1])``, fp32 trig, output in ``x``'s dtype)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.module import normal_init

__all__ = ["init_embedding", "apply_embedding", "apply_rope"]


def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> dict:
    return {"table": normal_init(gen, (vocab, d_model), std=0.02)}


def apply_embedding(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return params["table"][tokens.long()].to(dtype)  # gather, then cast: the same values


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10000.0,
    rotary_dim: Optional[int] = None,
) -> torch.Tensor:
    """Rotate ``x (B, T, H, Dh)`` by ``positions (B, T)`` (absolute)."""
    B, T, H, Dh = x.shape
    rd = rotary_dim or Dh
    half = rd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(float(theta), exps)  # fp32 pow, as ``theta ** x`` in the reference
    angles = positions.to(torch.float32)[:, :, None] * freqs[None, None, :]  # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x[..., :rd].to(torch.float32).reshape(B, T, H, half, 2)
    x0, x1 = xr[..., 0], xr[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    rotated = torch.stack([r0, r1], dim=-1).reshape(B, T, H, rd)
    if rd < Dh:
        rotated = torch.cat([rotated, x[..., rd:].to(torch.float32)], dim=-1)
    return rotated.to(x.dtype)
