"""Token embeddings + rotary position embeddings (the reference's RoPE
convention: pairs ``(x[2i], x[2i+1])``, fp32 trig, output in ``x``'s dtype)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.nn.module import normal_init

__all__ = ["init_embedding", "apply_embedding", "apply_rope"]


def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> dict:
    return {"table": normal_init(gen, (vocab, d_model), std=0.02)}


def apply_embedding(params: dict, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    table = params["table"]
    if isinstance(table, DTensor):
        return _sharded_embedding(table, tokens, dtype)
    return table[tokens.long()].to(dtype)  # gather, then cast: the same values


def _sharded_embedding(table: DTensor, tokens: torch.Tensor, dtype) -> DTensor:
    """The gather of a DTensor table, on local shards: the table made whole
    on every rank, each rank's tokens gathered from it, the rows laid out as
    the tokens are.  Its gradient is partial over the axes that split the
    tokens.  (DTensor's own routes fail: a vocab-split gather's masked
    partial on torch 2.13, the index's accumulating backward on torch 2.11.)"""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    grads = [Partial() if p.is_shard() else Replicate() for p in tokens.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grads)
    rows = whole[tokens.to_local().long()].to(dtype)
    # the global shape given: a batch split unevenly (1 row over 16 ranks)
    # is not 16 times the local one
    shape = (*tokens.shape, rows.shape[-1])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(rows, mesh, tokens.placements, run_check=False, shape=shape,
                              stride=stride)


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
