"""Parameter initializers drawing from an explicit ``torch.Generator``.

Parameters are plain dicts of tensors with the reference's names and
layouts (``repro.nn.module`` boxes each leaf with logical sharding axes; one
device needs none, so the port keeps the bare values).  Every initializer
draws on the generator's device and returns the tensor there; callers move
the finished tree to its device.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kaiming", "normal_init", "tree_to", "tree_map", "tree_leaves_with_path"]


def kaiming(gen: torch.Generator, shape, fan_in: Optional[int] = None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0] if len(shape) >= 1 else 1
    std = (2.0 / max(fan_in, 1)) ** 0.5
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * std


def normal_init(gen: torch.Generator, shape, std: float = 0.02, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * std


def tree_to(tree, device):
    """Move every leaf of a nested dict of tensors to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts that share ``tree``'s keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """``[(keys, leaf), ...]`` of nested dicts, keys sorted at every level:
    the order ``jax.tree_util`` flattens a dict in, so sums over leaves and
    checkpoint manifests follow the reference's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_leaves_with_path(tree[k], path + (k,))]
    return [(path, tree)]
