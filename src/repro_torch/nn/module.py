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

__all__ = ["kaiming", "normal_init", "tree_to", "tree_map", "tree_map_with_path", "tree_unzip",
           "tree_leaves_with_path", "keystr"]


def kaiming(gen: torch.Generator, shape, fan_in: Optional[int] = None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0] if len(shape) >= 1 else 1
    std = (2.0 / max(fan_in, 1)) ** 0.5
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * std


def normal_init(gen: torch.Generator, shape, std: float = 0.02, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device) * std


# A tree is nested dicts and lists (the vision networks' ``blocks``, ``enc``
# and ``dec``); anything else, a tuple included, is a leaf.


def tree_to(tree, device):
    """Move every leaf of a tree of tensors to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees that share ``tree``'s structure (a
    ``rest`` tree's nodes are indexed by ``tree``'s keys, so its leaves may
    be subtrees: they arrive whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(keys, leaf)`` over the leaves of ``tree``, the same structure out
    (``keys`` as ``tree_leaves_with_path`` gives them)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_unzip(tree, n: int):
    """A tree whose leaves are n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def tree_leaves_with_path(tree, path=()):
    """``[(keys, leaf), ...]``, dict keys sorted at every level and list
    items in index order (an item's key is its index): the order
    ``jax.tree_util`` flattens a tree in, so sums over leaves and checkpoint
    manifests follow the reference's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def keystr(path) -> str:
    """A ``tree_leaves_with_path`` key path as ``jax.tree_util.keystr``
    writes it: ``"['blocks'][0]['c1']"``."""
    return "".join(f"[{k!r}]" for k in path)
