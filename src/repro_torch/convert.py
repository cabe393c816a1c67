"""Parameter trees from the JAX package into the port, with no reshaping.

``from_jax_numpy`` takes the reference's unboxed parameter tree after
``numpy`` conversion (``jax.tree.map(np.asarray, tree)`` on the caller's
side) — raw A2Q ``v/t/d/aq`` leaves or deployed ``q8/s8`` ones — and returns
the same tree of torch tensors, on ``device``: dicts and lists stay nodes
(the vision networks' ``blocks``, ``enc``, ``dec``).  Layouts are shared, so
no leaf is transposed or reshaped: weights stay ``(K, C_out)`` and stacked
leaves ``(count, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.module import tree_map

__all__ = ["from_jax_numpy"]


def from_jax_numpy(tree, device="cpu"):
    """Tree (nested dicts and lists) of numpy arrays -> the same tree of
    torch tensors on ``device`` (each array copied)."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
