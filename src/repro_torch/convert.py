"""Parameter trees from the JAX package into the port, with no reshaping.

``from_jax_numpy`` takes the reference's unboxed parameter tree after
``numpy`` conversion (``jax.tree.map(np.asarray, tree)`` on the caller's
side) — raw A2Q ``v/t/d/aq`` leaves or deployed ``q8/s8`` ones — and returns
the same nested dict of torch tensors, on ``device``.  Layouts are shared, so
no leaf is transposed or reshaped: weights stay ``(K, C_out)`` and stacked
leaves ``(count, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_jax_numpy"]


def from_jax_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same nested dict of torch tensors
    on ``device`` (each array copied)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
