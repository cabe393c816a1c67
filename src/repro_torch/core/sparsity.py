"""Weight-sparsity accounting (paper Sec. 5.2.1 / Fig. 5), as
``repro.core.sparsity`` computes it.

A2Q's l1 budget tightens exponentially as the accumulator width P shrinks
(Eq. 15/18/23), which drives unstructured sparsity in the *integer* weights —
the quantity that matters for deployment (zero integer weights are skippable
MACs and compressible memory).  These helpers measure it in numpy, over
trees (nested dicts and lists) of integer tensors or arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.module import keystr, tree_leaves_with_path

__all__ = ["tensor_sparsity", "tree_sparsity", "pack_sparse_count"]


def _np(w) -> np.ndarray:
    return w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)


def tensor_sparsity(w_int) -> float:
    """Fraction of exactly-zero entries in an integer weight tensor."""
    w = _np(w_int)
    if w.size == 0:
        return 0.0
    return float(np.mean(w == 0))


def tree_sparsity(int_weight_tree) -> dict:
    """Aggregate sparsity over a tree of integer weight tensors.

    Returns overall sparsity plus a per-leaf breakdown keyed by tree path,
    spelled as the reference's ``jax.tree_util.keystr`` spells it (e.g.
    ``['blocks'][0]['c1']``), leaves in its flattening order."""
    per_leaf = {}
    zeros = 0
    total = 0
    for path, leaf in tree_leaves_with_path(int_weight_tree):
        leaf = _np(leaf)
        z = int(np.sum(leaf == 0))
        per_leaf[keystr(path)] = z / max(leaf.size, 1)
        zeros += z
        total += leaf.size
    return {"overall": zeros / max(total, 1), "per_leaf": per_leaf, "params": total}


def pack_sparse_count(w_int) -> dict:
    """Size accounting for a CSR-style packing of an integer weight matrix —
    the memory-roofline payoff of A2Q sparsity (Sec. 6 'Discussion')."""
    w = _np(w_int)
    nnz = int(np.count_nonzero(w))
    dense_bits = w.size * 8  # int8 storage
    # values (8b) + column indices (16b suffices for K <= 65536) + row pointers
    packed_bits = nnz * (8 + 16) + (w.shape[0] + 1 if w.ndim > 1 else 2) * 32
    return {
        "nnz": nnz,
        "dense_bytes": dense_bits // 8,
        "packed_bytes": packed_bits // 8,
        "compression": dense_bits / max(packed_bits, 1),
    }
