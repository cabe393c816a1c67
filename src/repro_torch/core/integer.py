"""Bit-exact integer accumulation simulator (numpy, deliberately outside any
compiled graph).  The port's own copy of ``repro.core.integer``, which is numpy
already: the port imports nothing of the JAX package.

This is the framework's *audit* path: it replays any quantized dot product /
linear layer with true fixed-point accumulator semantics —

* ``exact``     : ideal wide accumulator (int64), the ground truth,
* ``wrap``      : two's-complement wraparound at ``P`` bits (what cheap hardware
                  does on overflow; paper Fig. 2 "black stars"),
* ``saturate``  : clip to the P-bit range *after every MAC* (industry-standard
                  saturation logic; paper Fig. 2 "blue triangles").  Saturation
                  is order-dependent — it breaks associativity (Appendix A.1) —
                  so an explicit MAC ``order`` permutation is supported.

Wraparound is modular arithmetic, hence associative: wrapping once at the end
equals wrapping after every MAC.  We still expose sequential wrapping for the
tests that prove that equivalence.

The simulator is what *proves* A2Q's guarantee in this repo: for A2Q-trained
layers, ``exact == wrap == saturate`` for every input and every MAC order,
because no intermediate partial sum can leave the P-bit range.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np

AccMode = Literal["exact", "wrap", "saturate"]

__all__ = [
    "wrap_to_bits",
    "saturate_to_bits",
    "accumulate_dot",
    "overflow_stats",
    "mac_order_audit",
]


def wrap_to_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement wraparound of int64 values to a ``bits``-wide register."""
    m = np.int64(1) << np.int64(bits)
    half = np.int64(1) << np.int64(bits - 1)
    return ((v.astype(np.int64) + half) % m) - half


def saturate_to_bits(v: np.ndarray, bits: int) -> np.ndarray:
    lo = -(np.int64(1) << np.int64(bits - 1))
    hi = (np.int64(1) << np.int64(bits - 1)) - 1
    return np.clip(v.astype(np.int64), lo, hi)


def _check_int(a: np.ndarray, name: str) -> np.ndarray:
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        if not np.all(a == np.round(a)):
            raise ValueError(f"{name} must hold integers; got non-integral values")
        a = a.astype(np.int64)
    return a.astype(np.int64)


def accumulate_dot(
    x: np.ndarray,
    w: np.ndarray,
    acc_bits: int,
    mode: AccMode = "exact",
    order: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Simulate ``y[b, c] = sum_k x[b, k] * w[k, c]`` in a P-bit accumulator.

    Args:
      x: (B, K) or (K,) integer inputs.
      w: (K, C) or (K,) integer weights.
      acc_bits: accumulator width P (signed).
      mode: accumulator overflow semantics.
      order: optional permutation of ``range(K)`` giving MAC execution order
        (models out-of-order hardware; only observable under ``saturate``).

    Returns (B, C) int64 results under the requested semantics.
    """
    x = _check_int(x, "x")
    w = _check_int(w, "w")
    if x.ndim == 1:
        x = x[None, :]
    if w.ndim == 1:
        w = w[:, None]
    B, K = x.shape
    K2, C = w.shape
    if K != K2:
        raise ValueError(f"K mismatch: x has {K}, w has {K2}")
    if order is None:
        order = np.arange(K)
    order = np.asarray(order)
    if sorted(order.tolist()) != list(range(K)):
        raise ValueError("order must be a permutation of range(K)")

    if mode == "exact":
        return x @ w

    if mode == "wrap":
        # Modular arithmetic is associative: wrapping the exact sum once equals
        # wrapping after every MAC (tested in tests/test_integer.py and
        # tests/test_torch_integer.py). int64
        # holds the exact sum for every (K, M, N) this repo uses.
        return wrap_to_bits(x @ w, acc_bits)

    if mode == "saturate":
        acc = np.zeros((B, C), dtype=np.int64)
        xt = x[:, order]  # (B, K)
        wt = w[order, :]  # (K, C)
        for k in range(K):
            acc = saturate_to_bits(acc + xt[:, k : k + 1] * wt[k : k + 1, :], acc_bits)
        return acc

    raise ValueError(f"unknown accumulator mode {mode!r}")


def overflow_stats(
    x: np.ndarray,
    w: np.ndarray,
    acc_bits: int,
    order: Optional[np.ndarray] = None,
) -> dict:
    """Count intermediate partial sums that leave the P-bit range.

    Uses exact prefix sums (the value a wide register would hold) and counts
    prefixes outside ``[-2**(P-1), 2**(P-1)-1]``.  Returns per-dot-product
    overflow *events* plus the rate (events / (K * B * C)) the paper's Fig. 2
    plots as "overflows per dot product".
    """
    x = _check_int(x, "x")
    w = _check_int(w, "w")
    if x.ndim == 1:
        x = x[None, :]
    if w.ndim == 1:
        w = w[:, None]
    B, K = x.shape
    _, C = w.shape
    if order is None:
        order = np.arange(K)
    lo = -(np.int64(1) << np.int64(acc_bits - 1))
    hi = (np.int64(1) << np.int64(acc_bits - 1)) - 1
    # prefix[b, k, c] = sum of first k+1 MACs — built without materializing
    # (B, K, C) at once for huge K by chunking over C.
    events = 0
    total = 0
    chunk = max(1, int(2**22 // max(K * B, 1)))
    for c0 in range(0, C, chunk):
        wc = w[order][:, c0 : c0 + chunk]  # (K, c)
        prods = x[:, order, None].astype(np.int64) * wc[None, :, :]
        prefix = np.cumsum(prods, axis=1)
        bad = (prefix < lo) | (prefix > hi)
        events += int(bad.sum())
        total += int(np.prod(bad.shape))
    return {
        "events": events,
        "macs": total,
        "dot_products": B * C,
        "overflows_per_dot": events / max(B * C, 1),
        "overflow_rate": events / max(total, 1),
    }


def mac_order_audit(
    x: np.ndarray,
    w: np.ndarray,
    acc_bits: int,
    n_orders: int = 8,
    seed: int = 0,
) -> dict:
    """Replay the dot product under ``n_orders`` random MAC orders with
    saturating accumulators and report the spread of results (Appendix A.1:
    saturation breaks associativity; A2Q-trained layers must show zero spread).
    """
    rng = np.random.default_rng(seed)
    x = _check_int(x, "x")
    w = _check_int(w, "w")
    if x.ndim == 1:
        x = x[None, :]
    if w.ndim == 1:
        w = w[:, None]
    K = x.shape[1]
    exact = accumulate_dot(x, w, 64, mode="exact")
    results = []
    for i in range(n_orders):
        order = np.arange(K) if i == 0 else rng.permutation(K)
        results.append(accumulate_dot(x, w, acc_bits, mode="saturate", order=order))
    stack = np.stack(results)  # (n_orders, B, C)
    spread = stack.max(axis=0) - stack.min(axis=0)
    err = np.abs(stack - exact[None]).astype(np.float64)
    return {
        "max_spread": int(spread.max()),
        "mean_abs_error": float(err.mean()),
        "max_abs_error": float(err.max()),
        "order_invariant": bool(spread.max() == 0),
        "matches_exact": bool(err.max() == 0),
    }
