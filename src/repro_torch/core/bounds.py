"""Accumulator bit-width bounds from the A2Q paper (Section 3).

Two lower bounds on the signed accumulator bit width ``P`` required to
guarantee that the dot product ``y = sum_i x_i * w_i`` — *including every
intermediate partial sum, in any accumulation order* — fits without overflow:

* **Data-type bound** (Eq. 8-10): uses only the bit widths ``(K, N, M)``.
* **Weight-norm bound** (Eq. 12-14): uses the frozen weights' l1 norm —
  strictly tighter, and the bound A2Q inverts into a training constraint.

Both are exact transcriptions of the paper's equations.  The functions take
python scalars, numpy arrays or torch tensors and answer in the same kind.

Conventions (paper Section 2.1):
  signed integers of bit width b:  n = -2**(b-1),  p = 2**(b-1) - 1
  unsigned integers of bit width b: n = 0,          p = 2**b - 1
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

Arrayish = Union[float, int, np.ndarray, torch.Tensor]

__all__ = [
    "int_range",
    "phi",
    "alpha_term",
    "beta_term",
    "data_type_bound",
    "weight_norm_bound",
    "l1_budget",
    "min_accumulator_bits_data_type",
    "min_accumulator_bits_weights",
    "headroom_utilization",
    "verify_no_overflow",
]


def int_range(bits: int, signed: bool) -> tuple[int, int]:
    """(n, p) clipping range for a ``bits``-wide integer (paper Sec. 2.1)."""
    if bits <= 0:
        raise ValueError(f"bit width must be positive, got {bits}")
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2**bits - 1


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64), torch
    return np.asarray(x, dtype=np.float64), np


def phi(x: Arrayish):
    """``phi(a) = log2(1 + 2**-a)`` — Eq. 10 / Eq. 14 correction term (log1p
    keeps it stable at large ``a``, where ``2**-a`` underflows to 0)."""
    xn, mod = _f64(x)
    return mod.log1p(mod.exp2(-xn)) / math.log(2.0)


def alpha_term(K: Arrayish, N: int, M: int, signed_input: bool):
    """Eq. 9: ``alpha = log2(K) + N + M - 1 - 1_signed(x)``."""
    k, mod = _f64(K)
    return mod.log2(k) + N + M - 1 - int(signed_input)


def beta_term(l1_norm: Arrayish, N: int, signed_input: bool):
    """Eq. 13: ``beta = log2(||w||_1) + N - 1_signed(x)``."""
    l1, mod = _f64(l1_norm)
    return mod.log2(l1) + N - int(signed_input)


def data_type_bound(K: Arrayish, N: int, M: int, signed_input: bool):
    """Eq. 8: real-valued lower bound ``P >= alpha + phi(alpha) + 1``."""
    a = alpha_term(K, N, M, signed_input)
    return a + phi(a) + 1.0


def weight_norm_bound(l1_norm: Arrayish, N: int, signed_input: bool):
    """Eq. 12: real-valued lower bound ``P >= beta + phi(beta) + 1``, with
    ``l1_norm`` the l1 norm of one output channel's *integer* weights."""
    b = beta_term(l1_norm, N, signed_input)
    return b + phi(b) + 1.0


# At an exact power-of-two boundary (e.g. ||w||_1 == the Eq. 15 budget) the
# real-valued bound equals the integer P exactly; float64 rounding can land
# epsilon above it and ceil one bit too high.
_CEIL_EPS = 1e-9


def min_accumulator_bits_data_type(K: int, N: int, M: int, signed_input: bool) -> int:
    """Smallest integer P satisfying the data-type bound (Eq. 8)."""
    return int(math.ceil(float(data_type_bound(K, N, M, signed_input)) - _CEIL_EPS))


def min_accumulator_bits_weights(l1_norm: float, N: int, signed_input: bool) -> int:
    """Smallest integer P satisfying the weight-norm bound (Eq. 12); a zero-l1
    channel still needs the minimum signed register."""
    if l1_norm <= 0:
        return 2
    return max(2, int(math.ceil(float(weight_norm_bound(l1_norm, N, signed_input)) - _CEIL_EPS)))


def l1_budget(P: int, N: int, signed_input: bool):
    """Eq. 15: per-channel budget ``||w||_1 <= (2**(P-1) - 1) * 2**(1_signed - N)``."""
    if P < 2:
        raise ValueError(f"accumulator width must be >= 2 bits, got P={P}")
    return float(2 ** (P - 1) - 1) * 2.0 ** (int(signed_input) - N)


def headroom_utilization(l1_norm: Arrayish, N: int, signed_input: bool, P: int):
    """Worst-case fraction of a P-bit signed accumulator used by a channel with
    integer-weight l1 norm ``l1_norm`` and ``N``-bit inputs (Eq. 11 as a
    ratio): <= 1.0 iff overflow is provably impossible in any order."""
    if P < 2:
        raise ValueError(f"accumulator width must be >= 2 bits, got P={P}")
    l1, _ = _f64(l1_norm)
    return l1 * 2.0 ** (N - int(signed_input)) / float(2 ** (P - 1) - 1)


def verify_no_overflow(weights_int, N: int, signed_input: bool, P: int) -> bool:
    """Check Eq. 11 for a (C_out, K) integer weight matrix: True iff a P-bit
    signed accumulator provably cannot overflow for *any* N-bit input."""
    if isinstance(weights_int, torch.Tensor):
        weights_int = weights_int.detach().cpu().numpy()
    w = np.asarray(weights_int, dtype=np.float64)
    if w.ndim == 1:
        w = w[None, :]
    l1 = np.abs(w).sum(axis=-1)
    worst = l1 * 2.0 ** (N - int(signed_input))
    return bool(np.all(worst <= 2 ** (P - 1) - 1))
