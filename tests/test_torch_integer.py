"""The port's integer accumulation simulator (``repro_torch.core.integer``)
against the JAX package's, and the property tests that lean on it replayed
on the port's ``core.bounds`` and ``core.a2q``.

The simulator is numpy in both packages, so its results must agree exactly.
The A2Q properties (every column's integer l1 within the P-bit budget, no
overflow for any input and any MAC order, dequantized weights equal to codes
times scales) are the reference's own, driven by the same strategies, on the
port's torch A2Q operator.
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # deterministic parametrized sweep when hypothesis is absent
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

from repro.core import integer as jinteger

from repro_torch.core import bounds
from repro_torch.core.a2q import a2q_int_weights, apply_a2q, init_a2q
from repro_torch.core.integer import (
    accumulate_dot,
    mac_order_audit,
    overflow_stats,
    saturate_to_bits,
    wrap_to_bits,
)

torch.set_num_threads(1)


def test_wrap_and_saturate_match_reference():
    v = np.array([127, 128, -129, 256, -(2**40), 2**40 + 5, 0], np.int64)
    for bits in (4, 8, 16, 24, 32):
        np.testing.assert_array_equal(wrap_to_bits(v, bits), jinteger.wrap_to_bits(v, bits))
        np.testing.assert_array_equal(saturate_to_bits(v, bits),
                                      jinteger.saturate_to_bits(v, bits))
    assert wrap_to_bits(np.int64(128), 8) == -128 and wrap_to_bits(np.int64(256), 8) == 0


@given(
    vals=st.lists(st.integers(-(2**20), 2**20), min_size=1, max_size=64),
    bits=st.integers(4, 24),
)
@settings(max_examples=100, deadline=None)
def test_wrap_is_associative(vals, bits):
    """Wrapping at every step == wrapping the exact sum once (modular)."""
    acc = np.int64(0)
    for v in vals:
        acc = wrap_to_bits(acc + np.int64(v), bits)
    assert acc == wrap_to_bits(np.int64(sum(vals)), bits)


@pytest.mark.parametrize("mode", ["exact", "wrap", "saturate"])
def test_accumulate_dot_matches_reference(mode):
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (6, 97))
    w = rng.integers(-128, 128, (97, 5))
    order = rng.permutation(97)
    for P in (12, 16, 20):
        np.testing.assert_array_equal(accumulate_dot(x, w, P, mode, order=order),
                                      jinteger.accumulate_dot(x, w, P, mode, order=order))
    with pytest.raises(ValueError):
        accumulate_dot(np.ones((1, 3)), np.ones((3, 1)), 8, "saturate", order=np.array([0, 0, 1]))
    with pytest.raises(ValueError):
        accumulate_dot(np.full((1, 2), 0.5), np.ones((2, 1)), 8)


def test_saturate_is_order_dependent():
    w2 = np.array([[100], [100], [-100]])
    x2 = np.array([[1, 1, 1]])
    # 100 + 100 -> 127 (saturated), -100 -> 27; the true sum is 100
    assert int(accumulate_dot(x2, w2, 8, "saturate", order=np.array([0, 1, 2]))[0, 0]) == 27
    assert int(accumulate_dot(x2, w2, 8, "saturate", order=np.array([2, 0, 1]))[0, 0]) == 100


def test_overflow_stats_and_audit_match_reference():
    """Fig. 2's overflow rates and the MAC-order audit, number for number."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (16, 784))
    w = rng.integers(-128, 128, (784, 6))
    rates = []
    for P in (19, 16, 14, 12, 10):
        got = overflow_stats(x, w, P)
        assert got == jinteger.overflow_stats(x, w, P)
        rates.append(got["overflows_per_dot"])
    assert rates[0] == 0.0 and rates == sorted(rates) and rates[-1] > 1.0
    for P in (10, 32):
        audit = mac_order_audit(x, w, acc_bits=P, n_orders=4)
        assert audit == jinteger.mac_order_audit(x, w, acc_bits=P, n_orders=4)
    assert audit["order_invariant"] and audit["matches_exact"]


@given(K=st.integers(1, 2048), N=st.integers(1, 12), M=st.integers(2, 10), signed=st.booleans())
@settings(max_examples=60, deadline=None)
def test_data_type_bound_holds_in_the_simulator(K, N, M, signed):
    """At the port's data-type bound P, the worst-case dot product (every
    input at its largest magnitude, every weight at -2^(M-1)) accumulates
    the same in a wrapping or saturating P-bit register as in the exact one."""
    P = bounds.min_accumulator_bits_data_type(K, N, M, signed)
    lo, hi = bounds.int_range(N, signed)
    x = np.full((1, K), lo if signed else hi, np.int64)
    w = np.full((K, 1), -(2 ** (M - 1)), np.int64)
    exact = accumulate_dot(x, w, 64, "exact")
    np.testing.assert_array_equal(accumulate_dot(x, w, P, "wrap"), exact)
    np.testing.assert_array_equal(accumulate_dot(x, w, P, "saturate"), exact)
    assert overflow_stats(x, w, P)["events"] == 0


@st.composite
def a2q_cases(draw):
    K = draw(st.integers(2, 96))
    C = draw(st.integers(1, 8))
    M = draw(st.integers(3, 8))
    N = draw(st.integers(1, 8))
    P = draw(st.integers(max(N + 2, 4), 24))
    signed = draw(st.booleans())
    seed = draw(st.integers(0, 2**16))
    # arbitrary (t, d) perturbations: the guarantee holds at every point of
    # parameter space, not only at init
    dt = draw(st.floats(-4, 8))
    dd = draw(st.floats(-2, 2))
    return K, C, M, N, P, signed, seed, dt, dd


def _a2q_codes(case):
    K, C, M, N, P, signed, seed, dt, dd = case
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.normal(0, 1.0, (K, C)), dtype=torch.float32)
    p = init_a2q(w, M, P, N, signed)
    p = {"v": p["v"], "t": p["t"] + dt, "d": p["d"] + dd}
    q, s = a2q_int_weights(p, M, P, N, signed)
    return p, q, s, rng


@given(a2q_cases())
@settings(max_examples=60, deadline=None)
def test_integer_weights_respect_l1_budget(case):
    K, C, M, N, P, signed, *_ = case
    _, q, _, _ = _a2q_codes(case)
    l1 = q.abs().sum(0).numpy()
    assert (l1 <= bounds.l1_budget(P, N, signed) + 1e-6).all()


@given(a2q_cases())
@settings(max_examples=30, deadline=None)
def test_no_overflow_any_input_any_order(case):
    K, C, M, N, P, signed, *_ = case
    _, q, _, rng = _a2q_codes(case)
    q = q.numpy().astype(np.int64)
    # adversarial inputs: worst-case magnitudes with signs aligned to weights
    lo, hi = bounds.int_range(N, signed)
    x_rand = rng.integers(lo, hi + 1, (4, K))
    x_worst = np.where(q.sum(1) >= 0, hi, lo)[None, :]
    x = np.concatenate([x_rand, x_worst], axis=0)
    exact = accumulate_dot(x, q, 64, "exact")
    np.testing.assert_array_equal(accumulate_dot(x, q, P, "wrap"), exact)
    for order_seed in range(2):
        order = np.random.default_rng(order_seed).permutation(K)
        np.testing.assert_array_equal(accumulate_dot(x, q, P, "saturate", order=order), exact)
    assert overflow_stats(x, q, P)["events"] == 0


@given(a2q_cases())
@settings(max_examples=30, deadline=None)
def test_dequantized_matches_int_times_scale(case):
    K, C, M, N, P, signed, *_ = case
    p, q, s, _ = _a2q_codes(case)
    np.testing.assert_allclose(apply_a2q(p, M, P, N, signed).numpy(), (q * s).numpy(), rtol=1e-6)
