"""The chunked ``rwkv6_scan`` kernel's algorithm on the CPU, where the kernel
cannot run: ``rwkv6_scan_subchunk_plain`` (its sub-chunk algorithm in plain
PyTorch) against the JAX package and against the step-by-step plain scan,
and the kernel's launch split.

Covered:

* the transcript against JAX's ``rwkv6_sequential`` (no floor) and
  ``rwkv6_chunked`` (the log-decay clamped at -8, here ``min_w = e^-8``) at
  ragged T in {1, 15, 16, 33, 64, 100}, from a zero and a carried state,
  with decays of exactly 0, a subnormal, 1e-30 and 1 at sparse positions;
* the transcript against ``rwkv6_scan_plain`` within the card's gate, with
  fp32 products and with the kernel's bf16 tensor-core products, T split
  into 1, 3 or 8 runs (the in-order combine of their states), floored and
  not, the state written in place;
* ``chunk_split``: whole 16-token sub-chunks, at most 8 segments, none
  empty.

Tolerances: against JAX 1e-4 (``test_torch_rwkv6.py``'s ``TOL``: fp32 sums
of up to 100 steps in another order, through exp2/log2); against the plain
scan 1e-5 of the largest |y| and |S| (the card's gate for the kernel).

The cases of a test loop inside it over the state and the decays: under
``pytest -n 6 --dist loadfile`` pytest-xdist queues files by their number
of test ids, and this file stays below ``tests/test_paged.py``'s so the
files ahead of that one keep their order (its ``[4]`` case crashes a
worker, and a crash after the queue has emptied leaves its file unfinished
and the run waiting).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm

from repro_torch.kernels.rwkv6_scan import (
    chunk_split,
    rwkv6_scan_plain,
    rwkv6_scan_subchunk_plain,
)

torch.set_num_threads(1)

TOL = 1e-4
# decays the chunked kernel must take at the edge of its clamp (w = 0 would
# give log 0 = -inf and -inf - -inf = NaN without it), set at sparse positions
EDGE_DECAYS = {"zero": 0.0, "subnormal": 1e-39, "at_clamp": 1e-30, "one": 1.0}
_JAX = {"sequential": jax.jit(jssm.rwkv6_sequential),
        "chunked": jax.jit(jssm.rwkv6_chunked, static_argnames="chunk")}


def _inputs(T, carried, decay, seed, B=2, H=3, Dk=32, Dv=24):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(B, H, T, Dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, T, Dv)).astype(np.float32)
    w = rng.uniform(0.5, 0.999, size=(B, H, T, Dk)).astype(np.float32)
    u = rng.normal(size=(H, Dk)).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = EDGE_DECAYS[decay]
    s0 = rng.normal(size=(B, H, Dk, Dv)).astype(np.float32) if carried else \
        np.zeros((B, H, Dk, Dv), np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T", [1, 15, 16, 33, 64, 100])
@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_rwkv6_scan_subchunk_plain_matches_jax(form, T):
    """The chunked kernel's sub-chunk algorithm against JAX's sequential
    form (no floor) and chunked form (``min_w = e^-8``), from a zero and a
    carried state, at each edge decay, to ``TOL``.  JAX's chunked form
    factors its decays through ``exp(+|logA|)``, so its chunk is kept at 16
    tokens or fewer (a divisor of T) where that stays in fp32; the
    transcript needs no such limit."""
    for carried in (False, True):
        for decay in EDGE_DECAYS:
            r, k, v, w, u, s0 = _inputs(T, carried, decay, seed=100 * T + carried)
            jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
            if form == "sequential":
                jy, js = _JAX[form](*jargs)
                min_w = None
            else:
                chunk = max(c for c in range(1, 17) if T % c == 0)
                jy, js = _JAX[form](*jargs, chunk=chunk)
                min_w = math.exp(-8.0)
            y, s = rwkv6_scan_subchunk_plain(
                *(torch.from_numpy(a) for a in (r, k, v, w, u)),
                torch.from_numpy(s0) if carried else None, out_dtype=torch.float32, min_w=min_w)
            assert np.isfinite(y.numpy()).all() and np.isfinite(s.numpy()).all(), (carried, decay)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, err_msg=decay)
            np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL, err_msg=decay)


@pytest.mark.parametrize("bf16_terms", [False, True], ids=["fp32_products", "bf16_terms"])
@pytest.mark.parametrize("T", [16, 37, 300])
def test_rwkv6_scan_subchunk_plain_within_the_card_gate(T, bf16_terms):
    """The transcript against the step-by-step ``rwkv6_scan_plain`` within
    the card's gate, 1e-5 of the largest |y| and |S| (fp32 y): with fp32
    products, and with the kernel's bf16 tensor-core products (the computed
    operand in three terms, the state and v in two), T split into up to 1,
    3 or 8 runs (the in-order combine of the runs' states), floored and
    not, fp32 inputs (v's lo term is not zero) and edge decays, the state
    written in place."""
    for segments in (1, 3, 8):
        for floor in (False, True):
            r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                                 _inputs(T, True, "zero", seed=T + segments, B=1, H=2))
            w[..., 1::9] = 1e-39
            w[..., 2::11] = 1.0
            kw = dict(out_dtype=torch.float32, min_w=math.exp(-8.0) if floor else None)
            want_y, want_s = rwkv6_scan_plain(r, k, v, w, u, s0, **kw)
            state = s0.clone()
            y, s = rwkv6_scan_subchunk_plain(r, k, v, w, u, state, state_out=state,
                                             segments=segments, bf16_terms=bf16_terms, **kw)
            assert s is state and y.dtype == torch.float32
            assert (y - want_y).abs().max() <= 1e-5 * want_y.abs().max(), (segments, floor)
            assert (s - want_s).abs().max() <= 1e-5 * want_s.abs().max(), (segments, floor)


@pytest.mark.parametrize("B,H,T", [(1, 64, 8), (1, 64, 32), (1, 64, 64), (1, 64, 100),
                                   (1, 64, 512), (1, 64, 1024), (1, 64, 4096), (8, 64, 64),
                                   (8, 64, 4096), (2, 3, 37), (1, 1, 1)])
def test_chunk_split_covers_t_in_whole_sub_chunks(B, H, T):
    """The chunked kernel's launch split: at most 8 segments (a portable
    cluster) of whole 16-token sub-chunks, none empty, covering T; one
    segment a head when two would not fit one block an SM (132) or T is
    under 64; rwkv6-7b's 64 heads take two from 64 tokens on."""
    n, seg = chunk_split(B, H, T)
    assert 1 <= n <= 8 and seg % 16 == 0 and (n - 1) * seg < T <= n * seg
    if 2 * B * H > 132 or T < 64:
        assert n == 1
    if (B, H) == (1, 64) and T >= 64:
        assert (n, seg) == (2, -(-T // 32) * 16)
