"""The port's kernel ops against the JAX package's oracles.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold it against ``repro.kernels.ref`` on the same numpy
inputs, and one small case per kernel against ``repro.kernels.ops`` in Pallas
interpret mode.  Tolerances: integer results and the fused epilogue — exact
(the plain version rounds the multiply and the add once each, as the oracle
does); paged attention — 1e-5 (fp32 softmax, summed in another order).

``test_torch_cuda.py`` holds the CUDA kernels against their plain versions
on a card; ``chip_smoke.py`` does the same at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops
from repro_torch.kernels import ref

torch.set_num_threads(1)


def _a2q_bounded_w(rng, K, N, nnz=10, amp=25):
    """int8 weights whose column l1 norms (<= nnz * amp = 250) fit the A2Q
    budget of P=16 with signed 8-bit inputs ((2^15 - 1) / 2^7 = 255.99), so
    every partial sum fits the int16 carry."""
    w = np.zeros((K, N), np.int8)
    for n in range(N):
        rows = rng.choice(K, size=min(nnz, K), replace=False)
        w[rows, n] = rng.integers(-amp, amp + 1, rows.size)
    return w


def _bk(K):
    return min(512, -(-K // 128) * 128)


@pytest.mark.parametrize("K", [100, 576, 1536])
@pytest.mark.parametrize("mode", ["exact", "wrap", "saturate"])
def test_int_matmul_plain_matches_ref_int16_carry(K, mode):
    """int16 carry at acc_bits=16 in every mode: ``exact`` on A2Q-bounded
    weights (lossless by the bound), ``wrap``/``saturate`` on full-range
    weights that overflow 16 bits, replayed at the reference K-tiles."""
    rng = np.random.default_rng(K)
    M, N = 7, 40
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = _a2q_bounded_w(rng, K, N) if mode == "exact" else rng.integers(-128, 128, (K, N)).astype(np.int8)
    want = jref.ref_int_matmul(jnp.asarray(x), jnp.asarray(w), acc_bits=16, mode=mode, block_k=_bk(K))
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), acc_bits=16, mode=mode,
                         spill_int16=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [100, 576, 1536])
def test_int_matmul_plain_fused_matches_ref(K):
    """Fused epilogue ``(acc + offset) * scale + bias`` bit for bit, with the
    unsigned-symmetrization offset ``128 * colsum(w)`` and without."""
    rng = np.random.default_rng(K + 1)
    M, N = 5, 48
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = _a2q_bounded_w(rng, K, N)
    scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    kw = dict(acc_bits=16, spill_int16=True, scale=torch.from_numpy(scale))
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), bias=torch.from_numpy(bias), **kw)
    want = jref.ref_int_matmul_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     jnp.asarray(bias), acc_bits=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_u = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), in_signed=False, **kw)
    offset = 128 * w.astype(np.int32).sum(0)
    want_u = jref.ref_int_matmul_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                       offset=jnp.asarray(offset), acc_bits=16)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


@pytest.mark.parametrize("mode", ["exact", "wrap", "saturate"])
def test_ref_int_matmul_twins_match_jax_oracles(mode):
    """The port's oracles (``kernels/ref.py``) against the JAX ones: int32
    accumulators exact in every mode, the fused rescale + bias bit for bit."""
    rng = np.random.default_rng(12)
    x = rng.integers(-128, 128, (6, 300)).astype(np.int8)
    w = rng.integers(-128, 128, (300, 20)).astype(np.int8)
    scale = rng.uniform(1e-4, 1e-2, 20).astype(np.float32)
    bias = rng.normal(size=20).astype(np.float32)
    jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x), torch.from_numpy(w)
    want = jref.ref_int_matmul(jx, jw, acc_bits=16, mode=mode, block_k=128)
    got = ref.ref_int_matmul(tx, tw, acc_bits=16, mode=mode, block_k=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jref.ref_int_matmul_fused(jx, jw, jnp.asarray(scale), jnp.asarray(bias), acc_bits=16,
                                     mode=mode, block_k=128)
    got = ref.ref_int_matmul_fused(tx, tw, torch.from_numpy(scale), torch.from_numpy(bias),
                                   acc_bits=16, mode=mode, block_k=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_matmul_matches_pallas_interpret():
    """One small case against the Pallas kernel itself (interpret mode):
    saturating 16-bit accumulator with the int16 carry, and the fused path."""
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (9, 300)).astype(np.int8)
    w = rng.integers(-128, 128, (300, 70)).astype(np.int8)
    for kw in (dict(acc_bits=16, mode="saturate", spill_int16=True),
               dict(scale=np.full(70, 0.01, np.float32))):
        want = jops.int_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True,
                               **{k: jnp.asarray(v) if k == "scale" else v for k, v in kw.items()})
        got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             **{k: torch.from_numpy(v) if k == "scale" else v for k, v in kw.items()})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_matmul_argument_checks():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.int_matmul(x, w, acc_bits=24, spill_int16=True)
    with pytest.raises(ValueError):
        ops.int_matmul(x, w, bias=torch.zeros(4))
    with pytest.raises(ValueError):  # the requant epilogue follows the fused one
        ops.int_matmul(x, w, out_scale=1.0)


def _paged_case(rng, B=5, H=8, KV=2, Dh=16, NB=12, bs=4, MB=3, dtype=np.float32):
    q = rng.normal(size=(B, H, Dh)).astype(dtype)
    kp = rng.normal(size=(NB, bs, KV, Dh)).astype(dtype)
    vp = rng.normal(size=(NB, bs, KV, Dh)).astype(dtype)
    # row 0 full, row 1 ragged, row 2 empty (length 0), rows 3-4 end in
    # trash entries (block 0) past their lengths
    bt = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0], [9, 0, 0]], np.int32)[:B]
    lengths = np.asarray([12, 9, 0, 5, 1], np.int32)[:B]
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("window", [None, 3])
def test_paged_attention_plain_matches_ref(window):
    """Trash entries, a zero-length row (zeros, no NaN) and a sliding window."""
    args = _paged_case(np.random.default_rng(4))
    want = jref.ref_paged_attention(*(jnp.asarray(a) for a in args), window=window)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not np.isnan(got.numpy()).any() and (got.numpy()[2] == 0).all()


def test_paged_attention_matches_pallas_interpret():
    args = _paged_case(np.random.default_rng(5))
    want = jops.paged_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = ops.paged_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_attention_argument_checks():
    q, kp, vp, bt, lengths = (torch.from_numpy(a) for a in _paged_case(np.random.default_rng(6)))
    with pytest.raises(ValueError):
        ops.paged_attention(q, kp, vp, bt, lengths, window=0)
    with pytest.raises(ValueError):  # integer pools: kps and vps come together
        ops.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), bt, lengths,
                            kps=torch.ones(kp.shape[:3]))
    with pytest.raises(ValueError):  # packed int4 pools need their scale pools
        ops.paged_attention(q, kp[..., ::2].to(torch.uint8), vp[..., ::2].to(torch.uint8), bt,
                            lengths)
