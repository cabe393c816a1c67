"""The port's kernel ops against the JAX package's oracles.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold it against ``repro.kernels.ref`` on the same numpy
inputs, and one small case per kernel against ``repro.kernels.ops`` in Pallas
interpret mode.  Tolerances: integer results and the fused epilogue — exact
(the plain version rounds the multiply and the add once each, as the oracle
does); paged attention — 1e-5 (fp32 softmax, summed in another order); the
A2Q quantizer — codes exact and dequantized weights to 1e-6 given JAX's
per-column scales (``jnp.exp2`` and ``torch.exp2`` differ in the last bits,
which can flip a code); flash attention — 2e-5 in fp32 (as the reference's
own test), plus one bf16 ulp of the output in bf16; the gelu requant epilogue —
codes exact except +-1 where the value lies at a rounding tie (the
written-out tanh gelu and ``jax.nn.gelu`` differ in the last fp32 bits).

The decode kernels' split arithmetic (``int_matmul_split_plain``,
``paged_attention_split_plain``) is held to the same oracles: integers
exact, attention to 1e-5; and the unsigned operand's column sums are kept
per weight (``ops.symmetrization_offset``).  ``a2q_quantize``'s
cluster-split l1 order (``a2q_l1_split_plain``) is ``pairwise_sum`` bit for
bit and its codes the JAX oracle's; the tensor-core MLA kernel's arithmetic
(``paged_mla_attention_tc_plain``) is held at deepseek-v3's widths to the
plain version and the jnp oracle within 2e-5 (chip_smoke's MLA_TOL).

``test_torch_cuda.py`` holds the CUDA kernels against their plain versions
on a card; ``chip_smoke.py`` does the same at the main path's shapes.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - exercised only without hypothesis
    from _hypothesis_fallback import given, settings
    from _hypothesis_fallback import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.a2q import a2q_int_weights
from repro_torch.core.bounds import l1_budget
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.a2q_quantize import a2q_quantize_plain
from repro_torch.kernels.ops import int_matmul_block_k
from repro_torch.nn.linear import deploy_linear, init_linear

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


# ---------------------------------------------------------------------------
# The int_matmul requant epilogue's gelu replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cast", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_requant_gelu_matches_jax_oracle(cast):
    """The non-gated MLP's chained edge (``w_in -> gelu -> w_out``, biased,
    signed 8-bit codes out): the plain requant flush against JAX's
    ``ref_int_matmul_requant(act_fn="gelu")``.  Codes agree exactly except
    +-1 at elements whose value lies within a rounding of the replay dtype
    of a .5 tie; the port's own oracle agrees exactly."""
    rng = np.random.default_rng(41)
    M, K, N = 24, 320, 96
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = _a2q_bounded_w(rng, K, N)
    scale = rng.uniform(2e-3, 8e-3, N).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    out_scale = np.asarray(jnp.exp2(jnp.asarray(rng.uniform(-5.5, -4.5, N), jnp.float32)))
    tcast = torch.float32 if cast == jnp.float32 else torch.bfloat16
    want = np.asarray(jref.ref_int_matmul_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(out_scale),
        bias=jnp.asarray(bias), act_fn="gelu", cast_dtype=cast, acc_bits=16))
    kw = dict(scale=torch.from_numpy(scale), bias=torch.from_numpy(bias),
              out_scale=torch.from_numpy(out_scale), act_fn="gelu", cast_dtype=tcast)
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), acc_bits=16, spill_int16=True,
                         **kw)
    assert got.dtype == torch.int8
    assert torch.equal(got, ref.ref_int_matmul_requant(torch.from_numpy(x), torch.from_numpy(w),
                                                       acc_bits=16, **kw))
    # JAX's value before rounding, and the width of one rounding of it
    y = jref.ref_int_matmul_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                  jnp.asarray(bias), acc_bits=16).astype(cast)
    y = np.asarray(jax.nn.gelu(y.astype(jnp.float32)).astype(cast).astype(jnp.float32))
    ratio = y / out_scale
    ulp = np.spacing(np.abs(y).astype(np.float32)) * (1 if cast == jnp.float32 else 2.0**16)
    tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) <= 2 * ulp / out_scale
    diff = got.numpy().astype(np.int32) - want.astype(np.int32)
    assert np.abs(diff).max() <= 1 and not (diff != 0)[~tie].any(), (diff != 0).sum()
    assert len(np.unique(want)) > 50  # the codes span their range


# ---------------------------------------------------------------------------
# a2q_quantize
# ---------------------------------------------------------------------------


def _a2q_case(rng, K, C):
    v = rng.normal(size=(K, C)).astype(np.float32)
    t = (rng.normal(size=(C,)) + 3).astype(np.float32)
    d = (rng.normal(size=(C,)) - 6).astype(np.float32)
    return v, t, d


@pytest.mark.parametrize("K,C", [(300, 130), (512, 256), (17, 5), (1024, 64)])
@pytest.mark.parametrize("acc_bits,input_signed", [(16, False), (20, True), (12, False)])
def test_a2q_quantize_plain_matches_ref(K, C, acc_bits, input_signed):
    """The reference's cases: the plain quantizer given JAX's per-column
    ``g/s`` and ``s`` equals ``ref_a2q_quantize`` (codes exact, dequantized
    to 1e-6); ``ops.a2q_quantize``'s codes and scales equal the port's own
    oracle (``q * s`` its dequantized weights) and ``a2q_int_weights``
    exactly."""
    v, t, d = _a2q_case(np.random.default_rng(K * C + acc_bits), K, C)
    jv, jt, jd = jnp.asarray(v), jnp.asarray(t), jnp.asarray(d)
    deq_r, q_r = jref.ref_a2q_quantize(jv, jt, jd, 8, acc_bits, 8, input_signed)
    T = int(input_signed) + jnp.log2(jnp.float32(2.0 ** (acc_bits - 1) - 1.0)) + jd - 8
    gs, s = jnp.exp2(jnp.minimum(jt, T) - jd), jnp.exp2(jd)
    deq, q, _ = a2q_quantize_plain(torch.from_numpy(v), torch.from_numpy(np.asarray(gs)),
                                   torch.from_numpy(np.asarray(s)), n=-128, p=127)
    np.testing.assert_array_equal(q.numpy().astype(np.int32), np.asarray(q_r))
    np.testing.assert_allclose(deq.numpy(), np.asarray(deq_r), rtol=0, atol=1e-6)
    tv, tt, td = torch.from_numpy(v), torch.from_numpy(t), torch.from_numpy(d)
    q, s = ops.a2q_quantize(tv, tt, td, weight_bits=8, acc_bits=acc_bits, input_bits=8,
                            input_signed=input_signed)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (C,)
    deq_t, q_t = ref.ref_a2q_quantize(tv, tt, td, 8, acc_bits, 8, input_signed)
    assert torch.equal(q.to(torch.int32), q_t) and torch.equal(q * s, deq_t)
    q_w, s_w = a2q_int_weights({"v": tv, "t": tt, "d": td}, 8, acc_bits, 8, input_signed)
    assert torch.equal(q.to(torch.float32), q_w) and torch.equal(s, s_w)


@pytest.mark.parametrize("K", [640, 24])
def test_a2q_quantize_budget_invariant(K):
    """Every column's integer l1 norm fits the Eq. 15 budget, norms over the
    cap included: the reference's invariant (K = 640) on the port, and at a
    short K where the codes come close to the budget."""
    rng = np.random.default_rng(43)
    v = torch.from_numpy(rng.normal(size=(K, 256)).astype(np.float32))
    t = torch.from_numpy((rng.normal(size=(256,)) + 6).astype(np.float32))  # over the cap
    d = torch.from_numpy((rng.normal(size=(256,)) - 5).astype(np.float32))
    q, _ = ops.a2q_quantize(v, t, d, weight_bits=8, acc_bits=14, input_bits=8,
                            input_signed=False)
    l1 = q.to(torch.int64).abs().sum(0)
    assert (l1 <= l1_budget(14, 8, False)).all()
    if K < 32:
        assert l1.max() >= 0.75 * l1_budget(14, 8, False)


@pytest.mark.parametrize("boundary,signed", [(False, True), (False, False), (True, True)])
def test_deploy_linear_through_ops_equals_a2q_int_weights(boundary, signed):
    """``deploy_linear`` quantizes through ``ops.a2q_quantize``: its codes and
    scales are ``a2q_int_weights``'."""
    from repro_torch.configs import get_arch

    q = get_arch("smollm-135m").quant
    p = init_linear(torch.Generator().manual_seed(7), 320, 96, q, boundary=boundary,
                    input_signed=signed)
    dep = deploy_linear(p, q, boundary=boundary, input_signed=signed)
    M, N = (q.boundary_bits, q.boundary_bits) if boundary else (q.weight_bits, q.act_bits)
    want_q, want_s = a2q_int_weights(p, M, q.acc_bits, N, signed)
    assert dep["q8"].dtype == torch.int8 and torch.equal(dep["q8"].to(torch.float32), want_q)
    assert torch.equal(dep["s8"], want_s)


def test_deployed_code_flips_holds_every_matrix_of_a_cpu_deploy(monkeypatch):
    """The deploy check chip_smoke.py runs on the card, on a reduced model
    deployed on the CPU: every A2Q matrix ``deploy_params`` quantizes is
    held to the plain quantizer, with 0 flips."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.a2q_quantize import deployed_code_flips
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import deploy_params

    arch = reduced(get_arch("hubert-xlarge"))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")

    def matrices(tree):
        if isinstance(tree, dict):
            if "v" in tree:
                return int(np.prod(tree["v"].shape[:-2]))
            return sum(matrices(t) for t in tree.values())
        return 0

    plain, held = ops.a2q_quantize_plain, []

    def checked(v, gs, s, *, n, p, dequantize=True):
        deq, q, l1 = plain(v, gs, s, n=n, p=p, dequantize=dequantize)
        held.append(deployed_code_flips(q, l1, v, gs, s, n=n, p=p))
        return deq, q, l1

    monkeypatch.setattr(ops, "a2q_quantize_plain", checked)
    deploy_params(params, arch.quant)
    assert len(held) == matrices(params) > 0
    assert all(h == (0, True) for h in held)


def test_deployed_code_flips_reports_a_code_changed_by_hand():
    """One code moved by hand where ``g/s * v / l1`` lies far from any
    integer: the check counts one flip and does not explain it."""
    from repro_torch.configs import get_arch
    from repro_torch.core.a2q import _effective_gs
    from repro_torch.kernels.a2q_quantize import deployed_code_flips

    quant = get_arch("hubert-xlarge").quant
    p = init_linear(torch.Generator().manual_seed(5), 256, 64, quant)
    gs, s = _effective_gs(p, quant.acc_bits, quant.act_bits, True)
    _, q, l1 = a2q_quantize_plain(p["v"], gs, s, n=-128, p=127)
    assert deployed_code_flips(q, l1, p["v"], gs, s, n=-128, p=127) == (0, True)
    r = gs[None, :] * p["v"] / l1[None, :]
    far = ((r - torch.round(r)).abs() - 0.5).abs().argmin()  # a fraction nearest .5
    assert ((r - torch.round(r)).abs().reshape(-1)[far] > 0.4).item()
    moved = q.clone()
    moved.view(-1)[far] += 1 if moved.view(-1)[far] < 127 else -1
    assert deployed_code_flips(moved, l1, p["v"], gs, s, n=-128, p=127) == (1, False)


def test_a2q_quantize_argument_checks():
    v, t, d = torch.zeros((8, 4)), torch.zeros(4), torch.zeros(4)
    with pytest.raises(ValueError):
        ops.a2q_quantize(v, t[:3], d, weight_bits=8, acc_bits=16, input_bits=8,
                         input_signed=True)
    with pytest.raises(ValueError):  # codes past int8
        ops.a2q_quantize(v, t, d, weight_bits=9, acc_bits=16, input_bits=8, input_signed=True)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Tq,Tk,causal,window,D", [
    (100, 100, True, None, 64),
    (100, 100, True, 17, 64),
    (64, 64, False, None, 64),
    (1, 100, True, None, 64),     # decode
    (1, 100, True, 32, 64),       # windowed decode
    (96, 128, True, None, 64),    # Tq < Tk end-aligned
    (100, 100, False, None, 80),  # hubert's head size, bidirectional
    (70, 90, True, 25, 80),
])
def test_flash_attention_plain_matches_ref(Tq, Tk, causal, window, D):
    """The reference's cases plus D = 80, against ``ref_flash_attention``."""
    rng = np.random.default_rng(Tq + Tk + D)
    B, H = 2, 3
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32) for T in (Tq, Tk, Tk))
    want = jref.ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_gqa_and_dtypes(dtype):
    """Query heads grouped over fewer KV heads by index, against the oracle
    on the repeated heads; output in q's dtype, in bf16 within the fp32
    tolerance plus one bf16 ulp (the two round sums that differ in their last
    fp32 bits)."""
    rng = np.random.default_rng(47)
    B, H, KV, T, D = 2, 6, 2, 48, 32
    q = jnp.asarray(rng.normal(size=(B, H, T, D)), dtype)
    k, v = (jnp.asarray(rng.normal(size=(B, KV, T, D)), dtype) for _ in range(2))
    want = np.asarray(jref.ref_flash_attention(q, jnp.repeat(k, H // KV, 1),
                                               jnp.repeat(v, H // KV, 1)).astype(jnp.float32))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt)

    got = ops.flash_attention(t(q), t(k), t(v))
    assert got.dtype == tdt and got.shape == (B, H, T, D)
    got = got.to(torch.float32).numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    else:
        # the fp32 summation-order tolerance, then one rounding to bf16
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2.0**16
        assert (np.abs(got - want) <= 2e-5 + ulp).all()


@pytest.mark.parametrize("q_chunk", [1, 7, 64])
def test_flash_attention_plain_query_chunks(q_chunk):
    """The plain version a query chunk at a time (the layer passes the
    arch's ``attn_q_chunk``) against the oracle: end-aligned, causal with a
    window, queries with no key included."""
    rng = np.random.default_rng(59 + q_chunk)
    q = rng.normal(size=(2, 3, 20, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 3, 24, 16)).astype(np.float32) for _ in range(2))
    want = jref.ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=6)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              window=6, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    got = ops.flash_attention(torch.from_numpy(q[:, :, :4]), torch.from_numpy(k[:, :, :2]),
                              torch.from_numpy(v[:, :, :2]), q_chunk=q_chunk)
    assert (got[:, :, :2] == 0).all() and torch.isfinite(got).all()


def test_flash_attention_query_without_keys_gives_zero():
    """Causal with more queries than keys: the first queries keep no key and
    give 0 (the TPU kernel's flush), the others the oracle's output."""
    rng = np.random.default_rng(53)
    q = rng.normal(size=(1, 2, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 4, 16)).astype(np.float32) for _ in range(2))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert (got[:, :, :4] == 0).all() and torch.isfinite(got).all()
    want = jref.ref_flash_attention(jnp.asarray(q[:, :, 4:]), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got[:, :, 4:].numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_flash_attention_argument_checks():
    q, k = torch.zeros((1, 4, 8, 16)), torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError):  # 4 heads do not group over 3
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[..., :8], q[..., :8])


# ---------------------------------------------------------------------------
# The decode kernels' split algorithms and the kept u8 column sums
# ---------------------------------------------------------------------------
# ``int_matmul``'s decode kernel cuts K into runs of whole reference K-tiles,
# sums the runs' int32 partials and folds once (``int_matmul_split_plain``):
# held to ``int_matmul_plain`` and ``repro.kernels.ref`` bit for bit for
# ``exact``, ``wrap`` and the int16 carry; ``saturate`` goes through the
# sequential carry.  ``paged_attention``'s kernel cuts each row's table into
# runs and merges their partial softmaxes in split order
# (``paged_attention_split_plain``): held to the JAX oracles within 1e-5
# (fp32 softmax summed in another order), with empty runs, windows, length-0
# rows and G = 1, 3, 4 query heads a KV head.  The split choices are
# functions of the static shapes alone.

im = importlib.import_module("repro_torch.kernels.int_matmul")
pa = importlib.import_module("repro_torch.kernels.paged_attention")


def _jax_codes(x, s, lo, hi, shift):
    """The act-quant's int8 operand in JAX: ``clip(round(x / s), lo, hi) -
    shift`` (rounding half to even)."""
    q = jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(s)), lo, hi) - shift
    return q.astype(jnp.int8)


# (mode, acc_bits, int16 carry, A2Q-bounded weights): the reference's
# carries that the kernel folds once at the flush
CARRIES = [("exact", 32, False, False), ("exact", 16, True, True), ("wrap", 16, True, False),
           ("wrap", 20, False, False), ("wrap", 12, False, False)]


@pytest.mark.parametrize("carry", CARRIES, ids=lambda c: f"{c[0]}{c[1]}{'_int16' if c[2] else ''}")
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("K", [300, 1300, 2000])
def test_int_matmul_split_plain_matches_plain_and_jax(carry, splits, K):
    """Per-split int32 partials summed, then one fold: the reference's
    carry folded at every K-tile, bit for bit."""
    mode, acc_bits, spill, bounded = carry
    rng = np.random.default_rng(K + splits)
    M, N = 8, 24
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = _a2q_bounded_w(rng, K, N) if bounded else rng.integers(-128, 128, (K, N)).astype(np.int8)
    bk = int_matmul_block_k(K)
    k_split, used = im._split_runs(K, bk, splits)
    assert k_split % bk == 0 and used <= splits and (used - 1) * k_split < K
    kw = dict(acc_bits=acc_bits, mode=mode, block_k=bk, spill_int16=spill)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = im.int_matmul_split_plain(tx, tw, splits=splits, **kw)
    assert torch.equal(got, im.int_matmul_plain(tx, tw, **kw))
    want = jref.ref_int_matmul(jnp.asarray(x), jnp.asarray(w), acc_bits=acc_bits, mode=mode,
                               block_k=bk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("acc_bits,spill", [(16, True), (12, False)])
@pytest.mark.parametrize("splits", [1, 3])
def test_int_matmul_split_plain_saturate_is_sequential(acc_bits, spill, splits):
    """``saturate`` is no homomorphism: one split, clipped at every tile, as
    the reference does (and the kernel, which keeps one split for it)."""
    rng = np.random.default_rng(acc_bits + splits)
    x = rng.integers(-128, 128, (8, 1700)).astype(np.int8)
    w = rng.integers(-128, 128, (1700, 16)).astype(np.int8)
    kw = dict(acc_bits=acc_bits, mode="saturate", block_k=int_matmul_block_k(1700),
              spill_int16=spill)
    got = im.int_matmul_split_plain(torch.from_numpy(x), torch.from_numpy(w), splits=splits, **kw)
    want = jref.ref_int_matmul(jnp.asarray(x), jnp.asarray(w), acc_bits=acc_bits,
                               mode="saturate", block_k=kw["block_k"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert im.split_k(16, 1700, kw["block_k"], "saturate", acc_bits, 132) == 1


@pytest.mark.parametrize("signed", [True, False], ids=["s8", "u8"])
@pytest.mark.parametrize("splits", [2, 4])
def test_int_matmul_split_plain_prologue_and_requant(signed, splits):
    """Behind the prologue (fp32 x quantized, unsigned codes symmetrized
    with ``128 * colsum(w)`` added at the flush) and the fused scale + bias,
    then the requant epilogue: the same outputs as ``int_matmul_plain``,
    and the fused ones those of the JAX prologue oracle."""
    rng = np.random.default_rng(7 + splits)
    M, K, N = 8, 2000, 24
    x = rng.normal(size=(M, K)).astype(np.float32) * 3
    x = x if signed else np.abs(x)
    w = _a2q_bounded_w(rng, K, N)
    scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    lo, hi, shift = (-128, 127, 0) if signed else (0, 255, 128)
    tw = torch.from_numpy(w)
    offset = ops.symmetrization_offset(tw) if not signed else None
    kw = dict(acc_bits=16, mode="exact", block_k=int_matmul_block_k(K), spill_int16=True,
              aq_scale=torch.tensor([2.0**-5]), q_lo=lo, q_hi=hi, q_shift=shift)
    args = (torch.from_numpy(x), tw, torch.from_numpy(scale), torch.from_numpy(bias), offset)
    got = im.int_matmul_split_plain(*args, splits=splits, **kw)
    assert torch.equal(got, im.int_matmul_plain(*args, **kw))
    want = jref.ref_int_matmul_fused(_jax_codes(x, 2.0**-5, lo, hi, shift), jnp.asarray(w),
                                     jnp.asarray(scale), jnp.asarray(bias), acc_bits=16,
                                     block_k=kw["block_k"],
                                     offset=None if signed else jnp.asarray(offset.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    req = dict(out_scale=torch.full((N,), 0.05), r_lo=0, r_hi=255, r_shift=128, act_fn="relu2",
               cast_dtype=torch.bfloat16)
    got = im.int_matmul_split_plain(*args, splits=splits, **kw, **req)
    assert torch.equal(got, im.int_matmul_plain(*args, **kw, **req))


@pytest.mark.parametrize("N,K,want", [
    (576, 576, 2), (192, 576, 2), (576, 1536, 3),  # smollm: capped by the K-tiles
    (4096, 4096, 4), (14336, 4096, 4), (4096, 14336, 4),  # rwkv6 tm, cm.wk, cm.wv
    (7168, 18432, 4),  # deepseek w_out
    (129280, 7168, 1),  # deepseek head: 1,010 strips cover the card
])
def test_split_k_from_static_shapes(N, K, want):
    """The decode grid's K splits for the decoders' shapes on a 132-SM card:
    about four blocks an SM, at most four splits (a cluster), one K-tile at
    least a split, splits on K-tile boundaries."""
    bk = int_matmul_block_k(K)
    splits = im.split_k(N, K, bk, "exact", 16, 132)
    assert splits == want
    k_split, used = im._split_runs(K, bk, splits)
    assert used == splits and k_split % bk == 0 and (splits - 1) * k_split < K


@pytest.mark.parametrize("pool", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("splits", [1, 2, 4, 7])
@pytest.mark.parametrize("window", [None, 5])
def test_paged_attention_split_plain_matches_jax_oracles(pool, G, splits, window):
    """Runs merged in split order: the JAX gathered-view oracle within 1e-5,
    with runs that hold no valid key (short rows, a window), a zero-length
    row (zeros), and G query heads a KV head."""
    rng = np.random.default_rng(G * 10 + splits)
    B, KV, Dh, bs, MB = 6, 2, 16, 4, 7
    NB = B * MB + 1
    q = rng.normal(size=(B, G * KV, Dh)).astype(np.float32)
    kp, vp = (rng.normal(size=(NB, bs, KV, Dh)).astype(np.float32) for _ in range(2))
    bt = rng.permutation(np.arange(1, NB))[: B * MB].reshape(B, MB).astype(np.int32)
    lengths = np.asarray([0, 1, 6, 17, 28, 13], np.int32)
    scales = ()
    if pool != "fp32":
        from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

        bits = 8 if pool == "int8" else 4
        (kc, ks), (vc, vs) = (_kv_quantize(torch.from_numpy(p), bits=bits) for p in (kp, vp))
        if bits == 4:
            kc, vc = _pack_nibbles(kc), _pack_nibbles(vc)
        kp, vp, scales = kc.numpy(), vc.numpy(), (ks.numpy(), vs.numpy())
    targs = [torch.from_numpy(a) for a in (q, kp, vp, bt, lengths, *scales)]
    got = pa.paged_attention_split_plain(*targs, splits=splits, window=window)
    oracle = {"fp32": jref.ref_paged_attention, "int8": jref.ref_paged_attention_q8,
              "int4": jref.ref_paged_attention_q4}[pool]
    jargs = [jnp.asarray(a) for a in (q, kp, vp)]
    jargs += [jnp.asarray(a) for a in scales] + [jnp.asarray(bt), jnp.asarray(lengths)]
    want = oracle(*jargs, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got[0] == 0).all() and torch.isfinite(got).all()
    eps, used = pa._split_entries(MB, splits)
    assert used <= splits and (used - 1) * eps < MB


@pytest.mark.parametrize("B,G,MB,want", [
    (8, 3, 6, 1),  # the smoke shape: 96 key slots, one run
    (32, 3, 128, 6),  # SmolLM-135M's 2048-token context
    (1, 1, 256, 8),  # one long row: at most 8 runs (a cluster)
])
def test_split_kv_from_static_shapes(B, G, MB, want):
    """The runs a row's table is cut into on a 132-SM card, from B, the
    heads and the table width alone."""
    assert pa.split_kv(B, 3 if G == 3 else 1, G, MB, 16, 132) == want


def test_symmetrization_offset_is_kept_per_weight():
    """``128 * colsum(w)`` is computed once per weight: a second call hands
    back the kept tensor; a weight edited in place gets a fresh sum; a
    different weight has its own."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.integers(-128, 128, (64, 12)).astype(np.int8))
    first = ops.symmetrization_offset(w)
    assert torch.equal(first, 128 * w.to(torch.int32).sum(0))
    assert ops.symmetrization_offset(w) is first
    w[3, 5] += 1
    fresh = ops.symmetrization_offset(w)
    assert fresh is not first and torch.equal(fresh, 128 * w.to(torch.int32).sum(0))
    assert fresh[5] == first[5] + 128
    other = w.clone()
    assert ops.symmetrization_offset(other) is not fresh


def test_symmetrization_offset_is_kept_for_views_of_a_stack():
    """A layer's weight reaches the op as a new view of its stack on every
    call: the sums are kept on the stack, one entry a layer, and an in-place
    edit of the stack (through any view) gets fresh sums."""
    rng = np.random.default_rng(5)
    stack = torch.from_numpy(rng.integers(-128, 128, (3, 64, 12)).astype(np.int8))
    first = [ops.symmetrization_offset(stack[layer]) for layer in range(3)]
    for layer in range(3):
        assert torch.equal(first[layer], 128 * stack[layer].to(torch.int32).sum(0))
        assert ops.symmetrization_offset(stack[layer]) is first[layer]
    stack[1, 0, 0] += 1  # edits the stack through a view
    fresh = ops.symmetrization_offset(stack[1])
    assert fresh is not first[1] and fresh[0] == first[1][0] + 128
    assert ops.symmetrization_offset(stack[2]) is not first[2]  # the shared version moved
    assert torch.equal(ops.symmetrization_offset(stack[2]), first[2])


def test_unsigned_int_matmul_uses_the_kept_sums(monkeypatch):
    """``ops.int_matmul`` with unsigned 8-bit codes sums the weight's
    columns on its first call only, and its outputs stay the oracle's."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (5, 200)).astype(np.float32)
    w = _a2q_bounded_w(rng, 200, 16)
    tw = torch.from_numpy(w)
    scale = rng.uniform(1e-4, 1e-2, 16).astype(np.float32)
    kw = dict(acc_bits=16, spill_int16=True, in_bits=8, in_signed=False, aq_scale=1.0)
    first = ops.int_matmul(torch.from_numpy(x), tw, scale=torch.from_numpy(scale), **kw)
    sums = []
    real = torch.Tensor.sum
    monkeypatch.setattr(torch.Tensor, "sum", lambda t, *a, **k: sums.append(1) or real(t, *a, **k))
    again = ops.int_matmul(torch.from_numpy(x), tw, scale=torch.from_numpy(scale), **kw)
    monkeypatch.undo()
    assert not sums and torch.equal(again, first)
    want = jref.ref_int_matmul_fused(_jax_codes(x, 1.0, 0, 255, 128), jnp.asarray(w),
                                     jnp.asarray(scale), acc_bits=16,
                                     block_k=int_matmul_block_k(200),
                                     offset=128 * jnp.asarray(w, jnp.int32).sum(0))
    np.testing.assert_array_equal(first.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# a2q_quantize's split of each column strip's rows across a thread-block
# cluster: the l1 sum in the kernel's order, and the choice of split
# ---------------------------------------------------------------------------

aq = importlib.import_module("repro_torch.kernels.a2q_quantize")


def _l1_case(K, C, seed):
    """Weights with a wide spread of magnitudes (the sums' rounding shows)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(K, C)) * rng.uniform(0.0, 1.0, size=(K, C)) ** 3
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("K", [1, 3, 7, 8, 9, 100, 1280, 5000])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_a2q_l1_split_plain_is_pairwise_sum(K, splits):
    """The kernel's chunked, cluster-split order of the l1 sum is
    ``core.a2q.pairwise_sum``'s tree bit for bit, for every strip width."""
    from repro_torch.core.a2q import pairwise_sum

    v = _l1_case(K, 37, K + 11 * splits)
    want = pairwise_sum(v.abs())
    for strip in aq.STRIPS:
        assert torch.equal(aq.a2q_l1_split_plain(v, splits, strip), want)


@settings(max_examples=40, deadline=None)
@given(K=st.integers(1, 4000), splits=st.sampled_from([1, 2, 4, 8]),
       strip=st.sampled_from([8, 16, 32]))
def test_a2q_l1_split_plain_is_pairwise_sum_for_any_shape(K, splits, strip):
    from repro_torch.core.a2q import pairwise_sum

    v = _l1_case(K, 5, K)
    assert torch.equal(aq.a2q_l1_split_plain(v, splits, strip), pairwise_sum(v.abs()))


@pytest.mark.parametrize("K,C", [(300, 130), (512, 256), (17, 5), (1024, 64)])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_a2q_split_codes_match_jax_oracle(K, C, splits):
    """Codes from the split l1 (``clip(trunc(g/s * v / l1))``) equal the JAX
    package's ``ref_a2q_quantize`` codes on the reference's cases (P=16,
    unsigned 8-bit inputs), and the plain quantizer's."""
    v, t, d = _a2q_case(np.random.default_rng(K * C + 16), K, C)
    jv, jt, jd = jnp.asarray(v), jnp.asarray(t), jnp.asarray(d)
    _, q_r = jref.ref_a2q_quantize(jv, jt, jd, 8, 16, 8, False)
    T = jnp.log2(jnp.float32(2.0**15 - 1.0)) + jd - 8
    gs = torch.from_numpy(np.asarray(jnp.exp2(jnp.minimum(jt, T) - jd)))
    tv = torch.from_numpy(v)
    l1 = torch.clamp_min(aq.a2q_l1_split_plain(tv, splits), 1e-12)
    q = torch.clamp(torch.trunc(gs * tv / l1), -128, 127)
    np.testing.assert_array_equal(q.numpy().astype(np.int32), np.asarray(q_r))
    _, q_p, l1_p = a2q_quantize_plain(tv, gs, torch.ones_like(gs), n=-128, p=127)
    assert torch.equal(l1, l1_p) and torch.equal(q.to(torch.int8), q_p)


@pytest.mark.parametrize("K,C", [
    (576, 576), (576, 192), (1536, 576),  # smollm-135m
    (7168, 2048), (2048, 7168), (7168, 18432), (18432, 7168), (7168, 576), (512, 32768),
    (16384, 7168), (7168, 129280),  # deepseek-v3: experts, dense mlp, MLA projections, head
    (4096, 4096), (14336, 4096),  # rwkv6-7b
    (1280, 1280), (5120, 1280), (1280, 504),  # hubert-xlarge
    (1, 40), (17, 5), (300000, 64),  # tiny, ragged, and rows past every shared memory
])
def test_a2q_split_from_static_shapes(K, C):
    """The kernel's launch choice on a 132-SM card is one it takes: a strip
    width and a cluster size it has, a power-of-two chunk of at least 8 rows
    whose chunks fit the block's slots, resident rows within a block's shared
    memory; wide matrices fill the card with two blocks an SM."""
    strip, splits, chunk, resident = aq.a2q_split(K, C, 132)
    S, cpb, blocks = aq.cluster_shape(K, splits, strip)
    assert strip in aq.STRIPS and 1 <= splits <= aq.MAX_SPLITS and (S, blocks) == (chunk, splits)
    assert chunk >= aq.PIECE and chunk & (chunk - 1) == 0
    assert cpb & (cpb - 1) == 0 and cpb <= aq.THREADS * 4 // strip
    assert (splits - 1) * cpb * chunk < K <= splits * cpb * chunk or K <= chunk
    if resident:
        assert aq.resident_bytes(K, strip, chunk, cpb) <= aq.PAIR_SMEM
    else:
        assert strip == 32 and K >= 14336
    if resident and C * K >= 2**22:
        assert -(-C // strip) * splits >= aq.BLOCKS_PER_SM * 132


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic (paged_mla_attention_tc_plain) at
# deepseek-v3's widths, against the plain version and the jnp oracle
# ---------------------------------------------------------------------------

_MLA_TOL = 2e-5  # chip_smoke.py's MLA_TOL: the kernels against the plain version
_DS_SCALE = (128 + 64) ** -0.5
_DS_AQ = np.float32(0.02)


@functools.cache
def _deepseek_mla_case(pools: str, act_quant: bool):
    """B=2 rows of 1 and 45 keys (at most 48 key slots) at H=128, R=512,
    P=64, bs=16; the torch inputs, the plain version's and the jnp oracle's
    outputs."""
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    B, H, R, P, bs, MB = 2, 128, 512, 64, 16, 3
    NB = B * MB + 2
    rng = np.random.default_rng(60 + len(pools) + act_quant)
    bt = rng.permutation(np.arange(1, NB))[: B * MB].reshape(B, MB).astype(np.int32)
    lengths = np.asarray([1, 45], np.int32)
    q_lat = rng.normal(size=(B, H, R)).astype(np.float32)
    q_pe = rng.normal(size=(B, H, P)).astype(np.float32)
    ckv = torch.from_numpy(rng.normal(size=(NB, bs, R)).astype(np.float32))
    kpe = torch.from_numpy(rng.normal(size=(NB, bs, P)).astype(np.float32))
    scales = []
    if pools == "bf16":
        ckv, kpe = ckv.bfloat16(), kpe.bfloat16()
        jpools = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (ckv, kpe)]
    else:
        bits = 8 if pools == "int8" else 4
        (ckv, cs), (kpe, ks) = (_kv_quantize(t, bits=bits) for t in (ckv, kpe))
        if bits == 4:
            ckv, kpe = _pack_nibbles(ckv), _pack_nibbles(kpe)
        scales = [cs, ks]
        jpools = [jnp.asarray(t.numpy()) for t in (ckv, kpe)]
    targs = [torch.from_numpy(q_lat), torch.from_numpy(q_pe), ckv, kpe, torch.from_numpy(bt),
             torch.from_numpy(lengths), *scales]
    kw = {"aq_scale": torch.tensor(_DS_AQ), "act_bits": 8} if act_quant else {}
    plain = ops.paged_mla_attention(*targs[:6], scale=_DS_SCALE,
                                    **dict(zip(("ckvs", "kpes"), scales)), **kw)
    jkw = {"aq_scale": jnp.asarray(_DS_AQ), "act_bits": 8} if act_quant else {}
    want = jref.ref_paged_mla_attention(
        jnp.asarray(q_lat), jnp.asarray(q_pe), *jpools, jnp.asarray(bt), jnp.asarray(lengths),
        *(jnp.asarray(t.numpy()) for t in scales), scale=_DS_SCALE, **jkw)
    return targs, kw, plain, np.asarray(want)


@pytest.mark.parametrize("pools", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_paged_mla_attention_tc_plain_matches_plain_and_jnp_oracle(pools, act_quant, splits):
    """The tensor-core kernel's arithmetic (q in three bf16 terms, the
    latent operand exact in bf16 with its per-key factors, 64-key steps of
    online softmax, P in bf16 terms, runs merged in order) within ``_MLA_TOL``
    of the plain version and of the jnp oracle; the length-1 row exactly the
    plain version's."""
    mla = importlib.import_module("repro_torch.kernels.paged_mla_attention")
    targs, kw, plain, want = _deepseek_mla_case(pools, act_quant)
    got = mla.paged_mla_attention_tc_plain(*targs, scale=_DS_SCALE, splits=splits, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=_MLA_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_MLA_TOL)
    assert torch.equal(got[0], plain[0])


@pytest.mark.parametrize("dtype,act_bits,want", [
    (torch.bfloat16, None, True), (torch.int8, 8, True), (torch.uint8, 9, True),
    (torch.int8, None, True), (torch.float32, None, False), (torch.float32, 8, False),
    (torch.bfloat16, 10, False), (torch.uint8, 16, False),
])
def test_paged_mla_attention_route(dtype, act_bits, want):
    """bf16, int8 and int4 pools run on the tensor cores unless the replay's
    codes (more than 9 bits) are not exact in bf16; fp32 pools never do."""
    mla = importlib.import_module("repro_torch.kernels.paged_mla_attention")
    assert mla.tensor_core_route(dtype, act_bits) is want


@pytest.mark.parametrize("B,MB,want", [
    (8, 6, 2),  # the smoke shape: 96 key slots, 64 head tiles
    (8, 256, 2),  # DeepSeek-V3's 4K context: 128 blocks, one wave
    (1, 256, 8),  # one long row: at most 8 runs (a cluster)
    (8, 1, 1),  # one table entry: one run
])
def test_mla_splits_from_static_shapes(B, MB, want):
    """The runs a row's table is cut into on a 132-SM card (H=128),
    from B and the table width alone."""
    mla = importlib.import_module("repro_torch.kernels.paged_mla_attention")
    splits = mla.mla_splits(B, 128, MB, 132)
    assert splits == want
    eps, used = mla._split_entries(MB, splits)
    assert used == splits and (used - 1) * eps < MB


def _round_f32(x) -> np.float32:
    """A rational rounded once to the nearest fp32 (ties to even)."""
    from fractions import Fraction

    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda f: (abs(Fraction(float(f)) - x), int(f.view(np.uint32)) & 1))


def test_fma_corrected_quotient_is_the_ieee_quotient():
    """The kernels' division-free quotient (``codes4`` in a2q_quantize.cu,
    ``replay8`` in paged_mla_attention.cu): with inv = RN(1 / y) and q =
    RN(x inv), ``fma(fma(-y, q, x), inv, q)`` is the IEEE quotient x / y
    (Markstein's correction), on values like the deploys' (gs v against l1)
    and the replay's (codes times scales against s_aq)."""
    from fractions import Fraction

    rng = np.random.default_rng(19)
    for i in range(2000):
        if i % 2:
            x = np.float32(rng.normal() * 10 ** rng.uniform(-3, 3))
            y = np.float32(10 ** rng.uniform(-4, 2))
        else:
            x = np.float32(np.float32(rng.integers(-127, 128)) * np.float32(rng.uniform(1e-3, 0.05)))
            y = np.float32(rng.choice([0.02, 0.017, 0.03, 1 / 127, 0.0123]))
        fx, fy = Fraction(float(x)), Fraction(float(y))
        inv = _round_f32(1 / fy)
        q = np.float32(x * inv)
        r = _round_f32(fx - fy * Fraction(float(q)))
        got = _round_f32(Fraction(float(r)) * Fraction(float(inv)) + Fraction(float(q)))
        assert got == np.float32(x / y), (x, y, got)
