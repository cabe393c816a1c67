"""The int_matmul requantizing epilogue (int8-out chaining) in the port
against the JAX package.

Covered:

* ``ops.int_matmul(out_scale=...)`` on the CPU (the plain requant flush) bit
  for bit against JAX's ``ref_int_matmul_requant``: ``act_fn`` None and
  relu2, the replay in fp32 and bf16, signed and unsigned targets at 8 and 4
  bits, with and without a bias, on int8 codes and on fp32 activations
  quantized in the prologue; the scales JAX computed are fed to both sides
  (``jnp.exp2`` and ``torch.exp2`` differ in the last bits); the port's own
  oracle ``ref.ref_int_matmul_requant`` agrees; one case against the Pallas
  kernel itself in interpret mode; the argument rules;
* ``apply_linear`` with ``out_aq`` on a deployed layer: the ``IntAct`` it
  returns (codes, scale, bits, signedness) equals JAX's (codes compared in
  fp32, see the test), it is recorded as
  ``chained``, and a consumer fed those codes gives the output of the
  unchained path (act-quant of the producer's fp output).

Tolerances: exact everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.quantizers import act_quant_int as jact_quant_int
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import linear as jlinear
from repro.nn.module import unbox

from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.nn import linear as tlinear

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _a2q_bounded_w(rng, K, N, nnz=10, amp=25):
    """int8 weights whose column l1 norms (<= 250) fit P=16 with 8-bit inputs."""
    w = np.zeros((K, N), np.int8)
    for n in range(N):
        rows = rng.choice(K, size=min(nnz, K), replace=False)
        w[rows, n] = rng.integers(-amp, amp + 1, rows.size)
    return w


def _case(seed, M=9, K=200, N=56, per_column=False, log2_out=-3.3):
    """int8 x, A2Q-bounded w, per-column scales, a bias, and an ``out_scale``
    from JAX's exp2 (a non-power-of-two scale, so the division rounds) that
    puts the flush's range past the 8-bit codes (the clip is exercised)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = _a2q_bounded_w(rng, K, N)
    scale = rng.uniform(2e-3, 8e-3, N).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    logs = log2_out + (rng.uniform(-1, 1, N) if per_column else 0.0)
    out_scale = np.asarray(jnp.exp2(jnp.asarray(logs, jnp.float32)))
    return x, w, scale, bias, out_scale


@pytest.mark.parametrize("act_fn", [None, "relu2"], ids=["none", "relu2"])
@pytest.mark.parametrize("cast", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_bits,out_signed", [(8, True), (8, False), (4, True), (4, False)])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_requant_int_matmul_matches_jax_oracle(act_fn, cast, out_bits, out_signed, with_bias):
    x, w, scale, bias, out_scale = _case(out_bits + 2 * out_signed + 5 * with_bias,
                                         per_column=with_bias)
    jdt, tdt = _DT[cast]
    b = bias if with_bias else None
    want = jref.ref_int_matmul_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(out_scale),
        bias=None if b is None else jnp.asarray(b), out_bits=out_bits, out_signed=out_signed,
        act_fn=act_fn, cast_dtype=jdt, acc_bits=16)
    kw = dict(scale=torch.from_numpy(scale), bias=None if b is None else torch.from_numpy(b),
              out_scale=torch.from_numpy(out_scale), out_bits=out_bits, out_signed=out_signed,
              act_fn=act_fn, cast_dtype=tdt)
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), acc_bits=16,
                         spill_int16=True, **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = ref.ref_int_matmul_requant(torch.from_numpy(x), torch.from_numpy(w), acc_bits=16,
                                        **kw)
    assert torch.equal(got, oracle)
    lo, hi = (-(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1) if out_signed else \
        (0, (1 << out_bits) - 1)
    codes = got.numpy().astype(np.int32) + (128 if not out_signed and out_bits == 8 else 0)
    assert codes.min() >= lo and codes.max() <= hi
    assert (codes == hi).any()  # the clip is exercised
    if act_fn is None and out_signed:
        assert (codes == lo).any()


@pytest.mark.parametrize("act_fn", [None, "relu2"], ids=["none", "relu2"])
@pytest.mark.parametrize("cast", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_signed", [True, False], ids=["s8_in", "u8_in"])
def test_requant_with_the_prologue_matches_jax(act_fn, cast, in_signed):
    """fp32 activations quantized in the prologue and requantized into an
    unsigned 8-bit consumer (rwkv6's cm.wk edge): JAX's host act-quant codes
    (unsigned 8-bit symmetrized, the offset added back) fed to its requant
    oracle."""
    rng = np.random.default_rng(31 + in_signed)
    M, K, N = 7, 300, 48
    aq = np.asarray(jnp.exp2(jnp.asarray(-4.6, jnp.float32)))
    x = (rng.normal(size=(M, K)) * 1.5).astype(np.float32)
    x = x if in_signed else np.abs(x)
    _, w, scale, bias, _ = _case(40, M=M, K=K, N=N)
    jdt, tdt = _DT[cast]
    codes, _ = jact_quant_int({"log2_scale": jnp.asarray(-4.6, jnp.float32)}, jnp.asarray(x), 8,
                              in_signed)
    codes = np.asarray(codes)
    offset = None
    if not in_signed:
        codes, offset = codes - 128.0, 128 * w.astype(np.int32).sum(0)
    fused_scale = (aq * scale).astype(np.float32)
    # an out_scale (a non-power of two, from JAX's exp2) that puts the flush
    # past both ends of the unsigned codes
    y = np.asarray(jref.ref_int_matmul_fused(jnp.asarray(codes.astype(np.int8)), jnp.asarray(w),
                                             jnp.asarray(fused_scale), offset=offset))
    y = y * y if act_fn == "relu2" else y
    out_scale = np.asarray(jnp.exp2(jnp.asarray(np.log2(np.abs(y).max() / 400) + 0.3,
                                                jnp.float32)))
    want = jref.ref_int_matmul_requant(
        jnp.asarray(codes.astype(np.int8)), jnp.asarray(w), jnp.asarray(fused_scale),
        jnp.asarray(out_scale), offset=None if offset is None else jnp.asarray(offset),
        out_bits=8, out_signed=False, act_fn=act_fn, cast_dtype=jdt, acc_bits=16)
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         scale=torch.from_numpy(fused_scale), aq_scale=torch.from_numpy(aq),
                         in_bits=8, in_signed=in_signed, out_scale=torch.from_numpy(out_scale),
                         out_bits=8, out_signed=False, act_fn=act_fn, cast_dtype=tdt,
                         acc_bits=16, spill_int16=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 127).any() and (got.numpy() == -128).any()  # both clips


def test_requant_matches_pallas_interpret():
    """One case against the Pallas kernel's requant flush (interpret mode):
    relu2 replayed in fp32 into unsigned 8-bit codes, the prologue on fp32
    input, the int16 carry.  (Not in bf16: the interpreter's compiled body
    keeps the bf16 square in fp32 where the reference's own oracle, and the
    port, round it to bf16; the oracle is the contract, held above.)"""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(9, 300)) * 2).astype(np.float32)
    _, w, scale, _, out_scale = _case(6, M=9, K=300, N=70)
    aq = np.float32(2.0**-5)
    kw = dict(in_bits=8, in_signed=True, acc_bits=16, spill_int16=True, out_bits=8,
              out_signed=False, act_fn="relu2")
    want = jops.int_matmul(jnp.asarray(x), jnp.asarray(w), scale=jnp.asarray(scale),
                           aq_scale=jnp.asarray(aq), out_scale=jnp.asarray(out_scale),
                           cast_dtype=jnp.float32, interpret=True, **kw)
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), scale=torch.from_numpy(scale),
                         aq_scale=torch.tensor(aq), out_scale=torch.from_numpy(out_scale),
                         cast_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 50


def test_requant_argument_checks():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError):  # the requant follows the fused epilogue
        ops.int_matmul(x, w, out_scale=1.0)
    with pytest.raises(ValueError):  # P-bit emulation of the chained datapath is not modeled
        ops.int_matmul(x, w, scale=1.0, out_scale=1.0, mode="wrap", acc_bits=16)
    with pytest.raises(ValueError):
        ops.int_matmul(x, w, scale=1.0, out_scale=1.0, act_fn="tanh")
    with pytest.raises(ValueError):
        ops.int_matmul(x, w, scale=1.0, out_scale=1.0, cast_dtype=torch.float16)
    with pytest.raises(ValueError):  # 9-bit unsigned codes do not fit int8
        ops.int_matmul(x, w, scale=1.0, out_scale=1.0, out_bits=9, out_signed=False)
    for act_fn in ("relu2", "gelu"):  # gelu: hubert's non-gated MLP
        got = ops.int_matmul(x, w, scale=1.0, out_scale=torch.tensor(0.5), act_fn=act_fn)
        assert got.dtype == torch.int8 and got.shape == (4, 4)


# ---------------------------------------------------------------------------
# The linear layer's chained producer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cast", ["float32", "bfloat16"])
def test_requant_ties_holds_every_code_a_nearby_tanh_moves(cast):
    """``requant_ties`` (the card check's allowance for the gelu replay):
    every code that a ``tanh`` up to 4 ulps off ``torch.tanh``'s (kept in
    [-1, 1]) rounds differently lies in it, and it is a small set (the
    window of one ulp of the value it replaced held every element in the
    upper half of the code range); the None and relu2 replays have none."""
    from repro_torch.kernels.int_matmul import requant_codes, requant_ties

    tcast = _DT[cast][1]
    g = torch.Generator().manual_seed(61)
    y = torch.randn((1000, 1024), generator=g) * 3
    out_scale = torch.full((1024,), y.clamp_min(0).max().item() / 127)
    ties = requant_ties(y, out_scale, "gelu", tcast)
    base = requant_codes(y, out_scale, -128, 127, 0, "gelu", tcast)
    x = y.to(tcast).to(torch.float32)
    t = torch.tanh(ref._SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    moved = torch.zeros_like(ties)
    for end in (-1.0, 1.0):
        tp = t
        for _ in range(4):
            tp = torch.nextafter(tp, torch.full_like(tp, end))
            y_r = (x * (0.5 * (1.0 + tp))).to(tcast).to(torch.float32)
            moved |= torch.clamp(torch.round(y_r / out_scale), -128, 127).to(torch.int8) != base
    assert not moved[~ties].any()
    assert int(ties.sum()) <= 1e-4 * ties.numel()
    if tcast == torch.float32:
        assert moved.any()  # the case reaches a tie
    for act_fn in (None, "relu2"):
        assert not requant_ties(y, out_scale, act_fn, tcast).any()


@pytest.fixture(scope="module")
def producer_consumer():
    """A deployed A2Q producer (64 -> 40) and unsigned-input consumer
    (40 -> 24) from the JAX initializer, activation scales pinned to powers
    of two (so both frameworks' exp2 agree), as numpy."""
    arch = jreduced(jget_arch("rwkv6-7b"))
    q = arch.quant
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    prod = unbox(jlinear.init_linear(k1, 64, 40, q))
    cons = unbox(jlinear.init_linear(k2, 40, 24, q, input_signed=False))
    prod["aq"]["log2_scale"] = jnp.asarray(-5.0, jnp.float32)
    cons["aq"]["log2_scale"] = jnp.asarray(-10.0, jnp.float32)
    dp = jlinear.deploy_linear(prod, q)
    dc = jlinear.deploy_linear(cons, q, input_signed=False)
    return q, jax.tree.map(np.asarray, dp), jax.tree.map(np.asarray, dc)


@pytest.mark.parametrize("chain", [True, False], ids=["prologue", "standalone"])
@pytest.mark.parametrize("cast", ["float32", "bfloat16"])
def test_apply_linear_out_aq_returns_jax_int_act(producer_consumer, chain, cast):
    q, dp, dc = producer_consumer
    jdt, tdt = _DT[cast]
    x = (np.random.default_rng(3).normal(size=(2, 3, 64))).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, dp)
    j_out_aq = jlinear.chain_out_aq(jax.tree.map(jnp.asarray, dc), q, input_signed=False,
                                    act_fn="relu2")
    want = jlinear.apply_linear(jparams, jnp.asarray(x), q, compute_dtype=jdt, int_forward=True,
                                int_chain=chain, out_aq=j_out_aq, site="cm.wk")
    out_aq = tlinear.chain_out_aq(from_jax_numpy(dc), q, input_signed=False, act_fn="relu2")
    rep: dict = {}
    with tlinear.chain_report_scope(rep):
        got = tlinear.apply_linear(from_jax_numpy(dp), torch.from_numpy(x), q, compute_dtype=tdt,
                                   int_forward=True, int_chain=chain, out_aq=out_aq, site="cm.wk")
    assert isinstance(got, tlinear.IntAct) and isinstance(want, jlinear.IntAct)
    assert rep["chained"] == ["cm.wk"]
    assert rep["folded" if chain else "standalone"] == ["cm.wk"]
    if cast == "float32":
        # (in bf16 the JAX layer's compiled Pallas interpreter keeps the bf16
        # square in fp32, unlike its oracle, which the port follows; the
        # ops-level test above holds bf16 against the oracle)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert float(got.scale) == float(want.scale)
    assert (got.bits, got.signed) == (want.bits, want.signed) == (8, False)
    assert got.codes.shape == (2, 3, 40) and len(np.unique(got.codes.numpy())) > 8
    # the consumer on the codes gives the unchained path's output bit for bit
    h = tlinear.apply_linear(from_jax_numpy(dp), torch.from_numpy(x), q, compute_dtype=tdt,
                             int_forward=True)
    h = torch.square(torch.relu(h))
    unchained = tlinear.apply_linear(from_jax_numpy(dc), h, q, input_signed=False,
                                     compute_dtype=tdt, int_forward=True)
    chained = tlinear.apply_linear(from_jax_numpy(dc), got, q, input_signed=False,
                                   compute_dtype=tdt, int_forward=True, int_chain=True)
    assert torch.equal(chained, unchained)
