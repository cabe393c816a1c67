"""Int-chain (the int_matmul quantizing prologue) in the port against the JAX package.

Covered:

* ``ops.int_matmul(aq_scale=...)`` on the CPU (the plain prologue) bit for
  bit against the JAX package's host ``act_quant_int`` codes (unsigned 8-bit
  symmetrized) fed to ``ref_int_matmul_fused``, with the scales JAX computed
  fed to both sides (``jnp.exp2`` and ``torch.exp2`` differ in the last
  bits); one case against the Pallas kernel itself in interpret mode; bf16
  activations through the prologue against the fp32-widened call and the
  Pallas kernel; the argument checks;
* ``apply_linear`` on a deployed layer: the prologue branch, the ``IntAct``
  consumer branch and the chain repair of an ``IntAct`` into a layer that
  cannot take codes, against ``repro.nn.linear``; ``chain_out_aq``; the
  requant epilogue's gelu replay (``out_aq`` of the non-gated MLP) returning
  an ``IntAct`` (relu2 is covered in ``test_torch_requant.py``, the
  non-gated MLP against JAX in ``test_torch_hubert.py``);
* the slice as a whole on reduced smollm-135m, yi-6b and deepseek-v3
  (``mla_absorb``): the chain report of one forward equals the JAX report
  site for site (the reference traces each stacked block once, the port
  records every layer), chained and unchained runs give bitwise-equal
  logits and identical tokens (chaining is a pure dispatch fusion), and the
  launcher's flag rules.

Tolerances: exact everywhere, except the chain repair through the dequant
path (1e-5: the same fp32 matmul summed in another order).
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
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_lm as jinit_lm
from repro.nn import linear as jlinear
from repro.nn.module import unbox
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import Runtime, apply_lm
from repro_torch.nn import linear as tlinear
from repro_torch.nn.transformer import _apply_mlp
from repro_torch.serve.engine import PagedServeEngine

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "yi-6b", "deepseek-v3-671b")
ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)


def _a2q_bounded_w(rng, K, N, nnz=10, amp=25):
    """int8 weights whose column l1 norms (<= 250) fit the A2Q budget of
    P=16 with 8-bit inputs, so the int16 carry is lossless."""
    w = np.zeros((K, N), np.int8)
    for n in range(N):
        rows = rng.choice(K, size=min(nnz, K), replace=False)
        w[rows, n] = rng.integers(-amp, amp + 1, rows.size)
    return w


def _activations(rng, M, K, s):
    """fp32 activations over the whole code range and past it, with exact
    rounding ties (``(k + 0.5) * s`` for a power-of-two ``s``)."""
    x = (rng.normal(size=(M, K)) * 60 * s).astype(np.float32)
    ties = rng.random((M, K)) < 0.1
    x[ties] = ((rng.integers(-140, 140, ties.sum()) + 0.5) * s).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# The prologue in the kernel op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, True), (4, False)])
@pytest.mark.parametrize("K,carry", [(100, False), (576, True), (1536, True)])
def test_prologue_int_matmul_matches_host_act_quant(bits, signed, K, carry):
    rng = np.random.default_rng(K + bits + signed)
    M, N = 7, 48
    log2_scale = np.float32(-5.0 if K != 100 else -4.3)
    s = np.asarray(jnp.exp2(jnp.asarray(log2_scale)))  # JAX's scale, fed to both sides
    x = _activations(rng, M, K, np.float32(2.0**-5))
    if not signed:
        x = np.abs(x)
    w = _a2q_bounded_w(rng, K, N) if carry else rng.integers(-128, 128, (K, N)).astype(np.int8)
    s8 = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    scale = (s * s8).astype(np.float32)
    codes, _ = jact_quant_int({"log2_scale": jnp.asarray(log2_scale)}, jnp.asarray(x), bits, signed)
    codes = np.asarray(codes)
    offset = None
    if not signed and bits == 8:  # symmetrized into the int8 operand
        codes = codes - 128.0
        offset = 128 * w.astype(np.int32).sum(0)
    want = jref.ref_int_matmul_fused(jnp.asarray(codes.astype(np.int8)), jnp.asarray(w),
                                     jnp.asarray(scale), offset=offset)
    kw = dict(acc_bits=16, spill_int16=True) if carry else {}
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), scale=torch.from_numpy(scale),
                         aq_scale=torch.from_numpy(s), in_bits=bits, in_signed=signed, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's own prologue oracle, and its standalone act-quant, agree too
    oracle = ref.ref_int_matmul_prologue(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(s), torch.from_numpy(scale),
                                         in_bits=bits, in_signed=signed)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    assert np.abs(codes).max() >= (1 << (bits - 1)) - 1  # the clip is exercised


def test_prologue_matches_pallas_interpret():
    """One small case against the Pallas kernel's prologue (interpret mode):
    unsigned 8-bit inputs symmetrized in-register, int16 carry.  (No bias:
    XLA may contract the reference's bias epilogue into an FMA, which its
    own oracle allows to differ by one ulp.)"""
    rng = np.random.default_rng(3)
    x = np.abs(_activations(rng, 9, 300, np.float32(2.0**-5)))
    w = _a2q_bounded_w(rng, 300, 70)
    scale = rng.uniform(1e-4, 1e-2, 70).astype(np.float32)
    s = np.float32(2.0**-5)
    kw = dict(in_bits=8, in_signed=False, acc_bits=16, spill_int16=True)
    want = jops.int_matmul(jnp.asarray(x), jnp.asarray(w), scale=jnp.asarray(scale),
                           aq_scale=jnp.asarray(s), interpret=True, **kw)
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w), scale=torch.from_numpy(scale),
                         aq_scale=torch.tensor(s), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, True), (4, False)])
def test_prologue_takes_bf16_x_widened_exactly(bits, signed):
    """bf16 activations go through the prologue as they are (the int-chain
    linear no longer casts them to fp32): widened to fp32 exactly, so the
    codes, the fp32 outputs and the requant codes equal the fp32-widened
    call's, and the output the JAX int_matmul's (Pallas, interpret mode)
    with the prologue on the widened input."""
    from repro_torch.kernels.int_matmul import prologue_codes

    rng = np.random.default_rng(40 + bits + signed)
    M, K, N = 9, 200, 48
    s = np.float32(2.0**-5)
    x = _activations(rng, M, K, s)
    xb = torch.from_numpy(np.abs(x) if not signed else x).bfloat16()
    xw = xb.to(torch.float32)
    w = _a2q_bounded_w(rng, K, N)
    scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    kw = dict(scale=torch.from_numpy(scale), aq_scale=torch.tensor(s), in_bits=bits,
              in_signed=signed, acc_bits=16, spill_int16=True)
    tw = torch.from_numpy(w)
    got = ops.int_matmul(xb, tw, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, ops.int_matmul(xw, tw, **kw))
    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed else (0, (1 << bits) - 1)
    shift = 128 if not signed and bits == 8 else 0
    codes = prologue_codes(xb, torch.tensor(s), lo, hi, shift)
    assert torch.equal(codes, prologue_codes(xw, torch.tensor(s), lo, hi, shift))
    jcodes, _ = jact_quant_int({"log2_scale": jnp.asarray(np.float32(-5.0))},
                               jnp.asarray(xw.numpy()), bits, signed)
    np.testing.assert_array_equal(codes.numpy().astype(np.float32) + shift, np.asarray(jcodes))
    want = jops.int_matmul(jnp.asarray(xw.numpy()), jnp.asarray(w), scale=jnp.asarray(scale),
                           aq_scale=jnp.asarray(s), in_bits=bits, in_signed=signed, acc_bits=16,
                           spill_int16=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    req = dict(out_scale=torch.full((N,), float(got.abs().max()) / 100), act_fn="gelu",
               cast_dtype=torch.bfloat16)
    got_q = ops.int_matmul(xb, tw, **kw, **req)
    assert got_q.dtype == torch.int8 and torch.equal(got_q, ops.int_matmul(xw, tw, **kw, **req))


def test_prologue_argument_checks():
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 4), dtype=torch.int8)
    s = torch.tensor(0.1)
    with pytest.raises(ValueError):  # the prologue feeds the fused epilogue
        ops.int_matmul(x, w, aq_scale=s)
    with pytest.raises(ValueError):  # int8 codes take no prologue
        ops.int_matmul(x.to(torch.int8), w, scale=1.0, aq_scale=s)
    with pytest.raises(ValueError):  # fp32 x needs the prologue
        ops.int_matmul(x, w, scale=1.0)
    with pytest.raises(ValueError):  # the prologue takes fp32 or bf16, not fp16
        ops.int_matmul(x.half(), w, scale=1.0, aq_scale=s)
    with pytest.raises(ValueError):  # one scale for the whole tensor
        ops.int_matmul(x, w, scale=1.0, aq_scale=torch.full((8,), 0.1))
    with pytest.raises(ValueError):  # 9-bit unsigned codes do not fit int8
        ops.int_matmul(x, w, scale=1.0, aq_scale=s, in_bits=9, in_signed=False)
    got = ops.int_matmul(x, w, scale=1.0, aq_scale=s, out_scale=1.0, act_fn="gelu")
    assert got.dtype == torch.int8 and got.shape == (4, 4)  # the requant epilogue's gelu


# ---------------------------------------------------------------------------
# The linear layer's chain branches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deployed_linear():
    """A deployed A2Q linear from the JAX initializer with its activation
    scale pinned to 2^-5 (so both frameworks' ``exp2`` agree), as numpy, and
    the JAX float layer it came from."""
    arch = jreduced(jget_arch("yi-6b"))
    q = arch.quant
    fl = unbox(jlinear.init_linear(jax.random.PRNGKey(7), 64, 40, q, use_bias=True))
    fl["aq"]["log2_scale"] = jnp.asarray(-5.0, jnp.float32)
    dep = jlinear.deploy_linear(fl, q)
    return q, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


def _jax_linear(params, x, q, **kw):
    return jlinear.apply_linear(jax.tree.map(jnp.asarray, params), x, q,
                                compute_dtype=jnp.float32, **kw)


def test_apply_linear_prologue_equals_standalone_and_jax(deployed_linear):
    q, _, dep = deployed_linear
    x = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    tp = from_jax_numpy(dep)
    rep: dict = {}
    with tlinear.chain_report_scope(rep):
        chained = tlinear.apply_linear(tp, torch.from_numpy(x), q, compute_dtype=torch.float32,
                                       int_forward=True, int_chain=True, site="s")
        plain = tlinear.apply_linear(tp, torch.from_numpy(x), q, compute_dtype=torch.float32,
                                     int_forward=True, site="s")
    assert rep["folded"] == ["s"] and rep["standalone"] == ["s"]
    assert torch.equal(chained, plain)
    want = _jax_linear(dep, jnp.asarray(x), q, int_forward=True, int_chain=True)
    np.testing.assert_array_equal(chained.numpy(), np.asarray(want))


@pytest.mark.parametrize("signed", [True, False])
def test_apply_linear_consumes_int_act_like_jax(deployed_linear, signed):
    q, fl, dep = deployed_linear
    rng = np.random.default_rng(2)
    # int8 codes; unsigned 8-bit codes travel symmetrized, over the same range
    codes = rng.integers(-128, 128, (2, 3, 64)).astype(np.int8)
    scale = np.float32(2.0**-5)
    tact = tlinear.IntAct(torch.from_numpy(codes), torch.tensor(scale), 8, signed)
    jact = jlinear.IntAct(jnp.asarray(codes), jnp.asarray(scale), 8, signed)
    rep: dict = {}
    with tlinear.chain_report_scope(rep):
        got = tlinear.apply_linear(from_jax_numpy(dep), tact, q, compute_dtype=torch.float32,
                                   int_forward=True, int_chain=True, site="c")
    assert rep["folded"] == ["c"]
    want = _jax_linear(dep, jact, q, int_forward=True, int_chain=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # chain repair: a float (undeployed) consumer re-materializes the codes
    with tlinear.chain_report_scope(rep):
        got = tlinear.apply_linear(from_jax_numpy(fl), tact, q, compute_dtype=torch.float32,
                                   int_forward=True, int_chain=True, site="r")
    assert rep["fallback"] == ["r"]
    want = _jax_linear(fl, jact, q, int_forward=True, int_chain=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_chain_out_aq_and_the_unported_requant_epilogue(deployed_linear):
    q, fl, dep = deployed_linear
    for params in (dep, fl):
        want = jlinear.chain_out_aq(jax.tree.map(jnp.asarray, params), q, act_fn="gelu")
        got = tlinear.chain_out_aq(from_jax_numpy(params), q, act_fn="gelu")
        assert (got is None) == (want is None)
        if got is not None:
            assert {k: v for k, v in got.items() if k != "log2_scale"} == \
                {k: v for k, v in want.items() if k != "log2_scale"}
            assert float(got["log2_scale"]) == float(want["log2_scale"])
    out_aq = tlinear.chain_out_aq(from_jax_numpy(dep), q, act_fn="gelu")
    got = tlinear.apply_linear(from_jax_numpy(dep), torch.zeros((1, 64)), q, int_forward=True,
                               int_chain=True, out_aq=out_aq)
    assert isinstance(got, tlinear.IntAct) and got.codes.dtype == torch.int8
    # a non-gated MLP is a producer/consumer chain: under int_chain w_in
    # requantizes into w_out in its epilogue and w_out takes the codes
    w_out = {**from_jax_numpy(dep), "q8": from_jax_numpy(dep)["q8"][:40]}  # 40 -> 40
    mlp = {"w_in": from_jax_numpy(dep), "w_out": w_out}
    rep: dict = {}
    with tlinear.chain_report_scope(rep):
        y = _apply_mlp(mlp, torch.zeros((1, 1, 64)), q, torch.float32, True, True)
    assert y.shape == (1, 1, 40) and rep["chained"] == ["mlp.w_in"]


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

# one block's deployed linears in a cacheless forward, in call order, by block
# kind (gated MLPs; MLA materializes wkv_b without a cache)
_ATTN = ["attn.wq", "attn.wk", "attn.wv", "attn.wo"]
_MLA = ["mla.wq_a", "mla.wq_b", "mla.wkv_a", "mla.wkv_b", "mla.wo"]
_MLP = ["mlp.w_in", "mlp.w_gate", "mlp.w_out"]
_SHARED = ["moe.shared_gate", "moe.shared_in", "moe.shared_out"]


def _block_sites(s):
    attn = _MLA if s.attn.kind == "mla" else _ATTN
    return attn + (_MLP if s.kind == "attn_mlp" else _SHARED)


@pytest.fixture(scope="module")
def deployed():
    """Per arch: the JAX init deployed to int8, as numpy."""
    out = {}
    for name in ARCHS:
        arch = jreduced(jget_arch(name))
        params = jax.jit(lambda k: jdeploy_params(unbox(jinit_lm(k, arch)), arch.quant))(
            jax.random.PRNGKey(0))
        out[name] = jax.tree.map(np.asarray, params)
    return out


def _tokens(vocab):
    return np.random.default_rng(23).integers(0, vocab, (2, 6)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("chain", [True, False], ids=["int_chain", "int_forward"])
def test_chain_report_matches_jax_site_for_site(deployed, name, chain):
    """The JAX report lists each stacked block's call sites once (a scanned
    stack is traced once); the port's eager report lists them for every
    layer.  Both must give the block's sites in call order, per stack, then
    the head: ``folded`` under int_chain, ``standalone`` without it, and the
    routed experts as ``fallback``."""
    jarch = jreduced(jget_arch(name))
    mla = name.startswith("deepseek")
    jrt = JRuntime(int_forward=True, int_chain=chain, mla_absorb=mla)
    toks = _tokens(jarch.vocab)
    jax.jit(lambda p, t: japply_lm(p, jarch, tokens=t, rt=jrt)[0])(
        jax.tree.map(jnp.asarray, deployed[name]), jnp.asarray(toks))
    arch = reduced(get_arch(name))
    rt = Runtime(int_forward=True, int_chain=chain, mla_absorb=mla)
    apply_lm(from_jax_numpy(deployed[name]), arch, tokens=torch.from_numpy(toks), rt=rt)
    head = [] if arch.tie_embeddings else ["head"]
    kind = "folded" if chain else "standalone"
    assert jrt.chain_report[kind] == sum((_block_sites(s) for s in arch.stacks), []) + head
    assert rt.chain_report[kind] == sum((_block_sites(s) * s.count for s in arch.stacks), []) + head
    other = "standalone" if chain else "folded"
    assert jrt.chain_report[other] == rt.chain_report[other] == []
    assert jrt.chain_report["chained"] == rt.chain_report["chained"] == []
    experts = [s for s in arch.stacks if s.kind == "moe"]
    assert jrt.chain_report["fallback"] == ["moe.experts"] * len(experts)
    assert rt.chain_report["fallback"] == ["moe.experts"] * sum(s.count for s in experts)


def _prompts(vocab):
    rng = np.random.default_rng(29)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (6, 9, 3)]


@pytest.mark.parametrize("name", ARCHS)
def test_int_chain_is_a_pure_dispatch_fusion(deployed, name):
    """Chained and unchained int-forward runs of the port: prompt logits
    bitwise equal, and the engine (int8 KV, decode kernel) serves identical
    tokens with identical margins; the chained run pays no standalone
    act-quant."""
    arch = reduced(get_arch(name))
    mla = name.startswith("deepseek")
    params = from_jax_numpy(deployed[name])
    toks = torch.from_numpy(_tokens(arch.vocab))
    logits = [apply_lm(params, arch, tokens=toks,
                       rt=Runtime(int_forward=True, int_chain=c, mla_absorb=mla))[0]
              for c in (True, False)]
    assert torch.equal(logits[0], logits[1])
    runs = []
    for chain in (True, False):
        e = PagedServeEngine(arch, params, device="cpu", kv_quant=True, **ENGINE,
                             rt=Runtime(int_forward=True, int_chain=chain, decode_kernel=True,
                                        mla_absorb=mla))
        runs.append((e.generate(_prompts(arch.vocab), max_new=4), e))
    (outs_c, ec), (outs_u, eu) = runs
    assert outs_c == outs_u
    assert [r.margins for r in ec.last_requests] == [r.margins for r in eu.last_requests]
    tc, tu = ec.throughput(), eu.throughput()
    assert tc["int_chain_requant_dispatches"] == 0
    assert tc["int_chain_folded"] == tu["int_chain_requant_dispatches"] > 0


def test_runtime_int_chain_implies_int_forward():
    rt = Runtime(int_chain=True)
    assert rt.int_forward and rt.int_chain
    assert not Runtime(int_forward=True).int_chain


_LAUNCH = ["--arch", "yi-6b", "--reduced", "--paged", "--decode-kernel", "--device", "cpu",
           "--requests", "2", "--prompt-len", "5", "--max-new", "3", "--batch", "2",
           "--max-seq", "16", "--block-size", "4", "--prefill-chunk", "4"]


def test_launcher_int_chain_and_int_kv_flags(capsys):
    """``--int-chain`` implies ``--int-forward`` and ``--deploy-int8`` and
    reports zero standalone act-quant calls; ``--kv-int8 --kv-bits 4`` serves
    packed int4 pools."""
    outs = launch_serve.main(_LAUNCH + ["--int-chain", "--kv-int8", "--kv-bits", "4"])
    assert [len(o) for o in outs] == [3, 3]
    text = capsys.readouterr().out
    assert "serving deployed int8 weights" in text and "int-chain" in text
    assert "0 standalone act-quant" in text and "folded" in text


@pytest.mark.parametrize("extra", [["--kv-bits", "4"], ["--kv-bits", "2", "--kv-int8"]],
                         ids=["kv-bits-without-kv-int8", "kv-bits-2"])
def test_launcher_refuses_bad_kv_flags(extra):
    with pytest.raises(SystemExit):
        launch_serve.main(_LAUNCH + extra)
