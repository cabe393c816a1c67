"""The port's layers and model against the JAX package on the same inputs.

Parameters are drawn by the JAX initializers and carried over with
``repro_torch.convert.from_jax_numpy``; activations come from numpy.  Both
sides compute in float32 (the reduced configs).  Tolerances:

* integer artifacts (deployed ``q8`` codes) — exact;
* float layer outputs — rtol 1e-5: the same fp32 arithmetic, summed in
  another order, plus scales that are ``exp2`` of a learned log2 value,
  where ``jnp.exp2`` and ``torch.exp2`` may differ in the last bits;
* logits of the reduced models — rtol 1e-4 of the logits' scale, after up
  to two dozen such layers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_lm as jinit_lm
from repro.nn.attention import apply_attention as japply_attention
from repro.nn.attention import init_attention as jinit_attention
from repro.nn.linear import apply_linear as japply_linear
from repro.nn.linear import deploy_linear as jdeploy_linear
from repro.nn.linear import init_linear as jinit_linear
from repro.nn.module import unbox
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime, apply_lm
from repro_torch.nn.attention import apply_attention
from repro_torch.nn.linear import apply_linear, deploy_linear
from repro_torch.serve.engine import deploy_params

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
A2Q = dict(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_jax_numpy(_np(tree))


@pytest.mark.parametrize("K,C,signed,boundary", [(576, 192, True, False), (100, 24, False, True)])
def test_deploy_linear_codes_match(K, C, signed, boundary):
    """Deployed int8 codes equal the reference's bit for bit; the
    per-channel scale ``exp2(d)`` agrees to rtol 1e-6 (8 fp32 ulp: the most
    ``jnp.exp2`` and ``torch.exp2`` were measured to differ by)."""
    jp = unbox(jinit_linear(jax.random.PRNGKey(K + C), K, C, JQuantConfig(**A2Q),
                            input_signed=signed, boundary=boundary))
    jd = jdeploy_linear(jp, JQuantConfig(**A2Q), input_signed=signed, boundary=boundary)
    td = deploy_linear(_port(jp), QuantConfig(**A2Q), input_signed=signed, boundary=boundary)
    np.testing.assert_array_equal(td["q8"].numpy(), np.asarray(jd["q8"]))
    assert td["q8"].dtype == torch.int8
    np.testing.assert_allclose(td["s8"].numpy(), np.asarray(jd["s8"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["none", "qat", "a2q", "a2q-int-forward"])
def test_apply_linear_matches(mode):
    """Each quantization mode, and the deployed layer on the fused integer
    path, gives the reference's output (rtol 1e-5)."""
    int_forward = mode == "a2q-int-forward"
    cfg = dict(A2Q, mode=mode.split("-")[0])
    jp = unbox(jinit_linear(jax.random.PRNGKey(3), 96, 40, JQuantConfig(**cfg), use_bias=True))
    jp["b"] = jnp.asarray(np.random.default_rng(1).normal(size=(40,)), jnp.float32)
    if int_forward:
        jp = jdeploy_linear(jp, JQuantConfig(**cfg))
    x = np.random.default_rng(2).normal(size=(5, 96)).astype(np.float32)
    jy = japply_linear(jp, jnp.asarray(x), JQuantConfig(**cfg), compute_dtype=jnp.float32,
                       int_forward=int_forward)
    ty = apply_linear(_port(jp), torch.from_numpy(x), QuantConfig(**cfg),
                      compute_dtype=torch.float32, int_forward=int_forward)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)


def _pools(rng, count, NB, bs, KV, Dh):
    shape = (count, NB, bs, KV, Dh)
    return {"kp": rng.normal(size=shape).astype(np.float32),
            "vp": rng.normal(size=shape).astype(np.float32)}


@pytest.mark.parametrize("T", [1, 5])
def test_paged_attention_layer_matches(T):
    """One GQA layer over paged pools (prefill chunk T=5, decode T=1 through
    the decode kernel's plain version), including a write whose position
    falls past the block table (not raised; into the trash block 0, where
    the reference drops it): output rtol 1e-5 and the written pools exact
    outside the trash block.  At T=5 row 2's table maps its positions 4-7
    to the trash block, which those writes fill (a live row's table never
    maps a position below its length there), so its output is not held to
    the reference's."""
    a = jreduced(jget_arch("yi-6b")).stacks[0].attn  # H=4 over KV=1
    cfg = JQuantConfig(**A2Q)
    jp = unbox(jinit_attention(jax.random.PRNGKey(5), 64, a, cfg))
    rng = np.random.default_rng(6)
    pools = {k: v[0] for k, v in _pools(rng, 1, 6, 4, a.kv_heads, a.head_dim).items()}
    bt = np.asarray([[1, 2], [3, 4], [5, 0]], np.int32)  # MB=2 -> 8 positions per row
    start = np.asarray([2, 0, 6], np.int32)[:, None]
    pos = start + np.arange(T, dtype=np.int32)[None, :]  # row 2 runs past its table at T=5
    x = rng.normal(size=(3, T, 64)).astype(np.float32)
    jfn = jax.jit(lambda p, x, pos, cache, bt: japply_attention(
        p, x, a, cfg, pos, cache, compute_dtype=jnp.float32, view={"bt": bt}))
    jo, jc = jfn(jp, jnp.asarray(x), jnp.asarray(pos),
                 {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(bt))
    tc = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    to, tc2 = apply_attention(_port(jp), torch.from_numpy(x),
                              reduced(get_arch("yi-6b")).stacks[0].attn,
                              QuantConfig(**A2Q), torch.from_numpy(pos), tc,
                              compute_dtype=torch.float32, view={"bt": torch.from_numpy(bt)},
                              decode_kernel=True)
    rows = slice(None) if T == 1 else slice(0, 2)
    np.testing.assert_allclose(to.numpy()[rows], np.asarray(jo)[rows], rtol=1e-5, atol=1e-5)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(tc2[k].numpy()[1:], np.asarray(jc[k])[1:], rtol=1e-5,
                                   atol=1e-6)


@functools.cache
def _jax_model(name):
    """(reference arch, port arch, raw A2Q params, deployed params), drawn
    once per module by the JAX initializers."""
    jarch = jreduced(jget_arch(name))
    raw = unbox(jinit_lm(KEY, jarch))
    return jarch, reduced(get_arch(name)), raw, jdeploy_params(raw, jarch.quant)


@pytest.mark.parametrize("name", ["smollm-135m", "yi-6b"])
def test_deploy_params_codes_match(name):
    """Deploying the whole reduced model gives the reference's codes in every
    stacked leaf, bit for bit."""
    jarch, arch, raw, deployed = _jax_model(name)
    jd = _np(deployed)
    td = deploy_params(_port(raw), arch.quant)

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
        elif path[-1] == "q8":
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))

    walk(jd, td, ())


@pytest.mark.parametrize("name", ["smollm-135m", "yi-6b"])
def test_model_prefill_decode_logits_match(name):
    """Deployed reduced model over paged pools: a 6-token prefill of two rows,
    then a decode step at per-row positions, on the fused integer path (the
    port also reads the decode step through the paged-attention kernel's
    plain version).  Logits agree to rtol 1e-4 of their scale at each step."""
    jarch, arch, _, jparams = _jax_model(name)
    s = jarch.stacks[0]
    rng = np.random.default_rng(7)
    shape = (s.count, 9, 4, s.attn.kv_heads, s.attn.head_dim)
    pools = {"kp": np.zeros(shape, np.float32), "vp": np.zeros(shape, np.float32)}
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jrt = JRuntime(int_forward=True)
    rt = Runtime(int_forward=True, decode_kernel=True)
    jcache = {"0": {"attn": {k: jnp.asarray(v) for k, v in pools.items()}}}
    tcache = {"0": {"attn": {k: torch.from_numpy(v.copy()) for k, v in pools.items()}}}
    tparams = _port(jparams)
    steps = [(rng.integers(0, jarch.vocab, (2, 6)), np.asarray([0, 0]))]
    steps.append((rng.integers(0, jarch.vocab, (2, 1)), np.asarray([6, 6])))
    for toks, start in steps:
        toks = toks.astype(np.int32)
        start = start.astype(np.int32)
        jl, jc, _ = japply_lm(jparams, jarch, tokens=jnp.asarray(toks),
                              cache={**jcache, "_paged": {"bt": jnp.asarray(bt)}},
                              start_pos=jnp.asarray(start), rt=jrt)
        jcache = jc
        tl, _ = apply_lm(tparams, arch, tokens=torch.from_numpy(toks),
                         cache={**tcache, "_paged": {"bt": torch.from_numpy(bt)}},
                         start_pos=torch.from_numpy(start), rt=rt)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
    # every deployed linear of the last forward took the fused path
    assert len(rt.chain_report["standalone"]) == 7 * s.count + ("head" in jparams)
    assert rt.chain_report["fallback"] == []
