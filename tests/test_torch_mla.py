"""MLA (deepseek-v3's attention) in the port against the JAX package.

Reduced deepseek-v3 (fp32, 4 heads, kv_lora_rank 16, qk_rope_dim 8) with
params from the JAX initializers, carried over by
``repro_torch.convert.from_jax_numpy``.  Covered:

* the MLA layer over a paged latent cache — a prefill chunk, then decode
  steps — on the materialized path (``mla_absorb=False``) and the absorbed
  path (``mla_absorb=True``; the port's decode read through
  ``ops.paged_mla_attention``, the reference's through its gathered view);
* ``ops.paged_mla_attention`` (on the CPU: the plain version) against the
  JAX package's jnp oracle ``ref.ref_paged_mla_attention`` on numpy inputs:
  fp32, int8 and packed-int4 pools, the activation fake-quant replay,
  zero-length rows and a trash-block entry past the length;
* the parameter tree: the JAX init of the whole reduced model (MLA, stacked
  and shared experts, the MTP head) loads leaf for leaf, the port's init
  builds the same tree, and the port's ``deploy_params`` of it equals the
  reference's deployed tree;
* the whole engine: the port's ``PagedServeEngine(rt=Runtime(int_forward=
  True, decode_kernel=True, mla_absorb=True))`` against the reference
  engine with the same runtime (Pallas in interpret mode), one reference
  run for the file.

The JAX side runs under ``jax.jit`` (eager JAX compiles op by op, which
costs more than the tests themselves).

A counter on ``ops.paged_mla_attention`` shows that the absorbed decode
reaches the kernel op, and that without ``mla_absorb`` it does not.

Tolerances: layer outputs 1e-4 (the same fp32 arithmetic summed in another
order, through two low-rank projections and a softmax); the kernel op 1e-5
(one fp32 softmax); engine tokens exactly (``parity_up_to_ties`` at eps 0
after checking that no step's greedy margin is below 1e-4) and margins to
1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels import ref as jref
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn.attention import apply_attention as japply_attention
from repro.nn.attention import init_attention as jinit_attention
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.nn.attention import apply_attention
from repro_torch.serve.engine import PagedServeEngine, deploy_params, parity_up_to_ties

torch.set_num_threads(1)

NAME = "deepseek-v3-671b"
ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)
MAX_NEW = 5


@pytest.fixture
def mla_calls(monkeypatch):
    """Counts calls of ``ops.paged_mla_attention`` (the layers look it up on
    the module at call time)."""
    calls = []
    real = ops.paged_mla_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "paged_mla_attention", counted)
    return calls


# ---------------------------------------------------------------------------
# The layer over a paged latent cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer_case():
    arch = jreduced(jget_arch(NAME))
    a = arch.stacks[0].attn
    params = jax.jit(lambda k: unbox(jinit_attention(k, arch.d_model, a, arch.quant)))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    B, T0, steps = 2, 5, 3
    xs = [rng.normal(size=(B, T0, arch.d_model)).astype(np.float32)]
    xs += [rng.normal(size=(B, 1, arch.d_model)).astype(np.float32) for _ in range(steps)]
    pos = [np.broadcast_to(np.arange(T0, dtype=np.int32), (B, T0))]
    pos += [np.full((B, 1), T0 + i, np.int32) for i in range(steps)]
    bt = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)  # entry 3: the trash block
    NB, bs = 8, 4
    pools = {"ckvp": np.zeros((NB, bs, a.kv_lora_rank), np.float32),
             "kpep": np.zeros((NB, bs, a.qk_rope_dim), np.float32)}
    return arch, a, params, xs, pos, bt, pools


def _jax_layer(arch, a, **kw):
    return jax.jit(functools.partial(japply_attention, a=a, q=arch.quant,
                                     q_chunk=arch.attn_q_chunk, compute_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("absorb", [False, True], ids=["materialized", "absorbed"])
def test_mla_layer_paged_prefill_and_decode_match_jax(layer_case, absorb, mla_calls):
    arch, a, params, xs, pos, bt, pools = layer_case
    jcache = {k: jnp.asarray(v) for k, v in pools.items()}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tparams = from_jax_numpy(jax.tree.map(np.asarray, params))
    jlayer = _jax_layer(arch, a, mla_absorb=absorb)
    for x, p in zip(xs, pos):
        want, jcache = jlayer(params, jnp.asarray(x), positions=jnp.asarray(p), cache=jcache,
                              view={"bt": jnp.asarray(bt)})
        got, tcache = apply_attention(
            tparams, torch.from_numpy(x), a, arch.quant, torch.from_numpy(p.copy()), tcache,
            q_chunk=arch.attn_q_chunk, compute_dtype=torch.float32, mla_absorb=absorb,
            view={"bt": torch.from_numpy(bt)}, decode_kernel=True,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for k in pools:  # the pools hold the same latent
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=0, atol=1e-5)
    # the absorbed decode steps (T == 1) read through the kernel op, and only they
    assert len(mla_calls) == (len(xs) - 1 if absorb else 0)


def test_mla_layer_without_cache_matches_jax(layer_case):
    """A cache-less forward (the prompt logits' path): materialized MLA."""
    arch, a, params, xs, pos, _, _ = layer_case
    want, _ = _jax_layer(arch, a)(params, jnp.asarray(xs[0]), positions=jnp.asarray(pos[0]))
    got, _ = apply_attention(from_jax_numpy(jax.tree.map(np.asarray, params)),
                             torch.from_numpy(xs[0]), a, arch.quant,
                             torch.from_numpy(pos[0].copy()), q_chunk=arch.attn_q_chunk,
                             compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The kernel op (plain version on the CPU) against the jnp oracle
# ---------------------------------------------------------------------------

_SCALE = (48 + 16) ** -0.5


def _pack_nibbles(codes: np.ndarray) -> np.ndarray:
    u = (codes.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def _mla_case(pools: str, lens):
    B, H, R, P, NB, bs, MB = len(lens), 8, 32, 8, 16, 4, 5
    rng = np.random.default_rng(40 + len(pools))
    bt = np.zeros((B, MB), np.int32)
    nxt = 1
    for b, ln in enumerate(lens):
        for j in range(-(-ln // bs)):
            bt[b, j] = nxt
            nxt += 1
    bt[0, -1] = NB - 1  # a live-looking block past row 0's length: must not count
    args = {"q_lat": rng.normal(size=(B, H, R)).astype(np.float32),
            "q_pe": rng.normal(size=(B, H, P)).astype(np.float32)}
    kw = {}
    if pools == "fp32":
        args["ckvp"] = rng.normal(size=(NB, bs, R)).astype(np.float32)
        args["kpep"] = rng.normal(size=(NB, bs, P)).astype(np.float32)
    else:
        lim = 128 if pools == "int8" else 8
        ckv = rng.integers(-lim + 1, lim, (NB, bs, R)).astype(np.int8)
        kpe = rng.integers(-lim + 1, lim, (NB, bs, P)).astype(np.int8)
        if pools == "int4":
            ckv, kpe = _pack_nibbles(ckv), _pack_nibbles(kpe)
        args["ckvp"], args["kpep"] = ckv, kpe
        kw["ckvs"] = rng.uniform(0.005, 0.05, (NB, bs)).astype(np.float32)
        kw["kpes"] = rng.uniform(0.005, 0.05, (NB, bs)).astype(np.float32)
    args["bt"] = bt
    args["lengths"] = np.asarray(lens, np.int32)
    return args, kw


def _both(args, kw, **extra):
    got = ops.paged_mla_attention(*(torch.from_numpy(v) for v in args.values()),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()},
                                  scale=_SCALE, **extra)
    jextra = {k: (jnp.asarray(v) if k == "aq_scale" else v) for k, v in extra.items()}
    want = jref.ref_paged_mla_attention(*(jnp.asarray(v) for v in args.values()),
                                        *(jnp.asarray(kw[k]) for k in ("ckvs", "kpes") if k in kw),
                                        scale=_SCALE, **jextra)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pools", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
def test_paged_mla_attention_plain_matches_jnp_oracle(pools, act_quant):
    args, kw = _mla_case(pools, [6, 0, 13, 1])
    extra = dict(aq_scale=np.float32(0.017), act_bits=8) if act_quant else {}
    if act_quant and pools == "fp32":
        extra["aq_scale"] = np.float32(0.03)
    got, want = _both(args, kw, **extra)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.isfinite(got).all() and np.abs(got[1]).max() == 0.0  # zero-length row
    if act_quant:  # the replay is load-bearing
        plain, _ = _both(args, kw)
        assert np.abs(got - plain).max() > 1e-6


def test_paged_mla_attention_ignores_entries_past_the_length():
    args, kw = _mla_case("fp32", [6, 9])
    base, _ = _both(args, kw)
    args["bt"] = args["bt"].copy()
    args["bt"][0, 2:] = 3  # garbage beyond row 0's two blocks
    redirected, _ = _both(args, kw)
    np.testing.assert_array_equal(base, redirected)


def test_paged_mla_attention_arg_validation():
    args, kw = _mla_case("int8", [4])
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    with pytest.raises(ValueError):  # scale pools must pair
        ops.paged_mla_attention(*t.values(), ckvs=torch.from_numpy(kw["ckvs"]), scale=_SCALE)
    with pytest.raises(ValueError):  # aq_scale and act_bits must pair
        ops.paged_mla_attention(*t.values(), scale=_SCALE, act_bits=8)
    packed = dict(t, ckvp=t["ckvp"][..., ::2].to(torch.uint8).contiguous(),
                  kpep=t["kpep"][..., ::2].to(torch.uint8).contiguous())
    with pytest.raises(ValueError):  # packed int4 needs its scale pools
        ops.paged_mla_attention(*packed.values(), scale=_SCALE)


# ---------------------------------------------------------------------------
# The slice as a whole: the paged engine with the absorbed MLA kernel path
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (4, 9, 8)]


@pytest.fixture(scope="module")
def reference():
    """The JAX init of reduced deepseek-v3 (MLA + MoE + MTP head), its
    deployed tree (both as numpy), and the JAX engine's driven requests."""
    arch = jreduced(jget_arch(NAME))
    params = jax.jit(lambda k: unbox(jinit_lm(k, arch)))(jax.random.PRNGKey(0))
    deployed = jax.jit(lambda p: jdeploy_params(p, arch.quant))(params)
    e = JPagedServeEngine(arch, deployed, **ENGINE,
                          rt=JRuntime(int_forward=True, decode_kernel=True, mla_absorb=True))
    e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, deployed),
            e.last_requests)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_params_load_and_deploy_leaf_for_leaf(reference):
    """The JAX tree (MLA, stacked experts, shared experts, MTP head) loads
    with no reshaping; the port's init builds the same tree, and its
    ``deploy_params`` of the loaded float tree gives the reference's deployed
    tree: codes exactly, scales to 1e-6 (``exp2`` last bits)."""
    params_np, deployed_np, _ = reference
    arch = reduced(get_arch(NAME))
    own = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    ref_shapes = [(p, v.shape) for p, v in _leaves(params_np)]
    assert [(p, tuple(v.shape)) for p, v in _leaves(own)] == ref_shapes
    assert any("/mtp/" in p for p, _ in ref_shapes)
    assert any(p.endswith("/moe/w_in/v") for p, _ in ref_shapes)
    got = dict(_leaves(deploy_params(from_jax_numpy(params_np), arch.quant)))
    want = dict(_leaves(deployed_np))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path.endswith("/q8"):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=path)


def test_paged_engine_absorbed_kernel_path_matches_jax_engine(reference, mla_calls):
    _, params_np, ref_reqs = reference
    arch = reduced(get_arch(NAME))
    e = PagedServeEngine(arch, from_jax_numpy(params_np), device="cpu", **ENGINE,
                         rt=Runtime(int_forward=True, decode_kernel=True, mla_absorb=True))
    outs = e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
    assert min(m for r in ref_reqs for m in r.margins) > 1e-4  # no near-tie to excuse
    ok, ties, detail = parity_up_to_ties(ref_reqs, outs, 0.0)
    assert ok and ties == 0, detail
    for r, req in zip(ref_reqs, e.last_requests):
        assert len(req.generated) == MAX_NEW
        np.testing.assert_allclose(req.margins, r.margins, rtol=0, atol=1e-4)
    # every single-token forward in every layer: the decode ticks, and the
    # last prefill chunk of a prompt that leaves one token over
    ticks = e.throughput()["decode_dispatches"]
    ones = sum(len(p) % ENGINE["prefill_chunk"] == 1 for p in _prompts(arch.vocab))
    n_mla = sum(s.count for s in arch.stacks)
    assert ticks > 0 and len(mla_calls) == n_mla * (ticks + ones)
    # without mla_absorb the decode kernel flag never reaches the MLA kernel
    mla_calls.clear()
    PagedServeEngine(arch, from_jax_numpy(params_np), device="cpu", **ENGINE,
                     rt=Runtime(int_forward=True, decode_kernel=True)).generate(
        _prompts(arch.vocab), max_new=2)
    assert mla_calls == []
