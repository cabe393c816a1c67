"""llama4-scout (chunk-local RoPE layers, NoPE global layers, top-1 MoE with a
shared expert) in the port against the JAX package.

Reduced llama4-scout-17b-a16e: its first iRoPE stacks cut to 2 chunk-local
layers (chunk 16) and 1 NoPE global layer, 8 experts top-1 plus 1 shared,
fp32 compute, params from the JAX initializer loaded with
``from_jax_numpy``.  Covered:

* the cacheless forward (T=40, across two chunk boundaries) against JAX,
  float and deployed ``int_chain`` (activation scales pinned to powers of
  two); the chunk-local layers take ``_sdpa`` with the chunk mask (the flash
  kernel masks no chunks) and the global layer the flash kernel;
* the cached forward over a contiguous cache (the local layers' rings of 16
  slots, the global layer's lane) in chunks that cross the boundaries,
  logits and every cache leaf against JAX's;
* the MoE at top-1 with a shared expert and capacity factor 1.25 against
  JAX's ``apply_moe`` (drops included), in the static slot form with
  ``min(E, T * k)`` slots;
* the paged engine, per tick and on the megastep, against JAX's per-tick
  ``PagedServeEngine`` (``parity_up_to_ties``; the reference's megastep
  gives its per-tick tokens, ``tests/test_megastep.py``), prompts of 20-40
  tokens across chunk boundaries, four requests over two slots; the port's
  megastep against its per-tick engine bit for bit; ``paged_attention`` launches on the global
  layer only; the contiguous ``ServeEngine``; the launcher.

Tolerances: logits rtol 1e-4 of their scale, cache leaves and MoE outputs
1e-5 (fp32 sums in another order), engine margins 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.moe as jmoe
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

import repro_torch.nn.moe as moe
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime, apply_lm, init_cache
from repro_torch.serve.engine import PagedServeEngine, ServeEngine, parity_up_to_ties

torch.set_num_threads(1)

NAME = "llama4-scout-17b-a16e"
TOL = 1e-4
ENGINE = dict(batch=2, max_seq=48, block_size=4, prefill_chunk=8)
LENS = (23, 37, 20, 33)  # across the chunk boundaries at 16 and 32
MAX_NEW = 5


def _pin_scales(tree):
    """Every activation scale pinned to the power of two below it."""
    if isinstance(tree, dict):
        return {k: (jnp.floor(v) if k == "log2_scale" else _pin_scales(v))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def model():
    """Reduced llama4-scout from the JAX initializer (scales pinned), float
    and deployed, as numpy."""
    jarch = jreduced(jget_arch(NAME))
    fl = _pin_scales(jax.jit(lambda k: unbox(jinit_lm(k, jarch)))(jax.random.PRNGKey(0)))
    dep = jax.jit(lambda p: jdeploy_params(p, jarch.quant))(fl)
    return jarch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


def _arch():
    return reduced(get_arch(NAME))


def test_reduced_config_is_one_irope_period():
    local, glob = _arch().stacks
    assert (local.kind, local.count, local.attn.chunk, local.attn.rope_theta is not None) == \
        ("moe", 2, 16, True)
    assert (glob.kind, glob.count, glob.attn.chunk, glob.attn.rope_theta) == ("moe", 1, None, None)
    assert (local.moe.top_k, local.moe.n_shared) == (1, 1)


def _close(tl, jl, rtol=1e-4):
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=rtol, atol=rtol * np.abs(jl).max())


_LM = {"float": ("float", {}), "int_chain": ("deployed", dict(int_chain=True))}


@pytest.mark.parametrize("path", list(_LM))
def test_cacheless_forward_matches_jax(model, path, monkeypatch):
    """T=40 over chunks of 16: logits against JAX's; the flash kernel (its
    plain version here) runs for the global layer only, the chunk-local
    layers take ``_sdpa``."""
    jarch, fl, dep = model
    which, kw = _LM[path]
    p = fl if which == "float" else dep
    toks = np.random.default_rng(5).integers(0, jarch.vocab, (2, 40)).astype(np.int32)
    jl = jax.jit(lambda p, t: japply_lm(p, jarch, tokens=t, rt=JRuntime(**kw))[0])(
        jax.tree.map(jnp.asarray, p), jnp.asarray(toks))
    calls = []
    plain = ops.flash_attention_plain
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tl, _ = apply_lm(from_jax_numpy(p), _arch(), tokens=torch.from_numpy(toks), rt=Runtime(**kw))
    _close(tl, jl)
    assert len(calls) == 1  # the NoPE global layer


def test_cached_prefill_across_chunk_boundaries(model):
    """A contiguous cache fed 7, 13, 13 and 1 tokens (across the boundaries at
    16 and 32; the rings of 16 slots wrap): logits and every cache leaf
    against JAX's."""
    jarch, fl, _ = model
    arch = _arch()
    jp, tp = jax.tree.map(jnp.asarray, fl), from_jax_numpy(fl)
    toks = np.random.default_rng(6).integers(0, arch.vocab, (2, 34)).astype(np.int32)
    jcache = jinit_cache(jarch, 2, 40, dtype=jnp.float32)
    cache = init_cache(arch, 2, 40, dtype=torch.float32, device="cpu")
    assert cache["0"]["attn"]["k"].shape[2] == 16 and cache["1"]["attn"]["k"].shape[2] == 40
    step = jax.jit(lambda p, t, c, sp: japply_lm(p, jarch, tokens=t, cache=c, start_pos=sp)[:2])
    for lo, hi in ((0, 7), (7, 20), (20, 33), (33, 34)):
        jl, jcache = step(jp, jnp.asarray(toks[:, lo:hi]), jcache, jnp.int32(lo))
        tl, _ = apply_lm(tp, arch, tokens=torch.from_numpy(toks[:, lo:hi]), cache=cache,
                         start_pos=lo)
        _close(tl, jl)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jcache))[0],
            jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), cache))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("T", [1, 5, 40])
def test_moe_top1_matches_jax(model, T, monkeypatch):
    """llama4's MoE (top-1, one shared expert) at capacity factor 1.25 on T
    tokens: the output against JAX's ``apply_moe`` (T=40 drops tokens: 5
    rows an expert), on ``min(E, T)`` expert slots."""
    jarch, fl, _ = model
    cfg = dataclasses.replace(jarch.stacks[0].moe, capacity_factor=1.25)
    p = fl["stacks"]["0"]["moe"]
    layer = jax.tree.map(lambda v: v[0], p)
    x = np.random.default_rng(T).normal(size=(1, T, jarch.d_model)).astype(np.float32)
    want = jax.jit(lambda pp, xx: jmoe.apply_moe(pp, xx, cfg, jarch.quant,
                                                 compute_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    slots = []
    ffn = moe._local_expert_ffn
    monkeypatch.setattr(moe, "_local_expert_ffn",
                        lambda *a: slots.append(a[-1]) or ffn(*a))
    got = moe.apply_moe(from_jax_numpy(layer), torch.from_numpy(x), cfg, jarch.quant,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert slots == [min(cfg.n_experts, T * cfg.top_k)]


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def jax_engine(model):
    """The JAX paged engine's requests on the float params, per tick."""
    jarch, fl, _ = model
    e = JPagedServeEngine(jarch, jax.tree.map(jnp.asarray, fl), **ENGINE)
    e.generate(_prompts(jarch.vocab), max_new=MAX_NEW)
    return e.last_requests


@pytest.mark.parametrize("steps", [1, 4], ids=["per-tick", "megastep"])
def test_paged_engine_matches_jax_engine(model, jax_engine, steps):
    """Four requests over two slots, prompts across the chunk boundaries:
    tokens under ``parity_up_to_ties`` (no tie) and margins against the
    reference's engine; every block freed."""
    _, fl, _ = model
    e = PagedServeEngine(_arch(), from_jax_numpy(fl), decode_steps=steps, device="cpu",
                         **ENGINE)
    outs = e.generate(_prompts(e.arch.vocab), max_new=MAX_NEW)
    ref = jax_engine
    ok, ties, detail = parity_up_to_ties(ref, outs, TOL)
    assert ok and ties == 0, detail
    for r, q in zip(ref, e.last_requests):
        np.testing.assert_allclose(q.margins, r.margins, rtol=0, atol=TOL)
    assert e.cache.free_blocks == e.cache.num_blocks - 1


def test_decode_kernel_on_global_layers_only(model, monkeypatch):
    """With ``decode_kernel=True`` the deployed ``int_chain`` engine reads
    the global layer's pools through ``paged_attention`` (its plain version
    here) once a decode tick, the chunk-local rings through ``_sdpa``; its
    megastep gives the per-tick engine's tokens and margins bit for bit, and
    the gathered-view read the same tokens."""
    _, _, dep = model
    calls = []
    plain = ops.paged_attention_plain
    monkeypatch.setattr(ops, "paged_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    runs = {}
    for steps in (1, 4):
        e = PagedServeEngine(_arch(), from_jax_numpy(dep), decode_steps=steps, device="cpu",
                             rt=Runtime(int_chain=True, decode_kernel=True), **ENGINE)
        calls.clear()
        outs = e.generate(_prompts(e.arch.vocab, seed=3), max_new=MAX_NEW)
        ticks = e.throughput()["decode_dispatches"] * steps
        # one global layer; a one-token prefill chunk (33 = 4 * 8 + 1) reads
        # through the kernel too, as a decode step does
        tails = sum(n % ENGINE["prefill_chunk"] == 1 for n in LENS)
        assert tails == 1 and len(calls) == ticks + tails
        runs[steps] = (outs, [r.margins for r in e.last_requests])
    assert runs[1] == runs[4]
    e = PagedServeEngine(_arch(), from_jax_numpy(dep), device="cpu",
                         rt=Runtime(int_chain=True), **ENGINE)
    e.generate(_prompts(e.arch.vocab, seed=3), max_new=MAX_NEW)
    ok, ties, detail = parity_up_to_ties(e.last_requests, runs[1][0], TOL)
    assert ok, detail


def test_contiguous_engine_matches_paged(model):
    """The contiguous ``ServeEngine`` (per-token prefill into rings of 16 and
    the global layer's lane) gives the paged engine's tokens on one slot fed
    a token a forward: the MoE router then sees the same single row in both
    (with more rows, or longer chunks, the two engines route different
    batches and their capacity drops differ, as in the reference)."""
    _, fl, _ = model
    arch, params = _arch(), from_jax_numpy(fl)
    prompts = _prompts(arch.vocab, seed=7)[:2]
    contig = ServeEngine(arch, params, batch=1, max_seq=48, device="cpu")
    outs = contig.generate(prompts, max_new=4)
    assert contig.cache["0"]["attn"]["k"].shape[2] == 16
    paged = PagedServeEngine(arch, params, batch=1, max_seq=48, block_size=4, prefill_chunk=1,
                             device="cpu")
    ok, ties, detail = parity_up_to_ties(contig.last_requests,
                                         paged.generate(prompts, max_new=4), TOL)
    assert ok and ties == 0, detail
    assert [len(o) for o in outs] == [4, 4]


def test_launcher_serves_llama4(capsys):
    """``--arch llama4-scout-17b-a16e --paged --int-chain --decode-kernel
    --decode-steps 4`` serves the reduced model: the shared expert's and the
    attention's linears folded, the routed experts a fallback."""
    from repro_torch.launch import serve as launch_serve

    outs = launch_serve.main(["--arch", NAME, "--reduced", "--paged", "--int-chain",
                              "--decode-kernel", "--decode-steps", "4", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "20", "--max-new", "4",
                              "--batch", "2", "--max-seq", "32", "--block-size", "4",
                              "--prefill-chunk", "8"])
    assert [len(o) for o in outs] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "22 folded, 0 chained, 0 standalone act-quant, 3 fallback" in text
    assert "0 violations" in text
