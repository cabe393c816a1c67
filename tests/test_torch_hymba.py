"""hymba (parallel sliding-window attention + Mamba-2 SSD heads) in the port
against the JAX package.

Covered:

* the three SSD forms (``ssd_sequential``, ``ssd_chunked``, ``ssd_decode_step``)
  against ``repro.nn.ssm``'s, the chunked form where some decays lie below
  ``e^-8`` (where its clamp acts, as in the reference); chunked against
  sequential in the port where no decay is clamped; their dtypes;
* ``apply_mamba_heads``, float and deployed on ``int_chain``: cacheless (the
  chunked form) and over a carried state (a 5-token sequential, a decode, an
  8-token chunked and a decode step) against JAX, outputs and states; the
  whole sequence against the same tokens fed step by step;
* reduced hymba-1.5b (window 16, SSD chunk 8): cacheless and cached
  ``apply_lm`` logits and cache leaves against JAX, float and deployed
  ``int_chain`` (every activation scale pinned to a power of two, where
  ``jnp.exp2`` and ``torch.exp2`` agree); the A2Q penalty reaches the mamba
  linears; the deploy keeps ``A_log``/``D``/``dt_bias`` in fp32;
* the paged engine against JAX's ``PagedServeEngine`` under
  ``parity_up_to_ties``: prompts past the window, more requests than slots,
  prefill chunks of 8 (the chunked form, sequential tails) per tick and of
  4 (the sequential form) on the megastep; the port's megastep against its
  per-tick engine bit for bit; the contiguous ``ServeEngine`` (lockstep
  groups) against the paged engine; the cache's ``mamba.S`` leaf
  (``reset_slot``, ``slice_slot``, ``state_bytes_per_slot``); the launcher.

Tolerances (fp32 throughout: the reduced configs compute in fp32): the SSD
forms 1e-4 (fp32 sums in another order, the chunked form through exp/log);
sublayer outputs rtol 1e-5 of their scale; logits rtol 1e-4 of their scale;
engine tokens under ``parity_up_to_ties`` at 1e-4 and margins to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.nn import ssm as jssm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime, a2q_penalty_of, apply_lm, init_cache
from repro_torch.nn import ssm
from repro_torch.serve.engine import (
    PagedServeEngine,
    ServeEngine,
    deploy_params,
    parity_up_to_ties,
)
from repro_torch.serve.paged_cache import PagedKVCache

torch.set_num_threads(1)

NAME = "hymba-1.5b"
TOL = 1e-4
ENGINE = dict(batch=2, max_seq=48, block_size=4)
LENS = (21, 30, 18, 27)  # past the window of 16; four requests over two slots
MAX_NEW = 6


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _ssd_inputs(rng, B, H, T, Dh, N, a_lo=0.5):
    return (rng.normal(size=(B, H, T, Dh)).astype(np.float32),
            rng.uniform(a_lo, 0.999, size=(B, H, T)).astype(np.float32),
            rng.normal(size=(B, H, T, N)).astype(np.float32),
            rng.normal(size=(B, H, T, N)).astype(np.float32),
            rng.normal(size=(B, H, Dh, N)).astype(np.float32))


def _pin_scales(tree):
    """Every activation scale pinned to the power of two below it."""
    if isinstance(tree, dict):
        return {k: (jnp.floor(v) if k == "log2_scale" else _pin_scales(v))
                for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# The three SSD forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["sequential", "chunked", "decode"])
def test_ssd_forms_match_jax(form):
    rng = np.random.default_rng(12)
    x, a, Bm, Cm, s0 = _ssd_inputs(rng, 2, 3, 32, 8, 4)
    if form == "chunked":  # decays below e^-8, where the clamp acts
        a[:, :, ::5] = 1e-5
    jargs = [jnp.asarray(v) for v in (x, a, Bm, Cm, s0)]
    targs = list(_t(x, a, Bm, Cm, s0))
    if form == "decode":
        jargs[:4] = [v[:, :, 0] for v in jargs[:4]]
        targs[:4] = [v[:, :, 0] for v in targs[:4]]
    jfn = {"sequential": jssm.ssd_sequential, "decode": jssm.ssd_decode_step,
           "chunked": lambda *v: jssm.ssd_chunked(*v, chunk=8)}[form]
    tfn = {"sequential": ssm.ssd_sequential, "decode": ssm.ssd_decode_step,
           "chunked": lambda *v: ssm.ssd_chunked(*v, chunk=8)}[form]
    jy, js = jfn(*jargs)
    y, s = tfn(*targs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL)


def test_ssd_chunked_matches_sequential():
    """Where no decay is clamped the chunked form is the oracle's arithmetic
    regrouped: outputs and final state agree, over a carried state."""
    rng = np.random.default_rng(3)
    x, a, Bm, Cm, s0 = _t(*_ssd_inputs(rng, 2, 3, 24, 8, 4, a_lo=0.05))
    yc, sc = ssm.ssd_chunked(x, a, Bm, Cm, s0, chunk=8)
    ys, ss = ssm.ssd_sequential(x, a, Bm, Cm, s0)
    torch.testing.assert_close(yc, ys, rtol=0, atol=TOL)
    torch.testing.assert_close(sc, ss, rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        ssm.ssd_chunked(x[:, :, :20], a[:, :, :20], Bm[:, :, :20], Cm[:, :, :20], s0, chunk=8)


def test_ssd_form_dtypes():
    """The sequential and chunked forms return y in x's dtype, the decode step
    in fp32; the state stays fp32."""
    rng = np.random.default_rng(2)
    x, a, Bm, Cm, s0 = _t(*_ssd_inputs(rng, 1, 2, 8, 4, 4))
    xb = x.to(torch.bfloat16)
    for y, s in (ssm.ssd_sequential(xb, a, Bm, Cm, s0), ssm.ssd_chunked(xb, a, Bm, Cm, s0, 4)):
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y, s = ssm.ssd_decode_step(xb[:, :, 0], a[:, :, 0], Bm[:, :, 0], Cm[:, :, 0], s0)
    assert y.dtype == s.dtype == torch.float32


# ---------------------------------------------------------------------------
# The mamba heads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heads():
    """One reduced hymba block's mamba heads from the JAX initializer, float
    (scales pinned) and deployed, as numpy; a decay spread over (0, 1) and a
    state that matters (``A_log``, ``dt_bias`` drawn), as after training."""
    arch = jreduced(jget_arch(NAME))
    s, q = arch.stacks[0], arch.quant
    fl = _pin_scales(jax.jit(lambda k: unbox(jssm.init_mamba_heads(k, arch.d_model, s.ssm, q)))(
        jax.random.PRNGKey(3)))
    H = arch.d_model // s.ssm.head_dim
    fl["A_log"] = jnp.linspace(-1.0, 1.5, H)
    fl["dt_bias"] = jnp.linspace(-2.0, 0.5, H)
    dep = jax.jit(lambda p: jdeploy_params(p, q))(fl)
    return arch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


_PATHS = {"float": ("float", {}),
          "int_chain": ("deployed", dict(int_forward=True, int_chain=True))}


@pytest.mark.parametrize("path", list(_PATHS))
def test_mamba_heads_match_jax(heads, path):
    """Cacheless T=16 (the chunked form), then over a carried state a 5-token
    (sequential), a 1-token (decode), an 8-token (chunked) and a 1-token step:
    outputs and the state against JAX's; the state updated in place; the
    steps' outputs equal the cacheless forward's on the same 15 tokens fed at
    once (sequential), within the forms' tolerance."""
    arch, fl, dep = heads
    s, q = arch.stacks[0], arch.quant
    which, kw = _PATHS[path]
    p = fl if which == "float" else dep
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_numpy(p)
    B, d = 2, arch.d_model
    H, Dh, N = d // s.ssm.head_dim, s.ssm.head_dim, s.ssm.state_dim
    x = np.random.default_rng(8).normal(size=(B, 16, d)).astype(np.float32)

    def close(t_out, j_out):
        j_out = np.asarray(j_out)
        np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5,
                                   atol=1e-5 * np.abs(j_out).max())

    jfn = jax.jit(lambda p, xs, st: jssm.apply_mamba_heads(p, xs, s.ssm, q, st,
                                                           compute_dtype=jnp.float32, **kw))
    jy, _ = jfn(jp, jnp.asarray(x), None)
    ty, st = ssm.apply_mamba_heads(tp, torch.from_numpy(x), s.ssm, q, None,
                                   compute_dtype=torch.float32, **kw)
    assert st is None
    close(ty, jy)
    zero = np.zeros((B, H, Dh, N), np.float32)
    jst, tst = {"S": jnp.asarray(zero)}, {"S": torch.from_numpy(zero.copy())}
    ptr = tst["S"].data_ptr()
    outs, pos = [], 0
    for T in (5, 1, 8, 1):
        xs = x[:, pos:pos + T]
        pos += T
        jy, jst = jfn(jp, jnp.asarray(xs), jst)
        ty, got = ssm.apply_mamba_heads(tp, torch.from_numpy(xs), s.ssm, q, tst,
                                        compute_dtype=torch.float32, **kw)
        assert got is tst and tst["S"].data_ptr() == ptr  # updated in place
        close(ty, jy)
        np.testing.assert_allclose(tst["S"].numpy(), np.asarray(jst["S"]), atol=TOL)
        outs.append(ty)
    whole = {"S": torch.zeros((B, H, Dh, N))}
    ty, _ = ssm.apply_mamba_heads(tp, torch.from_numpy(x[:, :15]), s.ssm, q, whole,
                                  compute_dtype=torch.float32, **kw)
    steps = torch.cat(outs, 1)
    torch.testing.assert_close(steps, ty, rtol=0, atol=1e-4 * float(ty.abs().max()))
    torch.testing.assert_close(whole["S"], tst["S"], rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """Reduced hymba-1.5b from the JAX initializer (scales pinned), float and
    deployed, as numpy."""
    jarch = jreduced(jget_arch(NAME))
    fl = _pin_scales(jax.jit(lambda k: unbox(jinit_lm(k, jarch)))(jax.random.PRNGKey(0)))
    dep = jax.jit(lambda p: jdeploy_params(p, jarch.quant))(fl)
    return jarch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


def _arch():
    return reduced(get_arch(NAME))


_LM = {"float": ("float", {}), "int_chain": ("deployed", dict(int_chain=True))}


@pytest.mark.parametrize("path", list(_LM))
def test_lm_logits_match_jax(model, path):
    """Cacheless logits (T=24: the chunked SSD form, flash attention over the
    window), then over a contiguous cache a 6-token (sequential), an 8-token
    (chunked) and a decode step: logits and every cache leaf (the ring,
    ``mamba.S``) against JAX's ``init_cache`` leaves."""
    jarch, fl, dep = model
    arch = _arch()
    which, kw = _LM[path]
    p = fl if which == "float" else dep
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_numpy(p)
    jrt, rt = JRuntime(**kw), Runtime(**kw)
    toks = np.random.default_rng(5).integers(0, arch.vocab, (2, 24)).astype(np.int32)

    def close(tl, jl):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())

    jl = jax.jit(lambda p, t: japply_lm(p, jarch, tokens=t, rt=jrt)[0])(jp,
                                                                       jnp.asarray(toks))
    tl, _ = apply_lm(tp, arch, tokens=torch.from_numpy(toks), rt=rt)
    close(tl, jl)
    jcache = jinit_cache(jarch, 2, 32, dtype=jnp.float32)
    cache = init_cache(arch, 2, 32, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, t, c, sp: japply_lm(p, jarch, tokens=t, cache=c, start_pos=sp,
                                                 rt=jrt)[:2])
    for lo, hi in ((0, 6), (6, 14), (14, 15)):
        jl, jcache = step(jp, jnp.asarray(toks[:, lo:hi]), jcache, jnp.int32(lo))
        tl, _ = apply_lm(tp, arch, tokens=torch.from_numpy(toks[:, lo:hi]), cache=cache,
                         start_pos=lo, rt=rt)
        close(tl, jl)
    for (path_, want), got in zip(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jcache))[0],
            jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), cache))):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=str(path_))
    if rt.int_chain:  # every hymba linear is a chain break
        rep = rt.chain_report
        assert (len(rep["folded"]), len(rep["chained"]), len(rep["standalone"])) == (23, 0, 0)


def test_penalty_and_deploy_reach_the_mamba_heads(model):
    """``a2q_penalty_of`` equals the reference's accumulated penalty (the
    mamba linears included, with their caps pushed past the norm so every
    term counts); the deploy turns the four mamba linears into ``q8``/``s8``
    and keeps ``A_log``, ``D`` and ``dt_bias`` as fp32 leaves."""
    jarch, fl, _ = model
    arch = _arch()
    grown = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 3.0 if path[-1].key == "t" else v, fl)
    _, _, jpen = jax.jit(lambda p: japply_lm(p, jarch, tokens=jnp.zeros((1, 8), jnp.int32)))(
        jax.tree.map(jnp.asarray, grown))
    tp = from_jax_numpy(grown)
    pen = a2q_penalty_of(tp, arch)
    assert float(jpen) > 0
    np.testing.assert_allclose(float(pen), float(jpen), rtol=1e-5)
    mamba_only = {"stacks": {"0": {"mamba": tp["stacks"]["0"]["mamba"]}}}
    assert float(a2q_penalty_of(mamba_only, dataclasses.replace(arch))) > 0
    dep = deploy_params(from_jax_numpy(fl), arch.quant)["stacks"]["0"]["mamba"]
    for name in ("in_proj", "bc_proj", "dt_proj", "out_proj"):
        assert dep[name]["q8"].dtype == torch.int8 and dep[name]["q8"].shape[0] == 2
    for name in ("A_log", "D", "dt_bias"):
        assert dep[name].dtype == torch.float32


def test_cacheless_forward_needs_whole_chunks(model):
    _, fl, _ = model
    with pytest.raises(ValueError, match="chunked form"):
        apply_lm(from_jax_numpy(fl), _arch(), tokens=torch.zeros((1, 12), dtype=torch.int32))


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


_RUNS = {"chunk8-per-tick": (8, 1), "chunk4-megastep": (4, 4)}


@pytest.fixture(scope="module")
def jax_engine(model):
    """The JAX paged engine's requests on the float params: prefill chunks of
    8 per tick and of 4 on the megastep (``decode_steps=4``)."""
    jarch, fl, _ = model
    out = {}
    for key, (chunk, steps) in _RUNS.items():
        e = JPagedServeEngine(jarch, jax.tree.map(jnp.asarray, fl), prefill_chunk=chunk,
                              decode_steps=steps, **ENGINE)
        e.generate(_prompts(jarch.vocab), max_new=MAX_NEW)
        out[key] = e.last_requests
    return out


@pytest.mark.parametrize("run", list(_RUNS))
def test_paged_engine_matches_jax_engine(model, jax_engine, run):
    """Four requests over two slots (both reused, ``mamba.S`` emptied at each
    admission), prompts past the window: tokens under ``parity_up_to_ties``
    and margins against the reference's engine at the same chunk and
    ``decode_steps``; the rings and ``mamba.S`` written in place; every
    block freed."""
    _, fl, _ = model
    chunk, steps = _RUNS[run]
    e = PagedServeEngine(_arch(), from_jax_numpy(fl), prefill_chunk=chunk, decode_steps=steps,
                         device="cpu", **ENGINE)
    leaves = e.cache.pools["0"]
    ptrs = [leaves["mamba"]["S"].data_ptr(), leaves["attn"]["k"].data_ptr()]
    outs = e.generate(_prompts(e.arch.vocab), max_new=MAX_NEW)
    ref = jax_engine[run]
    ok, ties, detail = parity_up_to_ties(ref, outs, TOL)
    assert ok, detail
    assert ties == 0 and outs == [r.generated for r in ref]
    for r, q in zip(ref, e.last_requests):
        np.testing.assert_allclose(q.margins, r.margins, rtol=0, atol=TOL)
    assert [leaves["mamba"]["S"].data_ptr(), leaves["attn"]["k"].data_ptr()] == ptrs
    assert e.cache.free_blocks == e.cache.num_blocks - 1


@pytest.mark.parametrize("chunk", [8, 4])
def test_megastep_matches_per_tick_bit_for_bit(model, chunk):
    """The port's megastep (``decode_steps=4``: dead rows' ``mamba.S``
    advances and is emptied at the slot's next admission) against its
    per-tick engine on the same prompts: tokens and margins bit for bit."""
    _, fl, _ = model
    runs = []
    for steps in (1, 4):
        e = PagedServeEngine(_arch(), from_jax_numpy(fl), prefill_chunk=chunk,
                             decode_steps=steps, device="cpu", **ENGINE)
        outs = e.generate(_prompts(e.arch.vocab, seed=4), max_new=MAX_NEW)
        runs.append((outs, [r.margins for r in e.last_requests]))
    assert runs[0] == runs[1]


def test_contiguous_engine_serves_lockstep_groups(model):
    """The contiguous ``ServeEngine`` serves hymba in lockstep groups (the
    cache rebuilt per group, the ring and ``mamba.S`` fed a token a forward)
    and gives the paged engine's tokens on equal-length prompts, continuous
    and in lockstep groups."""
    _, fl, _ = model
    arch, params = _arch(), from_jax_numpy(fl)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, arch.vocab, (19,)).astype(np.int32) for _ in range(2)]
    contig = ServeEngine(arch, params, batch=2, max_seq=32, device="cpu")
    assert contig.recurrent
    outs = contig.generate(prompts, max_new=5)
    assert contig.cache["0"]["mamba"]["S"].shape == (2, 2, 4, 16, 4)
    paged = PagedServeEngine(arch, params, batch=2, max_seq=32, block_size=4, prefill_chunk=8,
                             device="cpu")
    ok, ties, detail = parity_up_to_ties(contig.last_requests,
                                         paged.generate(prompts, max_new=5), TOL)
    assert ok and ties == 0, detail
    with pytest.raises(ValueError, match="equal-length"):
        contig.generate([prompts[0], prompts[1][:10]], max_new=2)
    # ``tests/test_paged.py``'s lockstep fallback takes hymba: the paged
    # engine's lockstep groups against the contiguous oracle
    lock = PagedServeEngine(arch, params, batch=2, max_seq=32, block_size=4, prefill_chunk=4,
                            lockstep=True, device="cpu")
    assert lock.generate(prompts, max_new=5) == outs


def test_paged_cache_mamba_leaf():
    """hymba keeps its window's ring and an fp32 ``mamba.S (count, slots, H,
    Dh, N)`` per slot: no KV bytes a token; the bytes a slot are the ring's
    and the state's; ``slice_slot`` gives one-row views and ``reset_slot``
    zeroes one slot's state (and its ring, ``kpos`` to -1)."""
    arch = _arch()
    s = arch.stacks[0]
    H, Dh, N, n = arch.d_model // s.ssm.head_dim, s.ssm.head_dim, s.ssm.state_dim, s.count
    cache = PagedKVCache(arch, 3, block_size=4, max_seq=64, dtype=torch.float32,
                         device="cpu")
    leaves = cache.pools["0"]
    S = leaves["mamba"]["S"]
    assert S.shape == (n, 3, H, Dh, N) and S.dtype == torch.float32
    assert set(leaves["attn"]) == {"k", "v", "kpos"}
    assert cache.kv_bytes_per_token() == 0 and not cache.fully_paged
    ring = s.attn.window * (2 * s.attn.kv_heads * s.attn.head_dim * 4 + 4)
    assert cache.state_bytes_per_slot() == n * (ring + H * Dh * N * 4)
    S.fill_(1.0)
    leaves["attn"]["kpos"].fill_(5)
    cache.slice_slot(1)["0"]["mamba"]["S"].fill_(7.0)
    assert S[:, 1].eq(7.0).all() and S[:, 0].eq(1.0).all()
    cache.reset_slot(1)
    assert S[:, 1].eq(0).all() and S[:, 0].eq(1).all() and S[:, 2].eq(1).all()
    assert leaves["attn"]["kpos"][:, 1].eq(-1).all() and leaves["attn"]["kpos"][:, 2].eq(5).all()


def test_launcher_serves_hymba(capsys):
    """``--arch hymba-1.5b --paged --int-chain --decode-kernel --decode-steps
    4`` serves the reduced model (the headroom probe's forward rounded up to
    whole SSD chunks), then ``--parity-check --deploy-int8`` holds the paged
    engine to the contiguous one past the window."""
    from repro_torch.launch import serve as launch_serve

    base = ["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "3", "--prompt-len",
            "19", "--max-new", "4", "--batch", "2", "--max-seq", "32", "--block-size", "4",
            "--prefill-chunk", "8"]
    outs = launch_serve.main(base + ["--paged", "--int-chain", "--decode-kernel",
                                     "--decode-steps", "4"])
    assert [len(o) for o in outs] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "23 folded, 0 chained, 0 standalone act-quant" in text
    assert "0 violations" in text and "0 KV bytes/token" in text
    launch_serve.main(base + ["--paged", "--parity-check", "--deploy-int8"])
    assert "parity OK: 3 requests token-identical across engines" in capsys.readouterr().out
