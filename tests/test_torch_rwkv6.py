"""rwkv6 (RWKV-6 / Finch) in the port against the JAX package.

Covered:

* ``ops.rwkv6_scan`` on the CPU (its plain version) against JAX's
  ``ref_rwkv6`` per head, at ragged T, with a carried state and with the
  state written in place; the decay floor against JAX's ``rwkv6_chunked``
  where some decays lie below ``e^-8`` (there the floored scan follows the
  chunked form and the unfloored one does not); the argument checks;
* the three ported forms (``rwkv6_sequential``, ``rwkv6_chunked``,
  ``rwkv6_decode_step``) against ``repro.nn.ssm``'s, and their dtypes;
* the time-mix and channel-mix sublayers, float and deployed, under
  ``int_forward`` and ``int_chain``, cacheless and over a carried state
  (decode, sequential and chunked steps), outputs and updated states;
* reduced rwkv6-7b: cacheless and cached (prefill in two chunks, then
  decode) logits against JAX ``apply_lm``, float and deployed int-chain;
  the chain report (15 folded, 2 chained, 0 standalone a forward);
* the paged engine (deployed, ``int_chain``) against the JAX engine on
  unequal prompts through fewer slots than requests, under
  ``parity_up_to_ties``; a reused slot gives the tokens a fresh engine
  gives; chained and unchained runs give identical tokens and margins;
  the cache's recurrent leaves (bytes, ``reset_slot``, ``slice_slot``).

Tolerances (fp32 throughout: the reduced configs compute in fp32): the scan
and the forms agree to 1e-4 (fp32 sums of up to 64 steps in another order,
the chunked form through exp/log); sublayer outputs rtol 1e-5 of their
scale; logits rtol 1e-4 of their scale (as ``test_torch_model.py``); engine
tokens under ``parity_up_to_ties`` at 1e-4 and margins to 1e-4.  Integer
paths are compared with every activation scale pinned to a power of two
(``jnp.exp2`` and ``torch.exp2`` agree there).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.kernels import ref as jref
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
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime, apply_lm
from repro_torch.nn import ssm
from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties
from repro_torch.serve.paged_cache import PagedKVCache

torch.set_num_threads(1)

TOL = 1e-4
ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)
MAX_NEW = 5


def _scan_inputs(rng, B, H, T, Dk, Dv, w_lo=0.5):
    return (rng.normal(size=(B, H, T, Dk)).astype(np.float32),
            rng.normal(size=(B, H, T, Dk)).astype(np.float32),
            rng.normal(size=(B, H, T, Dv)).astype(np.float32),
            rng.uniform(w_lo, 0.999, size=(B, H, T, Dk)).astype(np.float32),
            rng.normal(size=(H, Dk)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# The scan op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [50, 64, 33, 1])
@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "carried_state"])
def test_rwkv6_scan_plain_matches_jax_ref(T, carried):
    rng = np.random.default_rng(T + carried)
    B, H, Dk, Dv = 2, 3, 16, 12
    r, k, v, w, u = _scan_inputs(rng, B, H, T, Dk, Dv)
    s0 = rng.normal(size=(B, H, Dk, Dv)).astype(np.float32) if carried else None
    y, sT = ops.rwkv6_scan(*_t(r, k, v, w, u), None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, H, T, Dv) and y.dtype == torch.float32 and sT.shape == (B, H, Dk, Dv)
    for h in range(H):
        y_r, s_r = jref.ref_rwkv6(jnp.asarray(r[:, h]), jnp.asarray(k[:, h]), jnp.asarray(v[:, h]),
                                  jnp.asarray(w[:, h]), jnp.asarray(u[h]),
                                  None if s0 is None else jnp.asarray(s0[:, h]))
        np.testing.assert_allclose(y[:, h].numpy(), np.asarray(y_r), atol=TOL)
        np.testing.assert_allclose(sT[:, h].numpy(), np.asarray(s_r), atol=TOL)


def test_rwkv6_scan_carries_state_in_place():
    """Two halves, the state carried through ``state_out`` written over the
    initial state, equal one pass; y in the dtype asked for."""
    rng = np.random.default_rng(9)
    r, k, v, w, u = _t(*_scan_inputs(rng, 1, 2, 32, 8, 8))
    y_full, s_full = ops.rwkv6_scan(r, k, v, w, u)
    state = torch.zeros((1, 2, 8, 8))
    halves = []
    for sl in (slice(0, 16), slice(16, 32)):
        y, s = ops.rwkv6_scan(r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl], u, state,
                              state_out=state, out_dtype=torch.bfloat16)
        assert s is state and y.dtype == torch.bfloat16
        halves.append(y.float())
    np.testing.assert_allclose(torch.cat(halves, 2).numpy(), y_full.numpy(), atol=2**-7 * 8)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), atol=TOL)


def test_rwkv6_scan_floor_follows_the_chunked_form():
    """Decays below ``e^-8``: the chunked form clamps the log-decay there, so
    the scan with ``min_w = e^-8`` follows it and the unfloored scan (the
    sequential form) does not."""
    rng = np.random.default_rng(4)
    B, H, T, D = 2, 2, 16, 8
    r, k, v, w, u = _scan_inputs(rng, B, H, T, D, D, w_lo=0.3)
    w[:, :, ::3, ::2] = rng.uniform(1e-6, 1e-4, w[:, :, ::3, ::2].shape)
    s0 = rng.normal(size=(B, H, D, D)).astype(np.float32)
    jy, js = jssm.rwkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)), chunk=8)
    y, s = ops.rwkv6_scan(*_t(r, k, v, w, u, s0), min_w=math.exp(-8.0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL)
    y_raw, _ = ops.rwkv6_scan(*_t(r, k, v, w, u, s0))
    assert np.abs(y_raw.numpy() - np.asarray(jy)).max() > 10 * TOL


def test_rwkv6_scan_argument_checks():
    r = torch.zeros((1, 2, 3, 4))
    with pytest.raises(ValueError):  # u is (H, Dk)
        ops.rwkv6_scan(r, r, r, r, torch.zeros((4,)))
    with pytest.raises(ValueError):  # k does not fit r
        ops.rwkv6_scan(r, torch.zeros((1, 2, 3, 5)), r, r, torch.zeros((2, 4)))


# ---------------------------------------------------------------------------
# The three forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["sequential", "chunked", "decode"])
def test_forms_match_jax(form):
    rng = np.random.default_rng(12)
    B, H, T, D = 2, 3, 32, 8
    r, k, v, w, u = _scan_inputs(rng, B, H, T, D, D, w_lo=0.2)
    if form == "chunked":  # decays below e^-8, where the clamp acts
        w[:, :, ::5] = 1e-5
    s0 = rng.normal(size=(B, H, D, D)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    targs = list(_t(r, k, v, w, u, s0))
    if form == "decode":
        jargs[:4] = [a[:, :, 0] for a in jargs[:4]]
        targs[:4] = [a[:, :, 0] for a in targs[:4]]
    jfn = {"sequential": jssm.rwkv6_sequential, "decode": jssm.rwkv6_decode_step,
           "chunked": lambda *a: jssm.rwkv6_chunked(*a, chunk=8)}[form]
    tfn = {"sequential": ssm.rwkv6_sequential, "decode": ssm.rwkv6_decode_step,
           "chunked": lambda *a: ssm.rwkv6_chunked(*a, chunk=8)}[form]
    jy, js = jfn(*jargs)
    y, s = tfn(*targs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=TOL)


def test_form_dtypes():
    """The sequential and chunked forms return y in r's dtype, the decode
    step in fp32 (the groupnorm reads either), as the reference's do."""
    rng = np.random.default_rng(2)
    r, k, v, w, u = _t(*_scan_inputs(rng, 1, 2, 8, 4, 4))
    rb, kb, vb = (a.to(torch.bfloat16) for a in (r, k, v))
    s0 = torch.zeros((1, 2, 4, 4))
    assert ssm.rwkv6_sequential(rb, kb, vb, w, u, s0)[0].dtype == torch.bfloat16
    assert ssm.rwkv6_chunked(rb, kb, vb, w, u, s0, chunk=4)[0].dtype == torch.bfloat16
    y, s = ssm.rwkv6_decode_step(rb[:, :, 0], kb[:, :, 0], vb[:, :, 0], w[:, :, 0], u, s0)
    assert y.dtype == s.dtype == torch.float32


# ---------------------------------------------------------------------------
# Sublayers
# ---------------------------------------------------------------------------


def _pin_scales(tree):
    """Every activation scale pinned to the power of two below it."""
    if isinstance(tree, dict):
        return {k: (jnp.floor(v) if k == "log2_scale" else _pin_scales(v))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def blocks():
    """One reduced rwkv6 block's time-mix and channel-mix params from the JAX
    initializer, float (scales pinned) and deployed, as numpy."""
    arch = jreduced(jget_arch("rwkv6-7b"))
    s, q = arch.stacks[0], arch.quant
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    fl = _pin_scales({"tm": unbox(jssm.init_rwkv6_timemix(k1, arch.d_model, s.ssm, q)),
                      "cm": unbox(jssm.init_rwkv6_channelmix(k2, arch.d_model, s.d_ff, q))})
    # a decay spread over (0, 1) and a bonus that matters, as after training
    fl["tm"]["w0"] = jnp.linspace(-3.0, 1.0, arch.d_model)
    fl["tm"]["u"] = fl["tm"]["u"] * 25
    dep = jdeploy_params(fl, q)
    return arch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


_PATHS = {"float": ("float", {}), "int_forward": ("deployed", dict(int_forward=True)),
          "int_chain": ("deployed", dict(int_forward=True, int_chain=True))}


@pytest.mark.parametrize("path", list(_PATHS))
@pytest.mark.parametrize("steps", [(16,), (5, 1, 8, 1)], ids=["cacheless", "cached"])
def test_sublayers_match_jax(blocks, path, steps):
    """The time-mix then the channel-mix on its output, step by step: a
    cacheless T=16 forward (the chunked form), or over a carried state a
    5-token (sequential), a 1-token (decode), an 8-token (chunked) and a
    1-token step; outputs and the updated state leaves against JAX's."""
    arch, fl, dep = blocks
    s, q = arch.stacks[0], arch.quant
    which, kw = _PATHS[path]
    p = fl if which == "float" else dep
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_numpy(p)
    B, d = 2, arch.d_model
    H = d // s.ssm.head_dim
    x = np.random.default_rng(8).normal(size=(B, sum(steps), d)).astype(np.float32)
    cached = len(steps) > 1
    jst = tst = None
    if cached:
        zero = {"tm": {"S": np.zeros((B, H, 16, 16), np.float32),
                       "shift": np.zeros((B, 1, d), np.float32)},
                "cm": {"shift": np.zeros((B, 1, d), np.float32)}}
        jst, tst = jax.tree.map(jnp.asarray, zero), from_jax_numpy(zero)
    pos = 0
    for T in steps:
        xs = x[:, pos:pos + T]
        pos += T
        jy, jtm = jssm.apply_rwkv6_timemix(jp["tm"], jnp.asarray(xs), s.ssm, q,
                                           jst["tm"] if cached else None,
                                           compute_dtype=jnp.float32, **kw)
        jo, jcm = jssm.apply_rwkv6_channelmix(jp["cm"], jy, q, jst["cm"] if cached else None,
                                              compute_dtype=jnp.float32, **kw)
        ty, ttm = ssm.apply_rwkv6_timemix(tp["tm"], torch.from_numpy(xs), s.ssm, q,
                                          tst["tm"] if cached else None,
                                          compute_dtype=torch.float32, **kw)
        to, tcm = ssm.apply_rwkv6_channelmix(tp["cm"], ty, q, tst["cm"] if cached else None,
                                             compute_dtype=torch.float32, **kw)
        for t_out, j_out in ((ty, jy), (to, jo)):
            j_out = np.asarray(j_out)
            np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-5,
                                       atol=1e-5 * np.abs(j_out).max())
        if cached:
            jst = {"tm": jtm, "cm": jcm}
            assert ttm is tst["tm"] and tcm is tst["cm"]  # updated in place
            for key, j_leaf in (("S", jtm["S"]), ("shift", jtm["shift"])):
                np.testing.assert_allclose(tst["tm"][key].numpy(), np.asarray(j_leaf), atol=TOL)
            np.testing.assert_allclose(tst["cm"]["shift"].numpy(), np.asarray(jcm["shift"]),
                                       atol=TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """Reduced rwkv6-7b from the JAX initializer (scales pinned), float and
    deployed, as numpy."""
    jarch = jreduced(jget_arch("rwkv6-7b"))
    fl = _pin_scales(unbox(jinit_lm(jax.random.PRNGKey(0), jarch)))
    dep = jax.jit(lambda p: jdeploy_params(p, jarch.quant))(fl)
    return jarch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


_LM = {"float": ("float", {}), "int_chain": ("deployed", dict(int_chain=True))}


@pytest.mark.parametrize("path", list(_LM))
def test_lm_logits_match_jax(model, path):
    """Cacheless logits (T=16, the chunked form), then over a cache a 6-token
    and an 8-token prefill chunk (sequential, chunked) and a decode step:
    logits and the recurrent leaves against JAX's ``init_cache`` leaves."""
    jarch, fl, dep = model
    arch = reduced(get_arch("rwkv6-7b"))
    which, kw = _LM[path]
    p = fl if which == "float" else dep
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_numpy(p)
    jrt, rt = JRuntime(**kw), Runtime(**kw)
    toks = np.random.default_rng(5).integers(0, arch.vocab, (2, 16)).astype(np.int32)

    def close(tl, jl):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())

    jl = jax.jit(lambda p, t: japply_lm(p, jarch, tokens=t, rt=jrt)[0])(jp, jnp.asarray(toks))
    tl, _ = apply_lm(tp, arch, tokens=torch.from_numpy(toks), rt=rt)
    close(tl, jl)
    jcache = jinit_cache(jarch, 2, 32, dtype=jnp.float32)
    cache = PagedKVCache(arch, 2, block_size=4, max_seq=32, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, t, c, sp: japply_lm(p, jarch, tokens=t, cache=c, start_pos=sp,
                                                 rt=jrt)[:2])
    for lo, hi in ((0, 6), (6, 14), (14, 15)):
        jl, jcache = step(jp, jnp.asarray(toks[:, lo:hi]), jcache, jnp.int32(lo))
        tl, _ = apply_lm(tp, arch, tokens=torch.from_numpy(toks[:, lo:hi]), start_pos=lo, rt=rt,
                         cache={**cache.pools, "_paged": {"bt": cache.bt()}})
        close(tl, jl)
    for key in ("S", "shift"):
        np.testing.assert_allclose(cache.pools["0"]["tm"][key].numpy(),
                                   np.asarray(jcache["0"]["tm"][key]), atol=TOL)
    if rt.int_chain:
        rep = rt.chain_report
        assert (len(rep["folded"]), len(rep["chained"]), len(rep["standalone"])) == (15, 2, 0)
        assert rep["chained"] == ["cm.wk"] * 2 and rep["fallback"] == []
        assert rep["folded"] == (["tm.wr", "tm.wk", "tm.wv", "tm.wg", "tm.wo", "cm.wk", "cm.wv"]
                                 * 2 + ["head"])


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (5, 3, 7)]


@pytest.fixture(scope="module")
def jax_engine(model):
    """The JAX engine's driven requests (deployed, ``int_chain``): three
    unequal prompts through two slots."""
    jarch, _, dep = model
    e = JPagedServeEngine(jarch, jax.tree.map(jnp.asarray, dep), rt=JRuntime(int_chain=True),
                          **ENGINE)
    e.generate(_prompts(jarch.vocab), max_new=MAX_NEW)
    return e.last_requests


def _engine(dep, **rt):
    return PagedServeEngine(reduced(get_arch("rwkv6-7b")), from_jax_numpy(dep), device="cpu",
                            rt=Runtime(**rt), **ENGINE)


def test_paged_engine_matches_jax_engine(model, jax_engine):
    _, _, dep = model
    e = _engine(dep, int_chain=True)
    prompts = _prompts(e.arch.vocab)
    outs = e.generate(prompts, max_new=MAX_NEW)
    ok, ties, detail = parity_up_to_ties(jax_engine, outs, TOL)
    assert ok, detail
    assert ties == 0
    for r, req in zip(jax_engine, e.last_requests):
        assert len(req.generated) == MAX_NEW
        np.testing.assert_allclose(req.margins, r.margins, rtol=0, atol=TOL)
    # the third request ran on a slot a finished request left: a fresh engine
    # gives it the same tokens and margins
    fresh = _engine(dep, int_chain=True)
    assert fresh.generate(prompts[2:], max_new=MAX_NEW) == outs[2:]
    assert fresh.last_requests[0].margins == e.last_requests[2].margins
    tp = e.throughput()
    assert (tp["int_chain_folded"], tp["int_chain_chained"],
            tp["int_chain_requant_dispatches"]) == (15, 2, 0)


def test_int_chain_is_a_pure_dispatch_fusion(model):
    """Chained and unchained int-forward engines serve identical tokens and
    margins; only the unchained one pays standalone act-quants, and only the
    chained one hands codes from cm.wk to cm.wv."""
    _, _, dep = model
    runs = {}
    for chain in (True, False):
        e = _engine(dep, int_forward=True, int_chain=chain)
        runs[chain] = (e.generate(_prompts(e.arch.vocab), max_new=MAX_NEW), e)
    (outs_c, ec), (outs_u, eu) = runs[True], runs[False]
    assert outs_c == outs_u
    assert [r.margins for r in ec.last_requests] == [r.margins for r in eu.last_requests]
    tc, tu = ec.throughput(), eu.throughput()
    assert (tc["int_chain_requant_dispatches"], tc["int_chain_chained"]) == (0, 2)
    assert (tu["int_chain_requant_dispatches"], tu["int_chain_chained"]) == (15, 0)


def test_paged_cache_recurrent_leaves():
    arch = reduced(get_arch("rwkv6-7b"))
    cache = PagedKVCache(arch, 3, block_size=4, max_seq=16, dtype=torch.float32, device="cpu")
    leaves = cache.pools["0"]
    H, Dk, d, n = 4, arch.stacks[0].ssm.head_dim, arch.d_model, arch.stacks[0].count
    assert leaves["tm"]["S"].shape == (n, 3, H, Dk, Dk)
    assert leaves["tm"]["shift"].shape == leaves["cm"]["shift"].shape == (n, 3, 1, d)
    assert cache.kv_bytes_per_token() == 0
    assert cache.state_bytes_per_slot() == n * (H * Dk * Dk + 2 * d) * 4
    for leaf in (leaves["tm"]["S"], leaves["tm"]["shift"], leaves["cm"]["shift"]):
        leaf.fill_(1.0)
    view = cache.slice_slot(1)
    view["0"]["tm"]["S"][1].fill_(7.0)  # a one-row view writes the slot's row
    assert leaves["tm"]["S"][1, 1].eq(7.0).all() and leaves["tm"]["S"][1, 0].eq(1.0).all()
    cache.reset_slot(1)
    for leaf in (leaves["tm"]["S"], leaves["tm"]["shift"], leaves["cm"]["shift"]):
        assert leaf[:, 1].eq(0).all() and leaf[:, 0].eq(1).all() and leaf[:, 2].eq(1).all()


def test_launcher_serves_rwkv6_on_int_chain(capsys):
    """``--arch rwkv6-7b --paged --int-chain`` serves the reduced model and
    reports the chain (chained cm.wk) and the recurrent state a slot."""
    from repro_torch.launch import serve as launch_serve

    outs = launch_serve.main(["--arch", "rwkv6-7b", "--reduced", "--paged", "--int-chain",
                              "--device", "cpu", "--requests", "3", "--prompt-len", "6",
                              "--max-new", "3", "--batch", "2", "--max-seq", "16",
                              "--block-size", "4", "--prefill-chunk", "4"])
    assert [len(o) for o in outs] == [3, 3, 3]
    text = capsys.readouterr().out
    assert "15 folded, 2 chained, 0 standalone act-quant" in text
    arch = reduced(get_arch("rwkv6-7b"))
    state = PagedKVCache(arch, 1, max_seq=16, dtype=torch.float32,
                         device="cpu").state_bytes_per_slot()
    assert f"0 KV bytes/token; {state} recurrent state bytes a slot" in text
