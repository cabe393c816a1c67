"""The contiguous path of the port against the JAX package: ``init_cache``,
``_write_cache``, the contiguous GQA and MLA branches of ``apply_attention``,
the contiguous ``ServeEngine``, lockstep admission in ``PagedServeEngine``
and the launcher's ``--parity-check`` / ``--eos-auto`` / contiguous runs.

Reduced configs (fp32 compute), params from the JAX init loaded with
``from_jax_numpy``.  Tolerances: the two packages compute the same fp32
arithmetic in another order, and their logits agree to ~1e-6
(``test_torch_model.py``): logits are held to 1e-5, layer outputs to the
reference's own 1e-4 (its decode-vs-parallel gate), greedy token streams
exactly, and the engines' per-step greedy margins to 1e-4.  Integer cache
writes (``kpos``) and the written K/V are held exactly.  The JAX engine runs
share one module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.attention as jattn
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.base import AttnConfig as JAttnConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import AttnConfig, QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import Runtime, apply_lm, init_cache
from repro_torch.models.steps import build_serve_step
from repro_torch.nn import attention as attn
from repro_torch.serve.engine import PagedServeEngine, ServeEngine, parity_up_to_ties

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
EPS = 1e-4
DECODE_ARCHS = ("smollm-135m", "yi-6b", "command-r-35b", "h2o-danube-1.8b", "rwkv6-7b",
                "deepseek-v3-671b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_JPARAMS = {}


def _jparams(name, deployed=False):
    key = (name, deployed)
    if key not in _JPARAMS:
        arch = jreduced(jget_arch(name))
        p = unbox(jinit_lm(KEY, arch))
        _JPARAMS[key] = jdeploy_params(p, arch.quant) if deployed else p
    return _JPARAMS[key]


def _arch(name):
    return reduced(get_arch(name))


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _same_requests(ref_reqs, reqs, atol=EPS):
    """Greedy tokens exact, per-step margins to ``atol``."""
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    for r, q in zip(ref_reqs, reqs):
        np.testing.assert_allclose(q.margins, r.margins, rtol=0, atol=atol)


# -- the JAX engine runs, once per module -------------------------------------

SERVE_CASES = {
    # 5 requests over 2 slots, mixed lengths: slots recycled, free rows ride
    "yi-6b": dict(deployed=False, rt={}, lens=(5, 3, 9, 2, 6)),
    # the deployed int path (fused W8A8 kernel's plain version) on the contiguous cache
    "smollm-135m int": dict(deployed=True, rt=dict(int_forward=True), lens=(4, 7, 3)),
}
LOCKSTEP_LENS = (6, 6)  # one equal-length group (the reference's lockstep contract)
WAVE_SEED = 44


def _wave_prompts(vocab):
    """``tests/test_paged.py``'s bursty wave: seven short prompts and two 24-token
    ones interleaved mid-wave."""
    rng = np.random.default_rng(WAVE_SEED)
    short = [rng.integers(0, vocab, (rng.integers(3, 7),)).astype(np.int32) for _ in range(7)]
    long = [rng.integers(0, vocab, (24,)).astype(np.int32) for _ in range(2)]
    return short[:3] + long[:1] + short[3:6] + long[1:] + short[6:]


WAVE_KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4, num_blocks=20)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for case, c in SERVE_CASES.items():
        name = case.split()[0]
        arch = jreduced(jget_arch(name))
        e = JServeEngine(arch, _jparams(name, c["deployed"]), batch=2, max_seq=32,
                         rt=JRuntime(**c["rt"]))
        e.generate(_prompts(arch.vocab, 1, c["lens"]), max_new=5)
        out[case] = e.last_requests
    arch = jreduced(jget_arch("rwkv6-7b"))
    e = JServeEngine(arch, _jparams("rwkv6-7b"), batch=2, max_seq=32)
    e.generate(_prompts(arch.vocab, 2, LOCKSTEP_LENS), max_new=4)
    out["rwkv6 lockstep"] = e.last_requests
    arch = jreduced(jget_arch("yi-6b"))
    e = JPagedServeEngine(arch, _jparams("yi-6b"), batch=2, max_seq=64, block_size=4,
                          prefill_chunk=4, lockstep=True)
    e.generate(_prompts(arch.vocab, 3, (6, 6, 6, 4)), max_new=3)
    out["yi-6b paged lockstep"] = e.last_requests
    e = JPagedServeEngine(arch, _jparams("yi-6b"), **WAVE_KW)  # per tick (decode_steps=1)
    e.generate(_wave_prompts(arch.vocab), max_new=5)
    out["wave"] = e.last_requests
    return out


# -- init_cache and one decode step against the reference ---------------------


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_reduced_decode_step(name):
    """``tests/test_arch_smoke.py``'s decode step on ``init_cache``, then two
    more steps at per-row positions: the port's logits and written cache
    leaves against the reference's."""
    jarch, arch = jreduced(jget_arch(name)), _arch(name)
    pj = _jparams(name)
    jcache = jinit_cache(jarch, 2, 32, dtype=jnp.float32)
    cache = init_cache(arch, 2, 32, dtype=torch.float32, device="cpu")
    assert jax.tree.structure(jcache) == jax.tree.structure(_np_torch(cache))
    params = from_jax_numpy(_np(pj))
    step = build_serve_step(arch)
    feeds = [(np.zeros((2, 1), np.int32), np.zeros((2,), np.int32)),
             (np.array([[3], [7]], np.int32), np.array([1, 1], np.int32)),
             (np.array([[11], [5]], np.int32), np.array([2, 5], np.int32))]
    before = jax.tree.map(np.array, _np(jcache))
    jstep = jax.jit(lambda p, t, c, s: japply_lm(p, jarch, tokens=t, cache=c, start_pos=s))
    for tok, pos in feeds:
        jl, jcache, _ = jstep(pj, jnp.asarray(tok), jcache, jnp.asarray(pos))
        logits, cache = step(params, torch.from_numpy(tok), cache, torch.from_numpy(pos))
        assert logits.shape == (2, 1, arch.vocab) and torch.isfinite(logits).all()
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for (path, want), got, old in zip(jax.tree_util.tree_flatten_with_path(_np(jcache))[0],
                                      jax.tree.leaves(_np_torch(cache)),
                                      jax.tree.leaves(before)):
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(path))
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(before),
                                                        jax.tree.leaves(_np(jcache)))
               if a.dtype != np.int32)


def _np_torch(tree):
    return {k: _np_torch(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


def test_hymba_cache_is_refused_naming_the_roadmap():
    """hymba's contiguous cache is ported now: its leaves (the window's ring
    and the fp32 ``mamba.S``) have the shapes and dtypes of the reference's
    ``init_cache``.  A block kind still not ported (``conv``) is refused,
    naming ROADMAP.md."""
    arch = _arch("hymba-1.5b")
    want = jinit_cache(jreduced(jget_arch("hymba-1.5b")), 1, 16, dtype=jnp.float32)
    got = init_cache(arch, 1, 16, dtype=torch.float32, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    conv = dataclasses.replace(arch, stacks=(dataclasses.replace(arch.stacks[0], kind="conv"),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_cache(conv, 1, 16, dtype=torch.float32, device="cpu")


# -- _write_cache against the reference ---------------------------------------


WRITE_CASES = {
    # (slots, ring, T, per-row start positions)
    "contiguous": (12, False, 3, [0, 4]),
    "ring T<=slots": (8, True, 5, [6, 13]),
    "ring T>slots": (4, True, 11, [0, 9]),
    "one start for every row": (8, True, 3, [5]),
    "clamped at pos+T>max_seq": (10, False, 4, [8, 3]),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_write_cache_matches_reference(case):
    """Non-ring spans (the start clamped as ``dynamic_update_slice`` clamps
    it: a row at ``pos + T > max_seq`` lands at ``max_seq - T``, nothing
    out of range, nothing raised), ring slots ``(pos + t) % S`` with the
    writes a later token of the chunk supersedes dropped first, per-row
    starts; the cache tensors written in place."""
    S, ring, T, starts = WRITE_CASES[case]
    rng = np.random.default_rng(5)
    B = 2
    k0 = rng.normal(size=(B, S, 2, 3)).astype(np.float32)
    kpos0 = rng.integers(-1, 40, (B, S)).astype(np.int32)
    val = rng.normal(size=(B, T, 2, 3)).astype(np.float32)
    pos = np.asarray(starts, np.int32)
    want = jattn._write_cache({"k": jnp.asarray(k0), "kpos": jnp.asarray(kpos0)},
                              {"k": jnp.asarray(val)}, jnp.asarray(pos), ring)
    cache = {"k": torch.from_numpy(k0.copy()), "kpos": torch.from_numpy(kpos0.copy())}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got = attn._write_cache(cache, {"k": torch.from_numpy(val)}, torch.from_numpy(pos), ring)
    assert {k: v.data_ptr() for k, v in got.items()} == ptrs  # in place, never rebound
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["kpos"].numpy(), np.asarray(want["kpos"]))
    assert not np.array_equal(got["kpos"].numpy(), kpos0)


# -- contiguous attention layers against the reference ------------------------


def _attn_pair(a_kw, d_model, q_kw):
    ja, a = JAttnConfig(**a_kw), AttnConfig(**a_kw)
    jq, q = JQuantConfig(**q_kw), QuantConfig(**q_kw)
    p = unbox(jattn.init_attention(KEY, d_model, ja, jq))
    return ja, a, jq, q, p, from_jax_numpy(_np(p))


def _replay(p, a, q, x, steps, max_seq, **kw):
    """Token-by-token decode of ``x`` over a fresh contiguous cache."""
    cache = attn.init_attn_cache(x.shape[0], a, max_seq, torch.float32, device="cpu")
    outs = []
    for t in range(steps):
        o, cache = attn.apply_attention(p, x[:, t:t + 1], a, q,
                                        torch.full((x.shape[0], 1), t, dtype=torch.int32),
                                        cache, compute_dtype=torch.float32, **kw)
        outs.append(o)
    return torch.cat(outs, dim=1), cache


def _one_chunk(p, a, q, x, max_seq, **kw):
    """The whole of ``x`` as one prefill chunk into a fresh contiguous cache
    (over a ring shorter than ``x``: the snapshot path, the chunk wider than
    the ring)."""
    cache = attn.init_attn_cache(x.shape[0], a, max_seq, torch.float32, device="cpu")
    pos = torch.arange(x.shape[1], dtype=torch.int32)[None].expand(x.shape[0], -1)
    return attn.apply_attention(p, x, a, q, pos, cache, compute_dtype=torch.float32, **kw)


QF = dict(mode="none")
QA = dict(mode="a2q", weight_bits=8, act_bits=8, acc_bits=20)


@pytest.mark.parametrize("qkw", [QF, QA], ids=["float", "a2q"])
@pytest.mark.parametrize("window,chunk", [(None, None), (8, None), (None, 8)])
def test_gqa_decode_matches_parallel(qkw, window, chunk):
    """``tests/test_layers.py``'s gate on the port: 20 tokens decoded one at a
    time over a contiguous cache (a ring of 8 with a window or a chunk)
    equal the same 20 as one prefill chunk into a fresh cache (wider than
    the ring), and, in float, the reference's parallel forward.  With A2Q
    the two packages' forwards differ where an activation sits at a rounding
    tie (their ``exp2`` scales differ by ulps, ``ROADMAP.md`` queue 3), so
    the port is held to its own parallel form there."""
    ja, a, jq, q, pj, p = _attn_pair(dict(heads=4, kv_heads=2, head_dim=16, window=window,
                                          chunk=chunk), 64, qkw)
    x = np.asarray(jax.random.normal(KEY, (2, 20, 64), jnp.float32))
    dec, cache = _replay(p, a, q, torch.from_numpy(x.copy()), 20, 64)
    one, _ = _one_chunk(p, a, q, torch.from_numpy(x.copy()), 64)
    np.testing.assert_allclose(dec.numpy(), one.numpy(), rtol=0, atol=EPS)
    if qkw is QF:
        pos = jnp.broadcast_to(jnp.arange(20)[None], (2, 20))
        full, _ = jattn.apply_attention(pj, jnp.asarray(x), ja, jq, pos, q_chunk=8,
                                        compute_dtype=jnp.float32)
        np.testing.assert_allclose(dec.numpy(), np.asarray(full), rtol=0, atol=EPS)
    assert cache["k"].shape[1] == (64 if window is None and chunk is None else 8)


def test_ring_cache_evicts_beyond_window():
    """A 500k-context cache of window 4 holds 4 slots, and decoding 10 tokens
    through it equals the reference's parallel forward."""
    ja, a, jq, q, pj, p = _attn_pair(dict(heads=2, kv_heads=2, head_dim=8, window=4), 16, QF)
    assert attn.init_attn_cache(1, a, 1 << 19, device="cpu")["k"].shape[1] == 4
    x = np.asarray(jax.random.normal(KEY, (1, 10, 16), jnp.float32))
    pos = jnp.broadcast_to(jnp.arange(10)[None], (1, 10))
    full, _ = jattn.apply_attention(pj, jnp.asarray(x), ja, jq, pos, compute_dtype=jnp.float32)
    dec, cache = _replay(p, a, q, torch.from_numpy(x.copy()), 10, 1 << 19)
    np.testing.assert_allclose(dec.numpy(), np.asarray(full), rtol=0, atol=EPS)
    assert sorted(cache["kpos"][0].tolist()) == [6, 7, 8, 9]


@pytest.mark.parametrize("absorb", [False, True], ids=["materialized", "absorbed"])
def test_mla_contiguous_decode_matches_parallel(absorb):
    """The contiguous MLA branch (latent ``ckv``/``kpe`` lanes), with and
    without ``mla_absorb``: in float, decoded token by token against the
    reference's parallel forward and its contiguous decode; with A2Q
    (the activation quantizer replayed on the latent), against the same
    tokens as one prefill chunk, the reference's gate of 1e-3."""
    kw = dict(kind="mla", heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    x = np.asarray(jax.random.normal(KEY, (2, 12, 32), jnp.float32))
    ja, a, jq, q, pj, p = _attn_pair(kw, 32, QF)
    pos = jnp.broadcast_to(jnp.arange(12)[None], (2, 12))
    full, _ = jattn.apply_attention(pj, jnp.asarray(x), ja, jq, pos, q_chunk=8,
                                    compute_dtype=jnp.float32)
    jcache = jattn.init_attn_cache(2, ja, max_seq=16, dtype=jnp.float32)
    jstep = jax.jit(lambda xt, t, c: jattn.apply_attention(
        pj, xt, ja, jq, jnp.full((2, 1), t, jnp.int32), c, compute_dtype=jnp.float32,
        mla_absorb=absorb))
    jdec = []
    for t in range(12):
        o, jcache = jstep(jnp.asarray(x[:, t:t + 1]), t, jcache)
        jdec.append(np.asarray(o))
    dec, cache = _replay(p, a, q, torch.from_numpy(x.copy()), 12, 16, mla_absorb=absorb)
    np.testing.assert_allclose(dec.numpy(), np.asarray(full), rtol=0, atol=EPS)
    np.testing.assert_allclose(dec.numpy(), np.concatenate(jdec, 1), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    for name in ("ckv", "kpe"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=0,
                                   atol=1e-5)
    _, a, _, q, _, p = _attn_pair(kw, 32, QA)
    dec, _ = _replay(p, a, q, torch.from_numpy(x.copy()), 12, 16, mla_absorb=absorb)
    one, _ = _one_chunk(p, a, q, torch.from_numpy(x.copy()), 16, mla_absorb=absorb)
    np.testing.assert_allclose(dec.numpy(), one.numpy(), rtol=0, atol=1e-3)


# -- the contiguous engine against the reference's ----------------------------


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_engine_matches_jax_serve_engine(jax_runs, case):
    """More requests than slots, mixed lengths: per-token prefill into a
    slot's lane while the other row rides, slot recycling, host argmax."""
    c = SERVE_CASES[case]
    name = case.split()[0]
    arch = _arch(name)
    e = ServeEngine(arch, from_jax_numpy(_np(_jparams(name, c["deployed"]))), batch=2,
                    max_seq=32, rt=Runtime(**c["rt"]), device="cpu")
    e.generate(_prompts(arch.vocab, 1, c["lens"]), max_new=5)
    _same_requests(jax_runs[case], e.last_requests)
    tp = e.throughput()
    assert tp["prefill_tokens"] == sum(c["lens"])
    assert tp["decode_tokens"] == len(c["lens"]) * 4  # the first token booked under prefill
    assert tp["decode_tok_s"] > 0 and tp["prefill_tok_s"] > 0


def test_recurrent_arch_lockstep_generation(jax_runs):
    """``tests/test_serve.py``'s rwkv6 lockstep case: one equal-length group
    prefilled together from a fresh cache; then a second group on the same
    engine starts from a rebuilt cache and gives the first group's tokens."""
    arch = _arch("rwkv6-7b")
    e = ServeEngine(arch, from_jax_numpy(_np(_jparams("rwkv6-7b"))), batch=2, max_seq=32,
                    device="cpu")
    assert e.recurrent
    prompts = _prompts(arch.vocab, 2, LOCKSTEP_LENS)
    first = e.generate(prompts, max_new=4)
    _same_requests(jax_runs["rwkv6 lockstep"], e.last_requests)
    assert e.generate(prompts, max_new=4) == first
    with pytest.raises(ValueError):
        e.generate(_prompts(arch.vocab, 2, (3, 4)), max_new=2)


def test_contiguous_engine_stops_on_eos():
    """``tests/test_serve.py``'s EOS case: a request ends the step it emits the
    engine's ``eos_id`` (recorded, nothing after); a per-request id beats
    the default."""
    arch = _arch("yi-6b")
    params = from_jax_numpy(_np(_jparams("yi-6b")))
    prompt = np.arange(5, dtype=np.int32)
    jfull = JServeEngine(jreduced(jget_arch("yi-6b")), _jparams("yi-6b"), batch=2,
                         max_seq=32).generate([prompt], max_new=6)[0]
    full = ServeEngine(arch, params, batch=2, max_seq=32, device="cpu").generate([prompt],
                                                                                  max_new=6)[0]
    assert full == jfull
    eos = full[2]
    e = ServeEngine(arch, params, batch=2, max_seq=32, eos_id=eos, device="cpu")
    assert e.generate([prompt], max_new=6)[0] == full[: full.index(eos) + 1]
    req = e.last_requests[0]
    assert req.done and req.latency >= 0 and req.ttft >= 0
    e2 = ServeEngine(arch, params, batch=2, max_seq=32, eos_id=eos, device="cpu")
    from repro_torch.serve.engine import Request

    r = Request(uid=0, prompt=prompt, max_new=6, eos_id=-1)  # never emitted
    e2.admit(r)
    while e2.tick():
        pass
    assert r.generated == full


def test_accounting_convention_matches_paged_and_device_check():
    """The two engines book the same workload alike (the first token under
    prefill) and give the same tokens; params on another device refuse."""
    arch = _arch("yi-6b")
    params = from_jax_numpy(_np(_jparams("yi-6b")))
    prompts = _prompts(arch.vocab, 9, (5, 3))
    contig = ServeEngine(arch, params, batch=2, max_seq=32, device="cpu")
    paged = PagedServeEngine(arch, params, batch=2, max_seq=32, block_size=4, prefill_chunk=4,
                             device="cpu")
    assert contig.generate(prompts, max_new=4) == paged.generate(prompts, max_new=4)
    for k in ("prefill_tokens", "decode_tokens"):
        assert contig.stats[k] == paged.stats[k]
    assert contig.stats["decode_tokens"] == 2 * 3
    contig.reset_stats()
    assert contig.stats["decode_dispatches"] == 0
    meta = {**params, "final_norm": {k: v.to("meta") for k, v in params["final_norm"].items()}}
    with pytest.raises(ValueError, match="is on meta"):
        ServeEngine(arch, meta, batch=2, max_seq=32, device="cpu")


# -- lockstep admission in the paged engine -----------------------------------


def test_paged_engine_lockstep_fallback(jax_runs):
    """``tests/test_paged.py``'s lockstep fallback on reduced yi-6b (the
    reference's test takes hymba; ``tests/test_torch_hymba.py`` serves it):
    equal-length groups prefilled together into an empty
    engine, a shorter prompt waiting for the next group; tokens against the
    contiguous oracle and the reference's lockstep engine."""
    arch = _arch("yi-6b")
    params = from_jax_numpy(_np(_jparams("yi-6b")))
    prompts = _prompts(arch.vocab, 3, (6, 6, 6, 4))
    lock = PagedServeEngine(arch, params, batch=2, max_seq=64, block_size=4, prefill_chunk=4,
                            lockstep=True, device="cpu")
    assert lock.sched.lockstep
    got = lock.generate(prompts, max_new=3)
    oracle = ServeEngine(arch, params, batch=1, max_seq=64, device="cpu")
    assert got == [oracle.generate([p], max_new=3)[0] for p in prompts]
    _same_requests(jax_runs["yi-6b paged lockstep"], lock.last_requests)
    assert lock.stats["prefill_tokens"] == sum(len(p) for p in prompts)
    assert lock.cache.free_blocks == lock.cache.num_blocks - 1


def test_block_pressure_wave_megastep_against_contiguous_oracle(jax_runs):
    """The workload of the reference's failing
    ``test_bursty_skewed_wave_completes_under_block_pressure[4]`` on the port
    at ``decode_steps=4``: 9 prompts over 2 slots, 19 usable blocks of 4
    tokens.  Every request decodes its full budget, token for token the
    contiguous ``ServeEngine``'s, and the stream holds against the
    reference's per-tick paged engine under ``parity_up_to_ties``."""
    arch = _arch("yi-6b")
    params = from_jax_numpy(_np(_jparams("yi-6b")))
    prompts = _wave_prompts(arch.vocab)
    e = PagedServeEngine(arch, params, decode_steps=4, device="cpu", **WAVE_KW)
    outs = e.generate(prompts, max_new=5)
    assert all(len(o) == 5 for o in outs)
    oracle = ServeEngine(arch, params, batch=2, max_seq=64, device="cpu")
    assert outs == oracle.generate(prompts, max_new=5)
    ok, ties, detail = parity_up_to_ties(jax_runs["wave"], outs, EPS)
    assert ok, detail
    assert ties == 0
    assert e.cache.peak_blocks <= 19 and e.cache.free_blocks == 19


# -- the launcher --------------------------------------------------------------


def test_launcher_parity_check_eos_auto_and_contiguous_run(capsys):
    """``--parity-check`` (paged against contiguous, exact on float KV, at eps
    0.05 on integer KV), ``--eos-auto`` and a run without ``--paged``, on
    reduced yi-6b: all give the same tokens."""
    base = ["--arch", "yi-6b", "--reduced", "--deploy-int8", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--max-new", "4", "--batch", "2",
            "--max-seq", "32", "--block-size", "4", "--prefill-chunk", "4"]
    contig = launch_serve.main(base)
    assert "[contiguous] prefill:" in capsys.readouterr().out
    paged = launch_serve.main(base + ["--paged", "--parity-check"])
    out = capsys.readouterr().out
    assert "parity OK: 3 requests token-identical" in out and paged == contig
    launch_serve.main(base + ["--paged", "--parity-check", "--int-forward", "--kv-int8",
                              "--decode-kernel"])
    out = capsys.readouterr().out
    assert "parity OK (integer KV)" in out and "eps=0.05" in out
    auto = launch_serve.main(base + ["--paged", "--parity-check", "--eos-auto"])
    out = capsys.readouterr().out
    eos = contig[0][len(contig[0]) // 2]
    assert f"eos-auto: eos_id={eos}" in out
    assert auto == [o[: o.index(eos) + 1] if eos in o else o for o in contig]
    assert len(auto[0]) < 4
    with pytest.raises(SystemExit):
        launch_serve.main(base + ["--eos-auto", "--eos-id", "1"])
