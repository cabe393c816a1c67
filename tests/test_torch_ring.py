"""Ring caches (sliding-window attention) in the port against the JAX package.

Reduced h2o-danube-1.8b: 2 layers, window 16 (``reduced`` cuts 4096 to 16),
fp32 compute, params from the JAX init loaded with ``from_jax_numpy``.
Prompts of 17-26 tokens wrap the ring during prefill, and decoding wraps it
again; prefill chunks of 8 stay inside the ring, a chunk of 24 is wider
than it.  The paged engine keeps a ring a slot (the reference's contiguous
ring layout, ``serve/paged_cache.py``); its greedy tokens are held exactly
against the JAX paged engine (per tick and on the megastep), against the
port's contiguous ``ServeEngine`` and against the port's per-tick engine
(the megastep's margins bit for bit); per-step margins against JAX to 1e-4
(the packages' fp32 logits agree to ~1e-6).  A slot is reused after its
request finishes, so ``reset_slot`` must empty the ring (``kpos`` -1).  The
JAX engine runs share one module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime, apply_lm, init_cache
from repro_torch.serve.engine import PagedServeEngine, ServeEngine, deploy_params
from repro_torch.serve.paged_cache import PagedKVCache

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
EPS = 1e-4
H2O = "h2o-danube-1.8b"
KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=8)
LENS = (20, 5, 17, 3, 26)  # five requests over two slots: both slots reused
MAX_NEW = 6
WIDE = np.arange(24, dtype=np.int32)  # one prefill chunk of 24 over a ring of 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_J = {}


def _jparams(name):
    if name not in _J:
        _J[name] = unbox(jinit_lm(KEY, jreduced(jget_arch(name))))
    return _J[name]


def _params(name):
    return from_jax_numpy(_np(_jparams(name)))


def _arch(name=H2O):
    return reduced(get_arch(name))


def _prompts(vocab, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def jax_paged():
    """The reference's paged engine on reduced h2o: per tick and at
    ``decode_steps=4`` on the same prompts, and the 24-token chunk."""
    arch = jreduced(jget_arch(H2O))
    out = {}
    for steps in (1, 4):
        e = JPagedServeEngine(arch, _jparams(H2O), decode_steps=steps, **KW)
        e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
        out[steps] = e.last_requests
    e = JPagedServeEngine(arch, _jparams(H2O), batch=1, max_seq=64, block_size=4,
                          prefill_chunk=24)
    e.generate([WIDE % arch.vocab], max_new=3)
    out["wide"] = e.last_requests
    return out


def test_ring_leaves_in_the_paged_cache():
    """A window layer keeps its per-slot ring ``(count, slots, W, KV, Dh)`` and
    ``kpos`` (all -1) in the paged cache, float whatever ``kv_quant`` says;
    it costs no KV bytes a token (the reference's count) and its bytes a
    slot are the ring's."""
    arch = _arch()
    a = arch.stacks[0].attn
    for kv_quant in (False, True):
        c = PagedKVCache(arch, 3, block_size=4, max_seq=64, dtype=torch.float32, device="cpu",
                         kv_quant=kv_quant)
        leaves = c.pools["0"]["attn"]
        assert set(leaves) == {"k", "v", "kpos"}
        assert leaves["k"].shape == (2, 3, a.window, a.kv_heads, a.head_dim)
        assert leaves["k"].dtype == torch.float32
        assert (leaves["kpos"] == -1).all() and leaves["kpos"].shape == (2, 3, a.window)
        assert c.kv_bytes_per_token() == 0
        assert c.state_bytes_per_slot() == 2 * a.window * (2 * a.kv_heads * a.head_dim * 4 + 4)
    jc = JPagedKVCache(jreduced(jget_arch(H2O)), 3, block_size=4, max_seq=64,
                       dtype=jnp.float32)
    assert jc.kv_bytes_per_token() == 0 and not jc.fully_paged
    # a ring shorter than the window when max_seq is
    short = PagedKVCache(arch, 1, block_size=4, max_seq=8, dtype=torch.float32, device="cpu")
    assert short.pools["0"]["attn"]["k"].shape[2] == 8


def test_reset_slot_empties_the_ring():
    """``reset_slot`` sets the slot's ``kpos`` to -1 and its K/V to 0 (a zero
    ``kpos`` would make a stale zero key valid at position 0), in place,
    and leaves the other slots alone."""
    c = PagedKVCache(_arch(), 2, block_size=4, max_seq=64, dtype=torch.float32, device="cpu")
    leaves = c.pools["0"]["attn"]
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    for v in leaves.values():
        v.fill_(7)
    c.reset_slot(1)
    assert (leaves["kpos"][:, 1] == -1).all() and (leaves["k"][:, 1] == 0).all()
    assert (leaves["v"][:, 1] == 0).all()
    assert (leaves["kpos"][:, 0] == 7).all() and (leaves["k"][:, 0] == 7).all()
    assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs


def test_chunked_prefill_wider_than_ring_window(jax_paged):
    """``tests/test_paged.py``'s regression: a prefill chunk of 24 over a ring
    of 16 maps tokens t and t + 16 to one slot; only the later write may
    survive.  Against the contiguous oracle (token by token) and the
    reference's engine."""
    arch = _arch()
    params = _params(H2O)
    e = PagedServeEngine(arch, params, batch=1, max_seq=64, block_size=4, prefill_chunk=24,
                         device="cpu")
    got = e.generate([WIDE % arch.vocab], max_new=3)
    oracle = ServeEngine(arch, params, batch=1, max_seq=64, device="cpu")
    assert got == oracle.generate([WIDE % arch.vocab], max_new=3)
    ref = jax_paged["wide"]
    assert got == [r.generated for r in ref]
    np.testing.assert_allclose(e.last_requests[0].margins, ref[0].margins, rtol=0, atol=EPS)


@pytest.mark.parametrize("name", [H2O, "rwkv6-7b"])
def test_chunked_prefill_matches_stepwise_on_contiguous_cache(name):
    """``apply_lm`` with ``T > 1`` over a contiguous cache (a ring, or rwkv6's
    recurrent leaves) equals feeding the tokens one at a time, and equals
    the reference's chunked logits; 20 tokens in chunks of 7, 9 and 4 wrap
    the ring of 16."""
    jarch, arch = jreduced(jget_arch(name)), _arch(name)
    pj, params = _jparams(name), _params(name)
    toks = np.arange(20, dtype=np.int32) % arch.vocab
    step = init_cache(arch, 1, 32, dtype=torch.float32, device="cpu")
    for pos, t in enumerate(toks):
        logits_step, _ = apply_lm(params, arch, tokens=torch.tensor([[int(t)]]), cache=step,
                                  start_pos=pos)
    chunked = init_cache(arch, 1, 32, dtype=torch.float32, device="cpu")
    jchunked = jinit_cache(jarch, 1, 32, dtype=jnp.float32)
    for lo, hi in ((0, 7), (7, 16), (16, 20)):
        logits_chunk, _ = apply_lm(params, arch, tokens=torch.from_numpy(toks[None, lo:hi]),
                                   cache=chunked, start_pos=lo)
        jl, jchunked, _ = japply_lm(pj, jarch, tokens=jnp.asarray(toks[None, lo:hi]),
                                    cache=jchunked, start_pos=jnp.asarray(lo, jnp.int32))
    np.testing.assert_allclose(logits_chunk[0, -1].numpy(), logits_step[0, 0].numpy(), rtol=0,
                               atol=EPS)
    np.testing.assert_allclose(logits_chunk.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(_np(jchunked))[0],
                                 jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), chunked))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("steps", [1, 4], ids=["per-tick", "megastep"])
def test_ring_engine_matches_jax_paged_engine(jax_paged, steps):
    """The paged engine with ring layers: five requests over two slots (each
    slot reused after its request finishes), prompts that wrap the ring in
    prefill, decode past the window; tokens exactly the reference paged
    engine's at the same ``decode_steps`` and the contiguous ``ServeEngine``'s,
    margins to 1e-4; the rings written in place."""
    arch = _arch()
    params = _params(H2O)
    prompts = _prompts(arch.vocab)
    e = PagedServeEngine(arch, params, decode_steps=steps, device="cpu", **KW)
    leaves = e.cache.pools["0"]["attn"]
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    outs = e.generate(prompts, max_new=MAX_NEW)
    ref = jax_paged[steps]
    assert outs == [r.generated for r in ref]
    for r, q in zip(ref, e.last_requests):
        np.testing.assert_allclose(q.margins, r.margins, rtol=0, atol=EPS)
    oracle = ServeEngine(arch, params, batch=2, max_seq=64, device="cpu")
    assert outs == oracle.generate(prompts, max_new=MAX_NEW)
    assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
    assert e.cache.free_blocks == e.cache.num_blocks - 1
    if steps > 1:
        assert e.stats["decode_dispatches"] < e.stats["decode_tokens"]


def test_ring_megastep_int_chain_bit_for_bit_with_eos(monkeypatch):
    """The card's phase 4h path on reduced h2o: deployed, ``--int-chain
    --decode-kernel`` (ring layers take ``_sdpa``: no paged-attention
    launch), the megastep against the per-tick engine with tokens and
    margins bit for bit, then the EOS rerun: request 0 ends early in both,
    mid window, and its slot is reused."""
    from repro_torch.kernels import ops

    calls = []
    monkeypatch.setattr(ops, "paged_attention", lambda *a, **k: calls.append(1))
    arch = _arch()
    params = deploy_params(_params(H2O), arch.quant)
    prompts = _prompts(arch.vocab, seed=22)
    kw = dict(KW, rt=Runtime(int_chain=True, decode_kernel=True), device="cpu")
    tick = PagedServeEngine(arch, params, **kw)
    full = tick.generate(prompts, max_new=MAX_NEW)
    eos = full[0][2]
    runs = []
    for steps in (1, 4):
        e = PagedServeEngine(arch, params, decode_steps=steps, eos_id=eos, **kw)
        outs = e.generate(prompts, max_new=MAX_NEW)
        runs.append((outs, [r.margins for r in e.last_requests]))
    assert runs[0] == runs[1] and not calls
    assert runs[0][0][0] == full[0][: full[0].index(eos) + 1] and len(runs[0][0][0]) < MAX_NEW
