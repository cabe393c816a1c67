"""Prefix sharing in the port: the paged cache's refcounts, copy-on-write,
rollback/truncate and radix prompt cache, and ``PagedServeEngine``'s
``prefix_share`` and ``pin_prompt``, against the JAX package.

The cache's host state is a numpy twin of the reference's, so the allocator
twin drives both caches through the same seeded random op sequences
(allocate, lookup + adopt, ``ensure_writable``, rollback, truncate,
register, reclaim, release) and holds every field after every op: tables,
lengths, refcounts, the free list (order included), watermarks, registry
size, reclaimable blocks, the counters and the pools' contents (both filled
with the same values first, so every copy-on-write copy is compared).  The
reference's host-logic tests (``tests/test_prompt_cache.py`` and the cache
half of ``tests/test_spec.py``) are ported case by case.  The port copies
blocks in place: no pool tensor is rebound, one ``index_copy_`` a pool leaf
a batch.

The engine gates: sharing is token-identical to the port's plain paged
engine (margins bit for bit), per tick and on the megastep, and within
``parity_up_to_ties`` (eps 1e-4, fp32 reduced configs) of JAX's sharing
engine on the same params (``from_jax_numpy``) with the same
``prefix_hits``, ``cow_copies`` and prefill tokens: reduced yi-6b and
deepseek-v3 with ``mla_absorb``, and the ``pin_prompt`` path.  The JAX
engines run once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties
from repro_torch.serve.paged_cache import TRASH_BLOCK, PagedKVCache

torch.set_num_threads(1)

EPS = 1e-4


def _cache(slots=3, num_blocks=32, block_size=4, max_seq=64, **kw):
    return PagedKVCache(reduced(get_arch("yi-6b")), slots=slots, block_size=block_size,
                        max_seq=max_seq, num_blocks=num_blocks, dtype=torch.float32,
                        **{"device": "cpu", **kw})


def _pool_leaves(c):
    return list(c._leaves(pools=True))


def _stamp(c, blocks):
    """Distinct content in each of ``blocks`` (block j holds j + 1)."""
    for j, b in enumerate(blocks):
        for leaf in _pool_leaves(c):
            leaf[:, b] = float(j + 1)


# -- the allocator twin ---------------------------------------------------------


def _jax_pool_leaves(jc):
    return [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(jc.pools)[0]]


def _fill_same(jc, c, seed):
    """The same random values in every pool of both caches."""
    rng = np.random.default_rng(seed)
    vals = {}

    def one(path, leaf):
        vals[jax.tree_util.keystr(path)] = v = rng.normal(size=leaf.shape).astype(np.float32)
        return jnp.asarray(v)

    jc.pools = jax.tree_util.tree_map_with_path(one, jc.pools)

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                walk(v, key)
            else:
                v.copy_(torch.from_numpy(vals[key]))

    walk(c.pools, "")


def _assert_twins(jc, c, tag):
    np.testing.assert_array_equal(c.tables, jc.tables, err_msg=tag)
    np.testing.assert_array_equal(c.lens, jc.lens, err_msg=tag)
    np.testing.assert_array_equal(c.refcounts, jc.refcounts, err_msg=tag)
    np.testing.assert_array_equal(c.watermarks, jc.watermarks, err_msg=tag)
    np.testing.assert_array_equal(c._entry_rc, jc._entry_rc, err_msg=tag)
    assert c.free == jc.free, tag
    assert c._owned == jc._owned, tag
    assert c.registry_size() == jc.registry_size(), tag
    assert c.registered_blocks() == jc.registered_blocks(), tag
    assert c.reclaimable_blocks() == jc.reclaimable_blocks(), tag
    assert c._radix_unpinned == jc._radix_unpinned, tag
    want = jc.counters()
    assert c.counters() == {k: want[k] for k in c.counters()}, tag


@pytest.mark.parametrize("seed", range(4))
def test_allocator_twin_random_ops(seed):
    """Random schedules over 3 slots, 14 blocks of 4 tokens and a node cap
    of 4 (so the cap evicts as well as ``reclaim``): the port's cache and the
    reference's stay equal field by field after every op, the pools' contents
    included, the same ops raise out of blocks in both, and a full release
    and reclaim hands every block back."""
    jc = JPagedKVCache(jreduced(jget_arch("yi-6b")), slots=3, block_size=4, max_seq=32,
                       num_blocks=14, dtype=jnp.float32, max_prefix_entries=4)
    c = _cache(slots=3, num_blocks=14, block_size=4, max_seq=32, max_prefix_entries=4)
    _fill_same(jc, c, seed)
    rng = np.random.default_rng(100 + seed)
    registered: list[np.ndarray] = []
    lens_target = [0, 0, 0]
    weights = np.array([4, 3, 4, 3, 1.5, 1.5, 1.5, 1.5])
    for step in range(100):
        op, slot = int(rng.choice(8, p=weights / weights.sum())), step % 3

        def both(fn):
            outcome = []
            for cache in (jc, c):
                try:
                    outcome.append(("ok", fn(cache)))
                except RuntimeError as err:
                    outcome.append(("raised", str(err)))
            assert outcome[0] == outcome[1], (step, op, outcome)
            return outcome[0]

        if op == 0:
            n = 4 + 4 * int(rng.integers(0, 6))
            kind, _ = both(lambda cc: cc.allocate(slot, n))
            if kind == "ok":
                lens_target[slot] = max(lens_target[slot], n)
                jc.lens[slot] = c.lens[slot] = lens_target[slot]
        elif op == 1 and lens_target[slot] >= 2:
            toks = (np.arange(lens_target[slot]) + 7 * int(rng.integers(0, 3))).astype(np.int32)
            pinned = bool(rng.integers(0, 4) == 0)
            both(lambda cc: cc.register_prefix(slot, toks, pinned=pinned))
            registered.append(toks)
        elif op == 2 and registered and not c._owned[slot]:
            base = registered[int(rng.integers(0, len(registered)))]
            m = int(rng.integers(1, base.size + 1))
            q = np.concatenate([base[:m], [900 + step, 901]]).astype(np.int32)
            _, (shared, blocks) = both(lambda cc: cc.lookup_prefix(q))
            if shared > 0:
                both(lambda cc: cc.adopt_prefix(slot, shared, blocks))
                lens_target[slot] = shared
        elif op == 3 and c._owned[slot]:
            end = min(len(c._owned[slot]) * c.block_size, int(c.lens[slot]) + 2)
            both(lambda cc: cc.ensure_writable(slot, max(0, end - 6), end))
        elif op == 4 and c._owned[slot]:
            keep = max(0, int(c.lens[slot]) - 3)
            both(lambda cc: cc.truncate(slot, keep))
            lens_target[slot] = keep
        elif op == 5:
            both(lambda cc: cc.release(slot))
            lens_target[slot] = 0
        elif op == 6 and c.lens[slot] > 0:
            n = int(c.lens[slot]) - 1
            both(lambda cc: cc.rollback(slot, n))
            lens_target[slot] = n
        elif op == 7:
            need = int(rng.integers(1, 8))
            both(lambda cc: cc.reclaim(need))
        _assert_twins(jc, c, f"step {step} op {op}")
        for jl, leaf in zip(_jax_pool_leaves(jc), _pool_leaves(c)):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jl))
        # the reference's invariants: refcount = owners + radix pins
        owners = np.zeros(c.num_blocks, np.int32)
        for o in c._owned:
            for b in o:
                owners[b] += 1
        np.testing.assert_array_equal(c.refcounts, owners + c._entry_rc)
        assert c.refcounts[TRASH_BLOCK] == 0 and TRASH_BLOCK not in c.free
    for cache in (jc, c):
        for s in range(3):
            cache.release(s)
        cache.reclaim(cache.num_blocks)
    _assert_twins(jc, c, "drained")
    # only pinned chains stay: every other block is back on the free list
    assert sorted(c.free + list(c.registered_blocks())) == list(range(1, c.num_blocks))
    np.testing.assert_array_equal(c.refcounts, c._entry_rc)


# -- the radix prompt cache (reference: tests/test_prompt_cache.py) -------------


def test_radix_partial_prefix_hit_mid_block():
    c = _cache()
    toks = np.arange(12, dtype=np.int32)
    c.allocate(0, 12)
    c.lens[0] = 12
    c.register_prefix(0, toks)
    donor_blocks = tuple(c._owned[0][:3])
    q = np.concatenate([toks[:6], [99, 98, 97]]).astype(np.int32)
    assert c.lookup_prefix(q) == (6, donor_blocks[:2])
    q0 = np.concatenate([toks[:2], [77, 76, 75]]).astype(np.int32)
    assert c.lookup_prefix(q0) == (2, donor_blocks[:1])
    c.release(0)


def test_radix_dedup_same_prefix_pins_once():
    c = _cache()
    toks = np.arange(8, dtype=np.int32)
    c.allocate(0, 8)
    c.lens[0] = 8
    c.register_prefix(0, toks)
    size0, rc0 = c.registry_size(), c._entry_rc.copy()
    shared, blocks = c.lookup_prefix(np.concatenate([toks, [5]]).astype(np.int32))
    c.adopt_prefix(1, shared, blocks)
    c.lens[1] = 8
    c.register_prefix(1, toks)  # same prompt, second donor
    assert c.registry_size() == size0
    np.testing.assert_array_equal(c._entry_rc, rc0)


@pytest.mark.parametrize("n", [8, 12])
def test_radix_lookup_caps_below_full_prompt(n):
    c = _cache()
    toks = np.arange(n, dtype=np.int32)
    c.allocate(0, n)
    c.lens[0] = n
    c.register_prefix(0, toks)
    assert c.lookup_prefix(toks)[0] == n - 1  # prefill keeps one token for logits


def test_lru_hot_entry_survives_cold_registration_burst():
    c = _cache(max_prefix_entries=4)
    hot = np.arange(8, dtype=np.int32)
    c.allocate(0, 8)
    c.lens[0] = 8
    c.register_prefix(0, hot)
    c.release(0)
    probe = np.concatenate([hot, [1]]).astype(np.int32)
    for _ in range(5):
        assert c.lookup_prefix(probe)[0] == 8
    for i in range(6):
        cold = (np.arange(8) + 100 * (i + 1)).astype(np.int32)
        c.allocate(1, 8)
        c.lens[1] = 8
        c.register_prefix(1, cold)
        c.release(1)
    assert c.lookup_prefix(probe)[0] == 8, "hot chain was evicted by cold burst"
    assert c._radix_unpinned <= c.max_prefix_entries
    c.reclaim(c.num_blocks)
    assert c.free_blocks == c.num_blocks - 1


def test_eviction_is_leaf_only_and_cost_aware():
    c = _cache(max_prefix_entries=3)
    long = np.arange(12, dtype=np.int32)
    c.allocate(0, 12)
    c.lens[0] = 12
    c.register_prefix(0, long)
    c.release(0)
    c.lookup_prefix(np.concatenate([long, [1]]).astype(np.int32))
    cold = (np.arange(4) + 500).astype(np.int32)
    c.allocate(1, 4)
    c.lens[1] = 4
    c.register_prefix(1, cold)
    c.release(1)
    assert c.lookup_prefix(np.concatenate([long, [1]]).astype(np.int32))[0] == 8
    c.reclaim(c.num_blocks)
    assert c.free_blocks == c.num_blocks - 1


def test_pinned_chain_never_evicted_and_pinning_promotes():
    c = _cache(max_prefix_entries=2)
    pin = (np.arange(12) + 7).astype(np.int32)
    c.allocate(0, 12)
    c.lens[0] = 12
    c.register_prefix(0, pin, pinned=True)
    c.release(0)
    assert c.registry_size() == 3 and c._radix_unpinned == 0
    assert c.reclaimable_blocks() == 0  # the gate must not budget pinned blocks
    probe = np.concatenate([pin, [3]]).astype(np.int32)
    c.reclaim(c.num_blocks)
    assert c.lookup_prefix(probe)[0] == 12
    for i in range(5):
        cold = (np.arange(8) + 1000 * (i + 1)).astype(np.int32)
        c.allocate(1, 8)
        c.lens[1] = 8
        c.register_prefix(1, cold)
        c.release(1)
    assert c.lookup_prefix(probe)[0] == 12
    assert c._radix_unpinned <= c.max_prefix_entries
    # pinning an existing unpinned chain promotes it out of the cap
    c2 = _cache(max_prefix_entries=8)
    toks = np.arange(8, dtype=np.int32)
    c2.allocate(0, 8)
    c2.lens[0] = 8
    c2.register_prefix(0, toks)
    assert c2._radix_unpinned == 2
    c2.register_prefix(0, toks, pinned=True)
    assert c2._radix_unpinned == 0 and c2.registry_size() == 2
    c2.release(0)
    c2.reclaim(c2.num_blocks)
    assert c2.lookup_prefix(np.concatenate([toks, [9]]).astype(np.int32))[0] == 8


# -- refcounts, copy-on-write, truncate (reference: tests/test_spec.py) ---------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_copy_on_write_is_in_place_one_copy_a_leaf():
    """A span over three shared blocks faults all three in one batch: one
    ``index_copy_`` a pool leaf, the copies carry the contents, the donor
    keeps reading the originals, refcounts end private, and no pool tensor
    is rebound by adoption, the copy, rollback or truncate."""
    c = _cache(kv_quant=True)  # code pools and scale pools alike
    c.allocate(0, 12)
    c.lens[0] = 12
    src = list(c._owned[0])
    _stamp(c, src)
    ptrs = [leaf.data_ptr() for leaf in _pool_leaves(c)]
    c.adopt_prefix(1, 10, tuple(src))
    assert c.pool_rebuilds == 0 and all(c.refcounts[b] == 2 for b in src)
    with _CountOps() as ops:
        c.ensure_writable(1, 0, 12)
    assert c.cow_copies == 3 and c.pool_rebuilds == 1
    copies = [n for n in ops.names if n.startswith("index_copy_")]
    assert len(copies) == len(_pool_leaves(c)) == 4  # codes and scales, K and V
    for leaf in _pool_leaves(c):
        for old, new in zip(src, c._owned[1]):
            assert new != old
            assert torch.equal(leaf[:, new], leaf[:, old])
    assert list(c.tables[0, :3]) == src
    assert all(c.refcounts[b] == 1 for b in src + c._owned[1])
    with _CountOps() as ops:
        c.ensure_writable(1, 6, 8)  # unshared now: a no-op
    assert c.cow_copies == 3 and not any(n.startswith("index_copy_") for n in ops.names)
    c.rollback(1, 4)
    c.truncate(1, 4)
    assert [leaf.data_ptr() for leaf in _pool_leaves(c)] == ptrs


def test_cow_shared_block_write_triggers_copy():
    c = _cache(num_blocks=16, max_seq=32)
    c.allocate(0, 8)
    b1 = c._owned[0][1]
    _stamp(c, [b1])
    c.adopt_prefix(1, 6, tuple(c._owned[0][:2]))
    assert c.refcounts[b1] == 2
    free_before = c.free_blocks
    c.ensure_writable(1, 6, 8)
    assert c.cow_copies == 1
    nb = c._owned[1][1]
    assert nb != b1 and c.tables[1, 1] == nb and c.tables[0, 1] == b1
    assert c.refcounts[b1] == 1 and c.refcounts[nb] == 1
    assert c.free_blocks == free_before - 1
    leaf = c.pools["0"]["attn"]["kp"]
    assert torch.equal(leaf[:, nb], leaf[:, b1])


def test_refcount_free_only_at_zero_and_trash_never_refcounted():
    c = _cache(num_blocks=16, max_seq=32)
    c.allocate(0, 8)
    shared = tuple(c._owned[0])
    c.adopt_prefix(1, 7, shared)
    c.adopt_prefix(2, 7, shared)
    assert all(c.refcounts[b] == 3 for b in shared)
    free0 = c.free_blocks
    c.release(0)
    c.release(1)
    assert c.free_blocks == free0
    c.release(2)
    assert c.free_blocks == free0 + len(shared)
    assert c.refcounts[TRASH_BLOCK] == 0 and TRASH_BLOCK not in c.free
    assert int(c.refcounts.sum()) == 0


def test_truncate_restores_allocator_state_exactly():
    c = _cache(num_blocks=16, max_seq=32)
    c.allocate(0, 6)
    c.ensure_writable(0, 0, 6)
    c.lens[0] = 6
    snap = (list(c.free), c.tables.copy(), [list(o) for o in c._owned], c.refcounts.copy(),
            c.lens.copy())
    c.allocate(0, 6 + 5 + 1)
    c.ensure_writable(0, 6, 12)
    c.truncate(0, 6)
    free, tables, owned, rc, lens = snap
    assert c.free == free
    np.testing.assert_array_equal(c.tables, tables)
    assert [list(o) for o in c._owned] == owned
    np.testing.assert_array_equal(c.refcounts, rc)
    np.testing.assert_array_equal(c.lens, lens)
    assert c.watermarks[0] == 12  # the garbage extent stays recorded


def test_prefix_registry_pins_blocks_past_donor_release():
    c = _cache()
    toks = np.arange(10, dtype=np.int32)
    c.allocate(0, 14)
    c.lens[0] = 10
    c.register_prefix(0, toks)
    entry_blocks = tuple(c._owned[0][:2])
    assert c.registry_size() == 2 and c.registered_blocks() == frozenset(entry_blocks)
    c.release(0)
    assert all(c.refcounts[b] == 1 for b in entry_blocks)
    assert c.lookup_prefix(np.concatenate([toks, [99, 98]]).astype(np.int32)) == \
        (8, entry_blocks)
    c.reclaim(c.num_blocks)
    assert c.free_blocks == c.num_blocks - 1 and int(c.refcounts.sum()) == 0
    assert c.lookup_prefix(np.concatenate([toks, [99]]).astype(np.int32))[0] == 0


def test_donor_never_cows_its_registered_blocks():
    c = _cache(slots=2, num_blocks=5, block_size=4, max_seq=16)
    c.allocate(0, 8)
    c.lens[0] = 6
    c.register_prefix(0, np.arange(6, dtype=np.int32))
    c.allocate(1, 8)
    assert c.free_blocks == 0
    c.ensure_writable(0, 6, 8)
    assert c.cow_copies == 0


def test_sharing_stays_off_where_the_cache_is_not_fully_paged():
    """Rings (h2o-danube) and recurrent state (rwkv6) are not fully paged:
    the engine turns ``prefix_share`` off and the cache registers nothing."""
    for name in ("h2o-danube-1.8b", "rwkv6-7b"):
        arch = reduced(get_arch(name))
        e = PagedServeEngine(arch, _params(name), prefix_share=True, batch=2, max_seq=64,
                             block_size=4, prefill_chunk=4, device="cpu")
        assert not e.cache.fully_paged and not e.prefix_share
        e.cache.allocate(0, 8)
        e.cache.register_prefix(0, np.arange(8, dtype=np.int32))
        assert e.cache.registry_size() == 0
    assert _cache().fully_paged


# -- the engine -----------------------------------------------------------------

_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        _PARAMS[name] = init_lm(torch.Generator().manual_seed(0), reduced(get_arch(name)),
                                device="cpu")
    return _PARAMS[name]


def _shared_prompts(vocab, seed, common_len, tails):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, (common_len,)).astype(np.int32)
    return [np.concatenate([common, rng.integers(0, vocab, (n,)).astype(np.int32)])
            for n in tails]


# block 8 > prefill chunk 4: the chunk-aligned resume (12 of a 13-token common
# prefix) lands mid block, so the adopter's prefill faults the adopted tail block
SHARE_KW = dict(batch=2, max_seq=64, block_size=8, prefill_chunk=4)
PIN_KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4)
JAX_CASES = ("yi-6b", "deepseek-v3-671b absorbed", "yi-6b pinned")


def _case_prompts(case, vocab):
    if case.endswith("pinned"):
        rng = np.random.default_rng(4)
        preamble = rng.integers(0, vocab, (9,)).astype(np.int32)
        return preamble, [np.concatenate([preamble, rng.integers(0, vocab, (n,)).astype(np.int32)])
                          for n in (3, 5, 2)]
    return None, _shared_prompts(vocab, 8, 13, (3, 5, 2))


@pytest.fixture(scope="module")
def jax_sharing():
    """Per case: the JAX init's params as numpy and the reference sharing
    engine's driven requests and counters."""
    out = {}
    for case in JAX_CASES:
        name = case.split()[0]
        arch = jreduced(jget_arch(name))
        params = unbox(jinit_lm(jax.random.PRNGKey(0), arch))
        kw = dict(PIN_KW if case.endswith("pinned") else SHARE_KW)
        if case.endswith("absorbed"):
            kw["rt"] = JRuntime(mla_absorb=True)
        e = JPagedServeEngine(arch, params, prefix_share=True, **kw)
        preamble, prompts = _case_prompts(case, arch.vocab)
        pinned = e.pin_prompt(preamble) if preamble is not None else None
        e.generate(prompts, max_new=4)
        out[case] = (jax.tree.map(np.asarray, params), e.last_requests, pinned,
                     {k: getattr(e.cache, k) for k in ("prefix_hits", "prefix_hit_tokens",
                                                       "cow_copies")},
                     e.stats["prefill_tokens"])
    return out


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("case", JAX_CASES)
def test_sharing_matches_plain_and_jax(jax_sharing, case, steps):
    """Same params in both packages: the port's sharing engine (per tick, or
    the megastep with its window preflight) gives the port's plain engine's
    tokens and margins bit for bit, JAX's sharing engine's tokens within
    ``parity_up_to_ties``, and the same hits, adopted tokens, copy-on-write
    copies and recomputed prefill tokens; a full reclaim then frees every
    unpinned block."""
    params_np, ref_reqs, pinned, counters, prefill_tokens = jax_sharing[case]
    name = case.split()[0]
    arch = reduced(get_arch(name))
    params = from_jax_numpy(params_np)
    kw = dict(PIN_KW if case.endswith("pinned") else SHARE_KW, device="cpu",
              decode_steps=steps)
    if case.endswith("absorbed"):
        kw["rt"] = Runtime(mla_absorb=True)
    preamble, prompts = _case_prompts(case, arch.vocab)
    plain = PagedServeEngine(arch, params, **kw)
    want = plain.generate(prompts, max_new=4)
    e = PagedServeEngine(arch, params, prefix_share=True, **kw)
    if preamble is not None:
        assert e.pin_prompt(preamble) == pinned == 8  # full blocks only
        assert e.cache.free_blocks == e.cache.num_blocks - 1 - 2  # only the pins stay
    ptrs = [leaf.data_ptr() for leaf in e.cache._leaves(pools=True)]
    got = e.generate(prompts, max_new=4)
    assert got == want
    assert [r.margins for r in e.last_requests] == [r.margins for r in plain.last_requests]
    ok, ties, detail = parity_up_to_ties(ref_reqs, got, EPS)
    assert ok, detail
    assert sum(r.generated == o for r, o in zip(ref_reqs, got)) >= len(got) - ties
    assert {k: getattr(e.cache, k) for k in counters} == counters
    assert e.stats["prefill_tokens"] == prefill_tokens < plain.stats["prefill_tokens"]
    assert e.cache.prefix_hits >= 2
    if not case.endswith("pinned"):
        assert e.cache.cow_copies > 0
    assert [leaf.data_ptr() for leaf in e.cache._leaves(pools=True)] == ptrs
    e.cache.reclaim(e.cache.num_blocks)
    assert e.cache.free_blocks == e.cache.num_blocks - 1 - (2 if preamble is not None else 0)


def test_pin_prompt_survives_reclaim_and_needs_prefix_share():
    arch = reduced(get_arch("yi-6b"))
    params = _params("yi-6b")
    kw = dict(PIN_KW, device="cpu")
    preamble, _ = _case_prompts("yi-6b pinned", arch.vocab)
    e = PagedServeEngine(arch, params, prefix_share=True, **kw)
    e.pin_prompt(preamble)
    e.cache.reclaim(e.cache.num_blocks)
    more = [np.concatenate([preamble, np.arange(4, dtype=np.int32)])]
    assert e.generate(more, max_new=4) == PagedServeEngine(arch, params, **kw).generate(
        more, max_new=4)
    assert e.cache.prefix_hits == 1
    with pytest.raises(ValueError):
        PagedServeEngine(arch, params, **kw).pin_prompt(preamble)


@pytest.mark.parametrize("steps", [1, 4])
def test_prefix_share_under_block_pressure_reclaims_not_stalls(steps):
    """Nine blocks for two slots: admission counts the prompt cache's
    evictable blocks as capacity and ``allocate`` reclaims them."""
    arch = reduced(get_arch("yi-6b"))
    params = _params("yi-6b")
    prompts = _shared_prompts(arch.vocab, 9, 8, (2, 3, 4))
    kw = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4, device="cpu",
              decode_steps=steps)
    want = PagedServeEngine(arch, params, **kw).generate(prompts, max_new=3)
    tight = PagedServeEngine(arch, params, prefix_share=True, num_blocks=9, **kw)
    assert tight.generate(prompts, max_new=3) == want
    assert tight.cache.prefix_hits > 0


def test_launcher_prefix_flags(capsys):
    """``--prefix-share --shared-prefix --pin-prompt`` serve the plain
    launcher's tokens with hits reported; the reference's checks refuse
    ``--pin-prompt`` without ``--prefix-share`` and the sharing flags
    without ``--paged``."""
    base = ["--arch", "yi-6b", "--reduced", "--paged", "--device", "cpu", "--requests", "3",
            "--prompt-len", "3", "--max-new", "3", "--batch", "2", "--max-seq", "64",
            "--block-size", "4", "--prefill-chunk", "4", "--shared-prefix", "9",
            "--pin-prompt", "5"]
    with pytest.raises(SystemExit):
        launch_serve.main(base)  # --pin-prompt needs --prefix-share
    plain = launch_serve.main([a for a in base if a not in ("--pin-prompt", "5")])
    capsys.readouterr()
    res = launch_serve.run(base + ["--prefix-share"])
    out = capsys.readouterr().out
    assert "pinned system preamble: 4 of 5 tokens" in out and "prefix sharing: 3 hits" in out
    rep = res["report"]
    assert (rep["prefix_share"], rep["shared_prefix"], rep["pin_prompt"]) == (True, 9, 5)
    assert rep["prefix_hits"] == 3 and rep["prefix_hit_tokens"] > 0 and "cow_copies" in rep
    assert len(res["outs"]) == 3 and all(len(o) == 3 for o in res["outs"])
    assert len(plain) == 3  # the prompts differ (no preamble), only the run is held
    for extra in (["--prefix-share"], ["--shared-prefix", "4"]):
        with pytest.raises(SystemExit):
            launch_serve.main([a for a in base if a not in ("--paged", "--pin-prompt", "5")]
                              + extra)
