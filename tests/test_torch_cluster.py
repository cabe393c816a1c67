"""The serving cluster in the port: KV-block export/import, the prefill/decode
handoff, the router, in-process and spawned replicas, and
``launch/serve_cluster.py``, against the JAX package.

Reduced yi-6b with the reference test's geometry (batch 2, max_seq 64,
blocks of 4, prefill chunks of 4), params from the JAX init
(``from_jax_numpy``).  Two cases run JAX:

* the wire format: for fp32, int8 and int4 KV the same prompt through JAX's
  ``PagedServeEngine.prefill_handoff`` and the port's; the payloads' fields,
  leaf keys (the reference's ``keystr`` paths), dtypes and shapes equal,
  float leaves within ``WIRE_ATOL``/``WIRE_RTOL``, codes equal but for at
  most ``WIRE_TIES`` one apart, the first token equal and the margin within
  ``MARGIN_TOL``;
* the router: ``repro.serve.cluster.Router`` and the port's ``Router``
  driven by the same scripted replica handles (deterministic hello,
  heartbeat, progress and handoff events, an injected clock, one kill):
  the commands each handle receives, ``results()``, ``requeues`` and
  ``deaths`` equal.

Every other gate holds the port's cluster against the port's single engine,
as the reference's ``tests/test_cluster.py`` holds its own (those cases are
ported here under the port's names), plus what is the port's own: the bf16
wire format (raw bits in uint16, the dtype recorded), the in-place import
(every pool's ``data_ptr`` kept; a megastep engine adopting a handoff), the
spawn transport on the CPU and the launcher.
"""

import copy
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.cluster import Router as JRouter
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import Request as JRequest

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve_cluster
from repro_torch.serve.cluster import (
    InProcessReplica,
    ReplicaConfig,
    Router,
    SubprocessReplica,
    build_engine,
    handoff_local,
    make_cluster_configs,
    parse_disagg,
)
from repro_torch.serve.cluster.router import _ReplicaState
from repro_torch.serve.engine import PagedServeEngine, Request
from repro_torch.serve.spec import SpecServeEngine

torch.set_num_threads(1)

JARCH = jreduced(jget_arch("yi-6b"))
JPARAMS = unbox(jinit_lm(jax.random.PRNGKey(0), JARCH))
ARCH = reduced(get_arch("yi-6b"))
PARAMS = from_jax_numpy(jax.tree.map(np.asarray, JPARAMS))
GEOM = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4)
KV_MODES = [(False, 8), (True, 8), (True, 4)]

# wire format against the reference: fp32 leaves (K/V pools, scale pools)
# differ by the packages' matmul order only (2.4e-7 measured); codes were
# equal in every mode, a tie one apart is allowed twice
WIRE_ATOL, WIRE_RTOL, WIRE_TIES, MARGIN_TOL = 1e-6, 1e-5, 2, 1e-5


def _prompts(n, rng=None, lo=4, hi=10):
    rng = rng or np.random.default_rng(0)
    return [rng.integers(0, ARCH.vocab, (int(rng.integers(lo, hi)),)).astype(np.int32)
            for _ in range(n)]


def _engine(arch=ARCH, params=PARAMS, **kw):
    return PagedServeEngine(arch, params, **{**GEOM, "device": "cpu", **kw})


def _cfg(**kw):
    return ReplicaConfig(**{"arch": "yi-6b", "reduced": True, "device": "cpu", **GEOM, **kw})


def _fleet(n=2, **kw):
    return [InProcessReplica(c, params=PARAMS) for c in make_cluster_configs(_cfg(**kw),
                                                                             replicas=n)]


def _want(prompts, max_new, **kw):
    return _engine(**kw).generate([p.tolist() for p in prompts], max_new=max_new)


# -- the wire format against the reference ---------------------------------------


@pytest.fixture(scope="module")
def jax_payloads():
    """JAX's ``prefill_handoff`` payload of one 7-token prompt per KV mode."""
    out = {}
    for kv_quant, kv_bits in KV_MODES:
        e = JPagedServeEngine(JARCH, JPARAMS, kv_quant=kv_quant, kv_bits=kv_bits, **GEOM)
        out[kv_quant, kv_bits] = e.prefill_handoff(
            JRequest(uid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=4))
    return out


def _code_diffs(a: np.ndarray, b: np.ndarray, kv_bits: int) -> np.ndarray:
    """Per-code differences of two code leaves (int4: both nibbles of a byte)."""
    if kv_bits == 4:
        a = np.stack([a & 15, a >> 4]).astype(np.int16)
        b = np.stack([b & 15, b >> 4]).astype(np.int16)
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


@pytest.mark.parametrize("kv_quant,kv_bits", KV_MODES)
def test_wire_format_matches_reference(jax_payloads, kv_quant, kv_bits):
    """The port's payload is the reference's, key by key: storage width (fp32
    pools as fp32, int8 codes as int8, packed int4 as uint8, scales as fp32),
    the same geometry fields, the first token and its margin."""
    jp = jax_payloads[kv_quant, kv_bits]
    e = _engine(kv_quant=kv_quant, kv_bits=kv_bits)
    pp = e.prefill_handoff(Request(uid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=4))
    jkv, kv = jp["kv"], pp["kv"]
    for field in ("tokens", "n_blocks", "block_size", "kv_quant", "kv_bits"):
        assert kv[field] == jkv[field], field
    assert kv["tokens"] == 7 and kv["n_blocks"] == 2
    assert sorted(kv["leaves"]) == sorted(jkv["leaves"])
    ties = 0
    for key, want in jkv["leaves"].items():
        want, got = np.asarray(want), kv["leaves"][key]
        assert isinstance(got, np.ndarray)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
        assert kv["dtypes"][key] == str(want.dtype)
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, atol=WIRE_ATOL, rtol=WIRE_RTOL, err_msg=key)
        else:
            d = _code_diffs(got, want, kv_bits)
            assert d.max() <= 1, key
            ties += int((d > 0).sum())
    assert ties <= WIRE_TIES
    assert pp["first_token"] == jp["first_token"]
    assert abs(pp["margin"] - jp["margin"]) <= MARGIN_TOL
    bytes_out = sum(a.nbytes for a in kv["leaves"].values())
    assert e.cache.migration_bytes_out == bytes_out == \
        kv["n_blocks"] * e.cache.block_size * e.cache.kv_bytes_per_token()
    assert e.cache.migrated_blocks_out == 2
    # JAX's leaves (numpy at the same widths) import into the port's cache
    dec = _engine(kv_quant=kv_quant, kv_bits=kv_bits)
    dec.cache.import_blocks(0, {**jax.tree.map(np.asarray, jkv), "dtypes": kv["dtypes"]})
    assert dec.cache.lens[0] == 7 and dec.cache.migrated_blocks_in == 2


# -- bf16, import validation, the handoff ------------------------------------------

BF16 = dataclasses.replace(ARCH, compute_dtype="bfloat16")


def test_bf16_round_trip_bits_tokens_and_dtype_skew():
    """A bf16 pool ships as its bits in uint16 with ``bfloat16`` recorded;
    the bits import bit for bit (an export of the adopted slot returns them),
    a decode engine that adopts them is token-identical to local admission,
    and a dtype skew raises."""
    prompts = _prompts(3, np.random.default_rng(11))
    want = _engine(BF16).generate([p.tolist() for p in prompts], max_new=5)
    pre, dec = _engine(BF16), _engine(BF16)
    reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    payloads = [handoff_local(pre, dec, r) for r in reqs]
    kv = payloads[0]["kv"]
    assert all(a.dtype == np.uint16 for a in kv["leaves"].values())
    assert set(kv["dtypes"].values()) == {"bfloat16"}
    probe = _engine(BF16)
    probe.cache.import_blocks(1, kv)
    probe.cache.lens[1] = kv["tokens"]
    back = probe.cache.export_blocks(1)
    for key, bits in kv["leaves"].items():
        assert np.array_equal(back["leaves"][key], bits), key
    while not dec.sched.idle():
        dec.step()
    assert [r.generated for r in reqs] == want
    assert dec.stats["prefill_tokens"] == 0
    with pytest.raises(ValueError, match="migration leaf mismatch"):
        _engine().cache.import_blocks(0, kv)  # bf16 bits into fp32 pools
    skew = copy.deepcopy(kv)
    skew["dtypes"] = {k: "float16" for k in kv["dtypes"]}
    with pytest.raises(ValueError, match="migration leaf mismatch"):
        _engine(BF16).cache.import_blocks(0, skew)
    short = copy.deepcopy(kv)
    short["leaves"] = {k: v[..., :1] for k, v in kv["leaves"].items()}
    with pytest.raises(ValueError, match="migration leaf mismatch"):
        _engine(BF16).cache.import_blocks(0, short)
    extra = copy.deepcopy(kv)
    extra["leaves"]["['9']['attn']['kp']"] = kv["leaves"]["['0']['attn']['kp']"]
    with pytest.raises(ValueError, match="unknown here"):
        _engine(BF16).cache.import_blocks(0, extra)


def test_import_blocks_validates_geometry():
    eng = _engine()
    payload = eng.prefill_handoff(Request(uid=0, prompt=np.arange(1, 8, dtype=np.int32),
                                          max_new=4))
    req2 = Request(uid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=4)
    with pytest.raises(ValueError, match="block_size"):
        _engine(block_size=8).submit_handoff(req2, payload)
    with pytest.raises(ValueError, match="kv_quant"):
        _engine(kv_quant=True).submit_handoff(req2, payload)
    with pytest.raises(ValueError, match="covers 7 tokens"):
        _engine().submit_handoff(Request(uid=1, prompt=np.arange(1, 6), max_new=4), payload)
    with pytest.raises(ValueError, match="geometry mismatch: kv_bits"):
        _engine(kv_quant=True, kv_bits=8).cache.import_blocks(
            0, {**_engine(kv_quant=True, kv_bits=4).prefill_handoff(
                Request(uid=0, prompt=np.arange(1, 8), max_new=4))["kv"]})


def test_prefill_handoff_releases_its_slot_even_when_it_raises():
    """The borrowed slot goes back, blocks and all, and ``prefilled`` resets,
    whether the export succeeds or the prefill raises."""
    eng = _engine()
    free = eng.cache.free_blocks
    req = Request(uid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new=4)
    eng.prefill_handoff(req)
    assert req.prefilled == 0 and eng.cache.free_blocks == free
    assert eng.sched.slots == [None, None] and eng.sched.idle()

    def boom(*a, **k):
        raise RuntimeError("prefill failed")

    eng._prefill_fn = boom
    with pytest.raises(RuntimeError, match="prefill failed"):
        eng.prefill_handoff(req)
    assert req.prefilled == 0 and eng.cache.free_blocks == free
    assert eng.sched.slots == [None, None]


def test_migration_needs_a_fully_paged_cache():
    eng = build_engine(_cfg(arch="h2o-danube-1.8b"))  # sliding-window rings
    assert not eng.cache.fully_paged
    with pytest.raises(ValueError, match="fully paged"):
        eng.prefill_handoff(Request(uid=0, prompt=np.arange(1, 8), max_new=4))


@pytest.mark.parametrize("kv_quant,kv_bits", KV_MODES)
def test_handoff_local_token_identical(kv_quant, kv_bits):
    """Prefill -> migrate -> decode is token-identical to the same engine
    configuration admitting locally: migration moves the stored codes, with
    no re-quantization; the snapshot carries the migration counters."""
    prompts = _prompts(3, np.random.default_rng(1))
    kw = dict(kv_quant=kv_quant, kv_bits=kv_bits)
    want = _want(prompts, 5, **kw)
    pre, dec = _engine(**kw), _engine(**kw)
    reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        handoff_local(pre, dec, r)
    while not dec.sched.idle():
        dec.step()
    assert [r.generated for r in reqs] == want
    assert dec.cache.migrated_blocks_in == pre.cache.migrated_blocks_out > 0
    assert dec.cache.migration_bytes_in == pre.cache.migration_bytes_out > 0
    snap = dec.metrics_snapshot()
    assert snap["kv_migrated_blocks_in"]["value"] == dec.cache.migrated_blocks_in
    assert snap["kv_migration_bytes_in"]["value"] == dec.cache.migration_bytes_in
    assert pre.metrics_snapshot()["kv_migrated_blocks_out"]["value"] > 0


def test_import_is_in_place_and_the_megastep_adopts():
    """The import writes every pool in place (each pool leaf's ``data_ptr``
    kept; one ``pool_rebuilds`` a handoff), and a ``decode_steps=4`` engine
    that adopts handoffs gives the tokens and margins of one that admitted
    the requests locally."""
    prompts = _prompts(3, np.random.default_rng(12))
    local = _engine(decode_steps=4)
    want = local.generate([p.tolist() for p in prompts], max_new=6)
    pre, dec = _engine(), _engine(decode_steps=4)
    ptrs = [leaf.data_ptr() for leaf in dec.cache._leaves(pools=True)]
    reqs = [Request(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        handoff_local(pre, dec, r)
    while not dec.sched.idle():
        dec.step()
    assert [leaf.data_ptr() for leaf in dec.cache._leaves(pools=True)] == ptrs
    assert dec.cache.pool_rebuilds == len(prompts)
    assert [r.generated for r in reqs] == want
    assert [r.margins for r in reqs] == [r.margins for r in local.last_requests]


def test_spec_engine_adopts_a_handoff():
    """``_admit_handoff`` runs the ``_on_admitted`` hook: a speculative engine
    that adopts handoffs drafts from them, token-identical to local."""
    prompts = _prompts(2, np.random.default_rng(13))
    want = SpecServeEngine(ARCH, PARAMS, spec_k=2, device="cpu", **GEOM).generate(
        [p.tolist() for p in prompts], max_new=5)
    pre = _engine()
    dec = SpecServeEngine(ARCH, PARAMS, spec_k=2, device="cpu", **GEOM)
    reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r in reqs:
        handoff_local(pre, dec, r)
    while not dec.sched.idle():
        dec.step()
    assert [r.generated for r in reqs] == want
    assert dec.spec_stats["rounds"] > 0


# -- the routed fleet: parity, balance, stickiness, backpressure --------------------


def test_two_replica_routed_parity_and_balance():
    prompts = _prompts(6, np.random.default_rng(2))
    router = Router(_fleet(2), policy="least-loaded")
    rids = [router.submit(p, max_new=4) for p in prompts]
    res = router.drain()
    assert [res[r] for r in rids] == _want(prompts, 4)
    dispatched = {n: st.dispatched for n, st in router.states.items()}
    assert all(v > 0 for v in dispatched.values()), dispatched
    router.close()


def test_sticky_prefix_routing():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, ARCH.vocab, (4,)).astype(np.int32)  # one block
    group = [np.concatenate([shared, rng.integers(0, ARCH.vocab, (3,)).astype(np.int32)])
             for _ in range(3)]
    router = Router(_fleet(2, prefix_share=True), policy="least-loaded", sticky=True)
    for p in group:
        router.submit(p, max_new=3)
    router.drain()
    assert router._sticky.get(tuple(int(t) for t in shared)) in router.states
    counts = {n: st.dispatched for n, st in router.states.items()}
    assert max(counts.values()) == len(group), counts  # all three on one replica
    router.close()


def test_backpressure_never_overcommits():
    handles = _fleet(2, num_blocks=12, max_seq=32)
    router = Router(handles, policy="least-loaded")
    for p in _prompts(8, np.random.default_rng(4), lo=4, hi=8):
        router.submit(p, max_new=4)
    peak = {h.name: 0 for h in handles}

    def watch(r, step):
        for name, st in r.states.items():
            assert st.committed <= st.capacity, (name, st.committed, st.capacity)
            peak[name] = max(peak[name], st.committed)

    res = router.drain(on_step=watch)
    assert all(len(v) == 4 for v in res.values())
    assert max(peak.values()) > 0
    router.close()


def test_oversized_request_fails_loudly():
    router = Router(_fleet(1, num_blocks=8, max_seq=64))
    router.submit(np.arange(1, 40, dtype=np.int32), max_new=8)  # > whole pool
    with pytest.raises(RuntimeError, match="never be served"):
        router.drain()
    router.close()


def test_weighted_latency_policy_prefers_faster_replica():
    def state(name, committed, tok_s=None):
        st = _ReplicaState(SimpleNamespace(name=name, cfg=SimpleNamespace(role="both")))
        st.hello = {"num_blocks": 33, "block_size": 4}
        st.committed = committed
        if tok_s is not None:
            st.hb = {"ewma_decode_tok_s": tok_s}
        return st

    router = Router.__new__(Router)  # policy math only; no fleet
    router.policy = "weighted-latency"
    fast, slow = state("fast", 10, 100.0), state("slow", 10, 10.0)
    assert router._score(fast) < router._score(slow)
    fast.committed, slow.committed = 30, 1
    assert router._score(slow) < router._score(fast)
    assert router._score(state("b", 2)) < router._score(state("a", 5))  # cold: least-loaded


# -- failover ---------------------------------------------------------------------


def test_kill_mid_wave_requeues_and_streams_exactly_once():
    prompts = _prompts(6, np.random.default_rng(5))
    router = Router(_fleet(2), policy="least-loaded", heartbeat_timeout=5.0)
    rids = [router.submit(p, max_new=5) for p in prompts]
    state = {"killed": False}

    def chaos(r, step):
        if not state["killed"] and sum(len(q.emitted) for q in r.reqs.values()) >= 3:
            r.kill(max(r.states.values(), key=lambda st: len(st.inflight)).name)
            state["killed"] = True

    res = router.drain(on_step=chaos)
    assert state["killed"] and router.deaths == 1 and router.requeues >= 1
    assert [res[r] for r in rids] == _want(prompts, 5)  # exact: no duplicate, no gap
    router.close()


class _SilentHandle:
    transport = "inproc"

    def __init__(self, name):
        self.name = name
        self.cfg = SimpleNamespace(role="both")
        self.sent = []

    def send(self, cmd):
        self.sent.append(cmd)

    def poll(self):
        return []

    def pump(self):
        return False

    def alive(self):
        return True  # only the heartbeat timeout can catch it

    def kill(self):
        pass

    def close(self):
        pass


def test_heartbeat_timeout_detects_silent_replica():
    t = {"now": 0.0}
    router = Router([_SilentHandle("mute")], heartbeat_timeout=2.0, clock=lambda: t["now"])
    st = router.states["mute"]
    st.hello = {"num_blocks": 33, "block_size": 4, "batch": 2}
    st.last_seen = 0.0
    r1 = router.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    r2 = router.submit(np.arange(2, 7, dtype=np.int32), max_new=3)
    router.step(now=1.0)
    assert set(st.inflight) == {r1, r2}
    router.step(now=1.5)
    assert st.alive
    router.step(now=4.0)  # past last_seen + timeout
    assert not st.alive and router.deaths == 1 and router.requeues == 2
    assert [c.rid for c in router.queue] == [r1, r2]  # front, original order
    assert st.committed == 0 and not st.inflight


# -- disaggregation through the router ------------------------------------------------


def test_parse_disagg():
    assert parse_disagg("1:2") == (1, 2)
    for bad in ("3", "0:2", "a:b"):
        with pytest.raises(ValueError):
            parse_disagg(bad)


def test_disagg_fleet_routed_parity():
    """1 prefill + 1 decode replica: token-identical to one engine, the blocks
    migrated, the decode replica prefilling no prompt token."""
    handles = [InProcessReplica(c, params=PARAMS)
               for c in make_cluster_configs(_cfg(), disagg=(1, 1))]
    router = Router(handles, policy="least-loaded")
    prompts = _prompts(4, np.random.default_rng(6))
    rids = [router.submit(p, max_new=4) for p in prompts]
    res = router.drain()
    assert [res[r] for r in rids] == _want(prompts, 4)
    stats = router.collect_stats()
    assert stats["p0"]["migrated_blocks_out"] > 0
    assert stats["d0"]["migrated_blocks_in"] == stats["p0"]["migrated_blocks_out"]
    assert stats["d0"]["migration_bytes_in"] == stats["p0"]["migration_bytes_out"]
    assert stats["d0"]["throughput"]["prefill_tokens"] == 0
    fleet = router.fleet_metrics(stats)
    assert fleet["requests_completed"] == len(prompts)
    assert fleet["fleet"]["kv_migration_bytes_in"]["value"] == \
        stats["d0"]["migration_bytes_in"]
    router.close()


def test_disagg_decode_death_reuses_handoff():
    """A decode replica dies holding adopted requests: the router dispatches
    the retained payload again, the prompt is never prefilled twice."""
    handles = [InProcessReplica(c, params=PARAMS)
               for c in make_cluster_configs(_cfg(), disagg=(1, 2))]
    router = Router(handles, policy="least-loaded")
    prompts = _prompts(4, np.random.default_rng(7))
    rids = [router.submit(p, max_new=5) for p in prompts]
    state = {"killed": False}

    def chaos(r, step):
        for st in r.states.values():
            if not state["killed"] and st.role == "decode" and st.alive and st.inflight:
                r.kill(st.name)
                state["killed"] = True

    res = router.drain(on_step=chaos)
    assert state["killed"] and router.requeues >= 1
    assert [res[r] for r in rids] == _want(prompts, 5)
    assert router.collect_stats()["p0"]["served"] == len(prompts)  # one prefill each
    router.close()


def test_build_engine_variants():
    """``ReplicaConfig`` reaches every engine flag; without params a replica
    draws them from its seed on its device, as the launcher does."""
    e1 = build_engine(_cfg(decode_steps=4), params=PARAMS)
    assert e1.decode_steps == 4 and e1.device.type == "cpu"
    e2 = build_engine(_cfg(kv_quant=True, kv_bits=4), params=PARAMS)
    assert e2.cache.kv_quant and e2.cache.kv_bits == 4
    assert isinstance(build_engine(_cfg(spec_k=2), params=PARAMS), SpecServeEngine)
    e4 = build_engine(_cfg(int_forward=True))
    assert e4.rt.int_forward and "q8" in e4.params["head"]
    a, b = build_engine(_cfg(seed=3)), build_engine(_cfg(seed=3))
    assert torch.equal(a.params["embed"]["table"], b.params["embed"]["table"])
    assert torch.equal(a.params["head"]["v"], b.params["head"]["v"])
    with pytest.raises(ValueError, match="role"):
        _cfg(role="leader")


# -- the router against the reference's router ------------------------------------


def _tok(rid: int, i: int) -> int:
    return (7 * rid + 3 * i + 1) % 50


class _Scripted:
    """A replica handle whose events follow from its commands alone: one
    handoff a pump (prefill role), one more token a pump for each live
    request (up to ``batch``), a heartbeat with a fixed decode EWMA a pump;
    a killed handle goes silent (``alive()`` False), a muted one goes silent
    but claims to live (only the heartbeat timeout finds it)."""

    transport = "inproc"

    def __init__(self, name, role, ewma, num_blocks=17, batch=2):
        self.name, self.cfg, self.ewma, self.batch = name, SimpleNamespace(role=role), ewma, batch
        self.sent: list = []
        self._out = [{"type": "hello", "name": name, "role": role, "num_blocks": num_blocks,
                      "block_size": 4, "batch": batch}]
        self._seen = 0
        self._prefills: list = []
        self._live: dict = {}  # rid -> (generated, max_new)
        self.dead = self.muted = False

    def send(self, cmd):
        self.sent.append(copy.deepcopy(cmd))

    def pump(self):
        if self.dead or self.muted:
            return False
        for cmd in self.sent[self._seen:]:
            if cmd["op"] == "prefill":
                self._prefills.append(cmd)
            elif cmd["op"] in ("submit", "adopt"):
                first = [cmd["payload"]["first_token"]] if cmd["op"] == "adopt" else []
                self._live[cmd["rid"]] = (first, cmd["max_new"])
            elif cmd["op"] == "stats":
                self._out.append({"type": "stats", "name": self.name, "served": 0,
                                  "throughput": {}, "metrics": {}})
        self._seen = len(self.sent)
        if self._prefills:
            cmd = self._prefills.pop(0)
            self._out.append({"type": "handoff", "rid": cmd["rid"], "payload": {
                "kv": {"tokens": len(cmd["prompt"])}, "first_token": _tok(cmd["rid"], 0),
                "margin": 1.0}})
        for rid in sorted(self._live)[:self.batch]:
            gen, max_new = self._live[rid]
            gen.append(_tok(rid, len(gen)))
            done = len(gen) >= max_new
            self._out.append({"type": "progress", "rid": rid, "tokens": list(gen),
                              "done": done})
            if done:
                del self._live[rid]
        self._out.append({"type": "heartbeat", "name": self.name, "ewma_decode_tok_s": self.ewma})
        return True

    def poll(self):
        out, self._out = self._out, []
        return out

    def alive(self):
        return not self.dead

    def kill(self):
        self.dead = True

    def close(self):
        pass


ROUTER_CASES = {
    # name: (roles and decode EWMAs, policy, fault: (step, handle, "kill"|"mute"))
    "least-loaded kill": ((("r0", "both", 0.0), ("r1", "both", 0.0), ("r2", "both", 0.0)),
                          "least-loaded", (6, "r1", "kill")),
    "weighted-latency mute": ((("r0", "both", 50.0), ("r1", "both", 10.0)),
                              "weighted-latency", (5, "r0", "mute")),
    "disagg 1:2 decode kill": ((("p0", "prefill", 0.0), ("d0", "decode", 40.0),
                                ("d1", "decode", 20.0)), "weighted-latency", (8, "d0", "kill")),
}


def _drive(router_cls, case):
    roles, policy, (at, victim, how) = ROUTER_CASES[case]
    handles = [_Scripted(n, role, ew) for n, role, ew in roles]
    t = {"now": 0.0}
    router = router_cls(handles, policy=policy, heartbeat_timeout=1.0, clock=lambda: t["now"])
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 50, (4,))
    for i in range(10):  # sticky pairs, long and short prompts, one over budget for a while
        n = 30 if i % 4 == 3 else int(rng.integers(3, 9))
        head = shared if i % 3 == 0 else rng.integers(1, 50, (4,))
        router.submit(np.concatenate([head, rng.integers(1, 50, (n,))]), max_new=3 + i % 3)
    steps = 0
    while router.outstanding() and steps < 200:
        t["now"] += 0.25
        router.step()
        steps += 1
        if steps == at:
            h = next(h for h in handles if h.name == victim)
            setattr(h, "dead" if how == "kill" else "muted", True)
    return router, handles, steps


@pytest.mark.parametrize("case", list(ROUTER_CASES))
def test_router_matches_reference_router(case):
    """The same scripted events through both routers: the same commands to
    every handle, the same streams, requeues, deaths and dispatch counts."""
    jr, jh, jsteps = _drive(JRouter, case)
    pr, ph, psteps = _drive(Router, case)
    assert psteps == jsteps < 200 and not pr.outstanding()
    for a, b in zip(jh, ph):
        assert b.sent == a.sent, b.name
    assert pr.results() == jr.results()
    assert (pr.requeues, pr.deaths) == (jr.requeues, jr.deaths)
    assert pr.deaths == 1 and pr.requeues > 0
    assert {n: s.dispatched for n, s in pr.states.items()} == \
        {n: s.dispatched for n, s in jr.states.items()}
    assert pr._sticky == jr._sticky


# -- the spawn transport and the launcher ------------------------------------------


def test_subprocess_transport_matches_a_local_engine(monkeypatch):
    """Two spawned replica processes on the CPU behind the router: the
    protocol crosses a ``multiprocessing.Pipe``, each child draws its params
    from the seed, and the output equals a local engine's on those params.
    The wave starts once both children said hello (``await_fleet``), so
    both serve; each stats event carries its process's launch counts (all
    0: a CPU tensor takes the plain versions) and its served requests."""
    from repro_torch.kernels.ops import launch_counts

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfgs = make_cluster_configs(_cfg(), replicas=2)
    handles = [SubprocessReplica(c) for c in cfgs]
    router = Router(handles, policy="least-loaded", heartbeat_timeout=300.0)
    try:
        serve_cluster.await_fleet(router, 120.0)
        prompts = _prompts(3, np.random.default_rng(8))
        rids = [router.submit(p, max_new=3) for p in prompts]
        res = router.drain(idle_timeout_s=120.0)
        local = build_engine(_cfg())
        want = local.generate([p.tolist() for p in prompts], max_new=3)
        assert [res[r] for r in rids] == want
        assert router.deaths == 0
        dispatched = {n: st.dispatched for n, st in router.states.items()}
        assert all(v > 0 for v in dispatched.values()), dispatched
        stats = router.collect_stats()
        for name, ev in stats.items():
            assert ev["served"] == dispatched[name]
            assert ev["launches"] == dict.fromkeys(launch_counts(), 0)
    finally:
        router.close()
    assert not any(h.proc.is_alive() for h in handles)


def test_stats_event_carries_extra_fields_as_they_stand():
    """``Replica(stats_extra=)``: a harness's own counts ride in every stats
    event, read when the event is sent."""
    from repro_torch.serve.cluster.replica import LocalMailbox, Replica

    held = {"matrices": 0}
    box = LocalMailbox()
    rep = Replica(_cfg(), box, engine=_engine(), stats_extra={"held": held})
    held["matrices"] = 3
    box.send_command({"op": "stats"})
    rep.pump()
    ev = [e for e in box.recv_events() if e["type"] == "stats"][0]
    assert ev["held"] == {"matrices": 3} and "launches" in ev and ev["served"] == 0


def test_launcher_disagg_parity_and_report():
    """``serve_cluster.main`` on the CPU: a 1:1 disaggregated fleet, parity
    with one engine, the reference launcher's report keys."""
    rep = serve_cluster.main(["--arch", "yi-6b", "--reduced", "--device", "cpu",
                              "--disagg", "1:1", "--parity-check", "--requests", "4",
                              "--max-new", "4"])
    keys = {"replicas", "roles", "policy", "transport", "requests", "dispatched", "completed",
            "requeues", "deaths", "killed", "migrated_blocks", "per_replica", "served",
            "total_tokens", "busy_s", "makespan_s", "agg_tok_s", "latency",
            "fleet_requests_completed", "parity"}
    assert keys <= set(rep)
    assert rep["parity"] is True and rep["completed"] == 4 and rep["migrated_blocks"] > 0
    assert rep["roles"] == {"p0": "prefill", "d0": "decode"}
    with pytest.raises(SystemExit):
        serve_cluster.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--kv-bits", "4"])
