"""Observability in the port: span tracing, the metrics registry, the
accumulator-headroom probe and telemetry, against ``repro.obs`` and the
reference's engines.

The port's own units: span nesting (child before parent), the disabled
tracer's null span, the Chrome export schema, ``clear``, the nearest-rank
percentile, the snapshot/load round trip, the type-mismatch error, the
fleet merge's associativity and commutativity, and the probe's witness
(all-ones ``q8 (32, 4)``, x = 4 -> ``acc_max`` 128 against the 16-bit bound
32767) in each branch of the fused path, with no probe scope left open.

Against JAX (params from the JAX init through ``from_jax_numpy``; reduced
yi-6b, the reference's ``KW``; the JAX engines on the float path, so their
side runs jnp only; the probe's forward goes through the reference's int
path, its int matmuls in the Pallas interpreter):

* the same operations into both registries give equal snapshots;
* ``static_headroom_report`` of the same deployed tree is equal record for
  record (``l1_max`` and ``l1_budget`` exactly, ``utilization`` to 1e-12),
  rwkv6's unsigned ``cm.wv`` included;
* every probe record the reference yields on the same tokens (its scanned
  stacks record only the unstacked ``head``) has an equal record in the
  port's list, under plain ``int_forward`` and under ``int_chain``, and
  every port record lies within its bound;
* a traced engine gives the reference's sequence of ``(ph, name, args)``
  events (timestamps left out, args compared after a JSON round trip):
  the contiguous engine, the paged engine per tick, on the megastep with
  prefix sharing, in lockstep, and the speculative engine;
* ``metrics_snapshot()`` has the reference's keys, less the counters of
  what the port's cache does not have (``bt_full_uploads`` /
  ``bt_row_patches``: the port uploads its block tables whole with each
  call's inputs, no device-resident table is patched), with equal values
  for every count (the ``migrat*`` counters included); times and throughputs are left out (wall clock), and so are the
  ``jit_cache_size`` values (the reference counts jit compiles, the port
  CUDA-graph captures: 0 on the CPU);
* ``engine_headroom`` finds 0 violations in both.

Port-only engine gates: traced tokens equal untraced ones and no span opens
inside the decode window; an untraced engine records no events but fills
the latency histograms; ``reset_stats`` clears everything; the snapshot
agrees with ``stats`` and the cache and merges into a fleet view.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Obs as JObs
from repro.obs.headroom import engine_headroom as jengine_headroom
from repro.obs.headroom import observed_headroom as jobserved_headroom
from repro.obs.headroom import static_headroom_report as jstatic_headroom_report
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import deploy_params as jdeploy_params
from repro.serve.spec import SpecServeEngine as JSpecServeEngine

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime
from repro_torch.nn import linear as plinear
from repro_torch.nn.linear import IntAct, acc_probe_scope, apply_linear
from repro_torch.obs import (
    NULL_SPAN, MetricsRegistry, Obs, Tracer, merge_snapshots, percentile,
)
from repro_torch.obs.headroom import engine_headroom, observed_headroom, static_headroom_report
from repro_torch.serve.engine import PagedServeEngine, ServeEngine
from repro_torch.serve.spec import SpecServeEngine

torch.set_num_threads(1)

KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4)
MAX_NEW = 4

# -- tracer ------------------------------------------------------------------


def test_span_nesting_child_before_parent():
    tr = Tracer()
    with tr.span("parent"):
        with tr.span("child"):
            pass
    assert [name for _, name, _, _, _ in tr.events] == ["child", "parent"]
    child, parent = tr.spans("child")[0], tr.spans("parent")[0]
    assert parent[1] <= child[1]
    assert child[1] + child[2] <= parent[1] + parent[2] + 1e-9


def test_disabled_tracer_is_null_span_identity():
    tr = Tracer(enabled=False)
    s1, s2 = tr.span("a", {"k": 1}), tr.span("b")
    assert s1 is NULL_SPAN and s2 is NULL_SPAN
    with s1:
        pass
    tr.instant("i", {"x": 2})
    assert tr.events == [] and s1.dur_s == 0.0


def test_chrome_export_schema(tmp_path):
    tr = Tracer(pid=3, tid=7)
    with tr.span("outer", {"uid": 1}):
        tr.instant("mark")
    path = tmp_path / "trace.json"
    tr.export(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    by_ph = {e["ph"]: e for e in evs}
    assert len(evs) == 2 and set(by_ph) == {"X", "i"}
    x, i = by_ph["X"], by_ph["i"]
    assert x["name"] == "outer" and x["args"] == {"uid": 1}
    assert x["dur"] >= 0 and x["ts"] >= 0
    assert i["s"] == "t" and "dur" not in i and "args" not in i
    assert all(e["pid"] == 3 and e["tid"] == 7 for e in evs)


def test_tracer_clear_resets_origin_and_events():
    tr = Tracer()
    tr.instant("before")
    tr.clear()
    assert tr.events == []
    tr.instant("after")
    assert 0 <= tr.to_chrome()["traceEvents"][0]["ts"] < 1e6


# -- metrics -----------------------------------------------------------------


def test_percentile_nearest_rank():
    assert percentile([], 99) == 0.0
    assert percentile([5.0], 50) == 5.0
    vals = [1.0, 2.0, 3.0, 4.0]
    assert [percentile(vals, q) for q in (50, 75, 99)] == [2.0, 3.0, 4.0]
    assert percentile([4.0, 1.0, 3.0, 2.0], 50) == 2.0


def test_registry_snapshot_and_load_roundtrip():
    m = MetricsRegistry()
    m.counter("c", {"k": "v"}).inc(3)
    m.gauge("g").set(1.5)
    m.histogram("h").observe(2.0)
    m.histogram("h").observe(4.0)
    snap = m.snapshot()
    assert snap["c{k=v}"] == {"type": "counter", "value": 3}
    assert snap["g"] == {"type": "gauge", "value": 1.5}
    assert snap["h"]["values"] == [2.0, 4.0]
    m2 = MetricsRegistry()
    m2.load(snap)
    assert m2.snapshot() == snap and m2.histogram("h").percentile(99) == 4.0


def test_registry_type_mismatch_raises():
    m = MetricsRegistry()
    m.counter("x")
    with pytest.raises(TypeError, match="already registered as Counter"):
        m.gauge("x")
    with pytest.raises(TypeError, match="merged across types"):
        merge_snapshots({"y": {"type": "counter", "value": 1.0}},
                        {"y": {"type": "gauge", "value": 1.0}})


def test_merge_snapshots_associative_and_commutative():
    def mk(c, g, h):
        m = MetricsRegistry()
        m.counter("reqs").inc(c)
        m.gauge("peak").set(g)
        for v in h:
            m.histogram("lat").observe(v)
        return m.snapshot()

    a, b, c = mk(1, 5.0, [1.0]), mk(2, 3.0, [2.0, 9.0]), mk(4, 7.0, [0.5])
    ab_c = merge_snapshots(merge_snapshots(a, b), c)
    a_bc = merge_snapshots(a, merge_snapshots(b, c))

    def canon(s):
        return {k: (sorted(v["values"]) if "values" in v else v["value"]) for k, v in s.items()}

    assert canon(ab_c) == canon(a_bc) == canon(merge_snapshots(c, b, a))
    assert canon(merge_snapshots(a, b)) == canon(merge_snapshots(b, a))
    assert ab_c["reqs"]["value"] == 7 and ab_c["peak"]["value"] == 7.0
    assert sorted(ab_c["lat"]["values"]) == [0.5, 1.0, 2.0, 9.0]


def test_registry_snapshot_matches_jax():
    """The same operations into both registries give equal snapshots, and
    both merge the same."""
    def drive(m):
        m.counter("serve_decode_tokens").inc(3)
        m.counter("serve_decode_tokens").inc(2.5)
        m.counter("kv_cow_copies").set(4)
        m.gauge("acc_bound", {"site": "head"}).set(32767)
        m.gauge("jit_cache_size", {"fn": "megadecode"}).set(1)
        for v in (0.25, 0.5, 0.125):
            m.histogram("request_latency_s").observe(v)
        return m.snapshot()

    port, ref = drive(MetricsRegistry()), drive(JMetricsRegistry())
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    from repro.obs import merge_snapshots as jmerge

    assert merge_snapshots(port, port) == jmerge(ref, ref)


# -- accumulator-headroom probe ------------------------------------------------


WITNESS_CFG = QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16)


@pytest.mark.parametrize("branch", ["standalone", "int_chain", "int_act", "int_act_u8"])
def test_acc_probe_pow2_witness(branch):
    """q8 all ones (32, 4), unit scales, every input code 4: each output
    accumulator is exactly 32 * 4 = 128 against the 16-bit bound 32767, in
    each branch of the fused path (unsigned 8-bit codes symmetrized)."""
    params = {"q8": torch.ones((32, 4), dtype=torch.int8),
              "s8": torch.ones((4,), dtype=torch.float32),
              "aq": {"log2_scale": torch.zeros((), dtype=torch.float32)}}
    x = torch.full((1, 32), 4.0)
    signed = branch != "int_act_u8"
    if branch.startswith("int_act"):
        codes = torch.full((1, 32), 4 if signed else 4 - 128, dtype=torch.int8)
        x = IntAct(codes=codes, scale=torch.tensor(1.0), bits=8, signed=signed)
    samples = []
    with acc_probe_scope(samples):
        y = apply_linear(params, x, WITNESS_CFG, int_forward=True, input_signed=signed,
                         int_chain=branch == "int_chain", site="witness",
                         compute_dtype=torch.float32)
    assert samples == [{"site": "witness", "acc_max": 128, "acc_bits": 16, "bound": 2**15 - 1,
                        "spill_int16": True, "in_bits": 8, "in_signed": signed}]
    torch.testing.assert_close(y, torch.full((1, 4), 128.0), rtol=0, atol=0)


def test_acc_probe_inactive_without_scope():
    assert plinear._ACTIVE_ACC_PROBE == [], "no probe scope leaks across tests"
    samples = [{"stale": 1}]
    with acc_probe_scope(samples):
        assert plinear._ACTIVE_ACC_PROBE == [samples] and samples == []
    assert plinear._ACTIVE_ACC_PROBE == []


_DEPLOYED = {}


def _deployed(name):
    """The JAX init's deployed params for ``name`` (reduced), as numpy."""
    if name not in _DEPLOYED:
        arch = jreduced(jget_arch(name))
        dep = jdeploy_params(unbox(jinit_lm(jax.random.PRNGKey(0), arch)), arch.quant)
        _DEPLOYED[name] = (arch, jax.tree.map(np.asarray, dep))
    return _DEPLOYED[name]


@pytest.mark.parametrize("name", ["yi-6b", "rwkv6-7b"])
def test_static_headroom_report_matches_jax(name):
    jarch, dep = _deployed(name)
    ref = jstatic_headroom_report(dep, jarch.quant)
    got = static_headroom_report(from_jax_numpy(dep), reduced(get_arch(name)).quant)
    assert len(got) == len(ref) > 0
    by_site = {r["site"]: r for r in got}
    for r in ref:
        g = by_site[r["site"]]
        assert g["l1_max"] == r["l1_max"] and g["l1_budget"] == r["l1_budget"]
        assert abs(g["utilization"] - r["utilization"]) <= 1e-12
        assert (g["acc_bits"], g["in_bits"], g["in_signed"]) == (
            r["acc_bits"], r["in_bits"], r["in_signed"])
        assert 0.0 <= g["utilization"] < 1.0
    if name == "rwkv6-7b":
        assert not by_site["stacks.0.cm.wv"]["in_signed"]


@pytest.mark.parametrize("chain", [False, True], ids=["int_forward", "int_chain"])
def test_probe_records_match_jax(chain):
    jarch, dep = _deployed("yi-6b")
    tokens = np.random.default_rng(3).integers(0, jarch.vocab, (2, 8)).astype(np.int32)
    ref = jobserved_headroom(jarch, dep, rt=JRuntime(int_forward=True, int_chain=chain),
                             tokens=tokens)
    got = observed_headroom(reduced(get_arch("yi-6b")), from_jax_numpy(dep),
                            rt=Runtime(int_forward=True, int_chain=chain), tokens=tokens)
    assert ref and [r["site"] for r in ref] == ["head"]
    for r in ref:
        assert r in got, (r, [g for g in got if g["site"] == r["site"]])
    # the port's stacks are a Python loop: every deployed call records
    assert len(got) == 7 * jarch.n_layers + 1
    assert all(0 < g["acc_max"] <= g["bound"] for g in got)


def test_engine_headroom_zero_violations_on_both():
    jarch, dep = _deployed("yi-6b")
    je = JPagedServeEngine(jarch, jax.tree.map(jnp.asarray, dep),
                           rt=JRuntime(int_forward=True), **KW)
    e = PagedServeEngine(reduced(get_arch("yi-6b")), from_jax_numpy(dep), device="cpu",
                         rt=Runtime(int_forward=True), **KW)
    ref, got = jengine_headroom(je, seq=4), engine_headroom(e, seq=4)
    assert ref["violations"] == got["violations"] == 0
    assert got["layers"] == ref["layers"] and got["util_max"] == pytest.approx(ref["util_max"],
                                                                               abs=1e-12)
    assert 0.0 < got["observed_frac_max"] <= got["util_max"]
    snap = e.obs.metrics.snapshot()
    assert snap["acc_headroom_violations"]["value"] == 0
    assert snap["acc_observed_max{site=head}"]["value"] <= snap["acc_bound{site=head}"]["value"]
    assert {k for k in snap if k.startswith("acc_headroom_utilization{")} == {
        k for k in je.obs.metrics.snapshot() if k.startswith("acc_headroom_utilization{")}


# -- engines against the reference ---------------------------------------------


ENGINE_CASES = ("contiguous", "tick", "megastep_share", "lockstep", "spec")
# the reference's cache counters the port's cache does not keep (see above)
NOT_IN_PORT = {"kv_bt_full_uploads", "kv_bt_row_patches"}
WALL_CLOCK = {"serve_prefill_s", "serve_decode_s", "serve_prefill_tok_s", "serve_decode_tok_s",
              "serve_tok_s"}


def _case_prompts(case, vocab):
    rng = np.random.default_rng(7)
    if case == "megastep_share":
        common = rng.integers(0, vocab, (8,))
        return [np.concatenate([common, rng.integers(0, vocab, (n,))]).astype(np.int32)
                for n in (3, 6, 2)]
    lens = (6, 6, 6, 6) if case == "lockstep" else (5, 9, 3)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _build(case, pkg, arch, params, obs):
    if pkg == "jax":
        paged, contig, spec, extra = JPagedServeEngine, JServeEngine, JSpecServeEngine, {}
    else:
        paged, contig, spec, extra = PagedServeEngine, ServeEngine, SpecServeEngine, {
            "device": "cpu"}
    if case == "contiguous":
        return contig(arch, params, batch=2, max_seq=64, obs=obs, **extra)
    kw = {**KW, **extra, "obs": obs}
    if case == "spec":
        return spec(arch, params, spec_k=2, min_accept=0.0, **kw)
    if case == "megastep_share":
        return paged(arch, params, decode_steps=2, prefix_share=True, **kw)
    return paged(arch, params, lockstep=case == "lockstep", **kw)


def _events(tracer):
    return [(ph, name, json.loads(json.dumps(args))) for ph, name, _, _, args in tracer.events]


def _counts(snap):
    return {k: len(v["values"]) if v["type"] == "histogram" else v["value"]
            for k, v in snap.items() if k not in WALL_CLOCK and not k.startswith("jit_cache_size")}


@pytest.fixture(scope="module")
def engine_runs():
    """Per case: the reference's and the port's traced engine on the same
    prompts (reduced yi-6b from the JAX init, float path): tokens, events
    and metrics snapshot of each."""
    jarch = jreduced(jget_arch("yi-6b"))
    jparams = unbox(jinit_lm(jax.random.PRNGKey(0), jarch))
    arch, params = reduced(get_arch("yi-6b")), from_jax_numpy(jax.tree.map(np.asarray, jparams))
    out = {}
    for case in ENGINE_CASES:
        prompts = _case_prompts(case, arch.vocab)
        runs = {}
        for pkg, a, p in (("jax", jarch, jparams), ("port", arch, params)):
            e = _build(case, pkg, a, p, (JObs if pkg == "jax" else Obs)(trace=True))
            toks = e.generate(prompts, max_new=MAX_NEW)
            runs[pkg] = (toks, _events(e.obs.trace), e.metrics_snapshot())
        out[case] = runs
    return out


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_trace_events_match_jax(engine_runs, case):
    (jtoks, jev, _), (toks, ev, _) = engine_runs[case]["jax"], engine_runs[case]["port"]
    assert toks == jtoks
    assert ev == jev
    names = {name for _, name, _ in ev}
    want = {"contiguous": {"prefill_slot", "decode_tick"},
            "tick": {"block_alloc", "prefill_chunk", "cow_preflight", "decode_tick"},
            "megastep_share": {"radix_lookup", "cow_preflight", "decode_megastep"},
            "lockstep": {"admit_group", "prefill_chunk", "decode_tick"},
            "spec": {"spec_round", "spec_draft", "spec_verify", "cow_preflight"}}[case]
    assert want | {"submit", "emit"} <= names, names


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_metrics_snapshot_matches_jax(engine_runs, case):
    (_, _, jsnap), (_, _, snap) = engine_runs[case]["jax"], engine_runs[case]["port"]
    assert set(snap) == set(jsnap) - NOT_IN_PORT
    assert _counts(snap) == {k: v for k, v in _counts(jsnap).items() if k not in NOT_IN_PORT}
    assert snap["requests_completed"]["value"] == len(_case_prompts(case, 1 << 16))


# -- the port's own engine gates -----------------------------------------------


_YI = {}


def _yi():
    if not _YI:
        jarch = jreduced(jget_arch("yi-6b"))
        _YI["params"] = from_jax_numpy(jax.tree.map(
            np.asarray, unbox(jinit_lm(jax.random.PRNGKey(0), jarch))))
    return reduced(get_arch("yi-6b")), _YI["params"]


@pytest.mark.parametrize("decode_steps", [1, 2])
def test_tracing_is_observation_only(decode_steps):
    """A traced engine gives the untraced one's tokens and margins bit for
    bit, and no event is recorded while a decode window runs."""
    arch, params = _yi()
    prompts = _case_prompts("tick", arch.vocab)
    plain = PagedServeEngine(arch, params, device="cpu", decode_steps=decode_steps, **KW)
    traced = PagedServeEngine(arch, params, device="cpu", decode_steps=decode_steps,
                              obs=Obs(trace=True), **KW)
    inside = []
    window = traced._window

    def watched(inp):
        n = len(traced.obs.trace.events)
        out = window(inp)
        inside.append(len(traced.obs.trace.events) - n)
        return out

    traced._window = watched
    assert traced.generate(prompts, max_new=MAX_NEW) == plain.generate(prompts, max_new=MAX_NEW)
    assert [r.margins for r in traced.last_requests] == [r.margins for r in plain.last_requests]
    assert inside == ([] if decode_steps == 1 else [0] * len(inside)) and (
        decode_steps == 1 or inside)
    tr = traced.obs.trace
    assert len(tr.instants("submit")) == len(tr.instants("emit")) == len(prompts)
    assert all({"uid", "slot", "prompt"} <= set(args) for _, _, _, args in tr.spans("admit"))


def test_untraced_engine_records_no_events_but_fills_latency():
    arch, params = _yi()
    e = PagedServeEngine(arch, params, device="cpu", **KW)
    e.generate(_case_prompts("tick", arch.vocab)[:2], max_new=3)
    assert e.obs.trace.events == []
    m = e.obs.metrics
    assert m.histogram("request_latency_s").count == m.histogram("request_ttft_s").count == 2
    assert all(v > 0 for v in m.histogram("request_latency_s").values)


def test_reset_stats_clears_everything():
    arch, params = _yi()
    e = PagedServeEngine(arch, params, device="cpu", prefix_share=True, obs=Obs(trace=True), **KW)
    e.generate(_case_prompts("megastep_share", arch.vocab), max_new=3)
    assert e.cache.peak_blocks > 0 and e.cache.prefix_hits > 0 and e.obs.trace.events
    e.metrics_snapshot()
    e.reset_stats()
    assert e.stats["decode_tokens"] == 0 and e.obs.trace.events == []
    assert all(v == 0 for v in e.cache.counters().values())
    assert e.obs.metrics.snapshot() == {}


def test_metrics_snapshot_agrees_with_engine_state_and_merges():
    arch, params = _yi()
    rng = np.random.default_rng(1)
    e1 = PagedServeEngine(arch, params, device="cpu", decode_steps=2, **KW)
    e2 = PagedServeEngine(arch, params, device="cpu", **KW)
    e1.generate([rng.integers(0, arch.vocab, (n,)).astype(np.int32) for n in (4, 7)],
                max_new=3)
    e2.generate([rng.integers(0, arch.vocab, (n,)).astype(np.int32) for n in (5, 3, 6)],
                max_new=3)
    s1, s2 = e1.metrics_snapshot(), e2.metrics_snapshot()
    for e, s in ((e1, s1), (e2, s2)):
        for k in ("prefill_tokens", "decode_tokens", "decode_dispatches"):
            assert s[f"serve_{k}"]["value"] == e.stats[k]
        assert s["kv_peak_blocks"]["value"] == e.cache.peak_blocks > 0
        assert s["kv_free_blocks"]["value"] == e.cache.free_blocks
        assert all(s[f"kv_{k}"]["value"] == v for k, v in e.cache.counters().items()
                   if k != "peak_blocks")
        # eager steps; the window is captured only on a CUDA device
        assert [s[f"jit_cache_size{{fn={f}}}"]["value"] for f in
                ("prefill", "decode", "megadecode")] == [0, 0, 0]
    fleet = merge_snapshots(s1, s2)
    assert fleet["requests_completed"]["value"] == 5
    assert fleet["serve_decode_tokens"]["value"] == (
        s1["serve_decode_tokens"]["value"] + s2["serve_decode_tokens"]["value"])
    lat = fleet["request_latency_s"]["values"]
    assert len(lat) == 5 and percentile(lat, 99) == max(lat)
