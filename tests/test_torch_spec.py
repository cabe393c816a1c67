"""Speculative decoding in the port: ``accept_prefix``, the verify step, the
self and model drafters and ``SpecServeEngine``, against the port's plain
paged engine and the JAX package.

Losslessness is the gate: greedy output token-identical to the plain paged
engine of the same configuration on reduced yi-6b, smollm-135m and
deepseek-v3 (the MoE verify runs ``T = 1`` steps with the rows that are not
live at token 0 and position 0, as the plain tick feeds them), on deployed
int8 weights (the int8 self-drafter against the dequant verify), on int8 KV
with the decode kernel's plain version, with a model drafter, through the
full-acceptance bonus path, the adaptive fallback, the headroom guard and
the megastep fallback.  Against JAX (params through ``from_jax_numpy``):
one module-scoped run each of the reference's ``SpecServeEngine`` on
deployed yi-6b with its default int8 self-drafter and with a smollm-135m
model drafter, held under ``parity_up_to_ties`` at eps 1e-4 (fp32 reduced
configs) and with equal ``spec_stats`` where no verify margin lies within
the eps.  Ring (h2o-danube) and recurrent (rwkv6) engines refuse under
``strict`` and otherwise serve plain.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import deploy_params as jdeploy_params
from repro.serve.spec import ModelDrafter as JModelDrafter
from repro.serve.spec import SpecServeEngine as JSpecServeEngine

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.serve.engine import PagedServeEngine, Request, deploy_params, parity_up_to_ties
from repro_torch.serve.paged_cache import TRASH_BLOCK
from repro_torch.serve.sampling import SampleConfig
from repro_torch.serve.spec import ModelDrafter, SelfDrafter, SpecServeEngine, accept_prefix

torch.set_num_threads(1)

EPS = 1e-4
KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4, device="cpu")

_PARAMS = {}


def _arch(name):
    return reduced(get_arch(name))


def _params(name, seed=0, deployed=False):
    key = (name, seed, deployed)
    if key not in _PARAMS:
        arch = _arch(name)
        p = init_lm(torch.Generator().manual_seed(seed), arch, device="cpu")
        _PARAMS[key] = deploy_params(p, arch.quant) if deployed else p
    return _PARAMS[key]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _plain(name, prompts, max_new, params=None, **kw):
    e = PagedServeEngine(_arch(name), params if params is not None else _params(name),
                         **{**KW, **kw})
    return e.generate(prompts, max_new=max_new)


def _drained(e):
    return e.cache.free_blocks == e.cache.num_blocks - 1 and int(e.cache.refcounts.sum()) == 0


def test_accept_prefix_cases():
    assert accept_prefix([3, 5, 7], [3, 5, 7, 9]) == (3, [3, 5, 7, 9])  # bonus
    assert accept_prefix([3, 5, 7], [3, 4, 7, 9]) == (1, [3, 4])  # correction
    assert accept_prefix([3, 5, 7], [2, 5, 7, 9]) == (0, [2])


@pytest.mark.parametrize("name", ["yi-6b", "smollm-135m", "deepseek-v3-671b"])
def test_spec_matches_plain_greedy(name):
    """Mixed prompt lengths through fewer slots than requests: tokens
    identical to the plain engine's, acceptance > 0, every block back and
    every refcount 0 after the drain, per-request acceptance recorded."""
    prompts = _prompts(_arch(name).vocab, (5, 3, 9, 2))
    want = _plain(name, prompts, 6)
    spec = SpecServeEngine(_arch(name), _params(name), spec_k=3, **KW)
    assert spec.generate(prompts, max_new=6) == want
    assert spec.acceptance_rate() > 0 and spec.spec_stats["rounds"] > 0
    assert _drained(spec)
    assert all(r.spec_proposed > 0 for r in spec.last_requests)
    tp = spec.throughput()
    assert tp["decode_tokens"] == spec.spec_stats["emitted"] == sum(len(o) - 1 for o in want)
    assert tp["decode_dispatches"] == 2 * spec.spec_stats["rounds"]


def test_spec_matches_plain_on_deployed_int8_and_int8_kv_kernel():
    """Precision staging: deployed q8/s8 weights drafted on the W8A8 path
    (``int_matmul``'s plain version) and verified on the dequant matmuls;
    then int8 KV pools, drafted through the decode kernel's plain version
    and verified on the gathered dequantized view.  Both token-identical to
    plain decode of the same configuration."""
    params = _params("yi-6b", deployed=True)
    prompts = _prompts(_arch("yi-6b").vocab, (6, 4), seed=1)
    spec = SpecServeEngine(_arch("yi-6b"), params, spec_k=3, **KW)
    assert spec.drafter.rt.int_forward and not spec.rt.int_forward
    assert spec.generate(prompts, max_new=5) == _plain("yi-6b", prompts, 5, params=params)
    assert spec.acceptance_rate() > 0
    prompts = _prompts(_arch("yi-6b").vocab, (10, 7, 4), seed=2)
    kw = dict(block_size=8, prefill_chunk=8, kv_quant=True)
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=2,
                           draft_rt=Runtime(int_forward=True, decode_kernel=True),
                           **{**KW, **kw})
    assert spec.generate(prompts, max_new=5) == _plain("yi-6b", prompts, 5, **kw)


@pytest.mark.parametrize("kind", ["self", "model"])
def test_spec_full_acceptance_bonus_path(kind):
    """Drafting on the verify's own runtime (the engine's params, or a model
    drafter holding the same model) accepts everything: every round emits
    k + 1 tokens (k drafts and the bonus), and the model drafter feeds the
    bonus round's last draft, never consumed, as the next round's delta."""
    arch, params = _arch("smollm-135m"), _params("smollm-135m")
    prompts = _prompts(arch.vocab, (4,), seed=5)
    want = _plain("smollm-135m", prompts, 9, batch=1)
    drafter = SelfDrafter(arch, Runtime()) if kind == "self" else ModelDrafter(
        arch, params, slots=1, max_seq=64, spec_k=4, block_size=4, prefill_chunk=4,
        device="cpu")
    spec = SpecServeEngine(arch, params, spec_k=4, drafter=drafter, **{**KW, "batch": 1})
    assert spec.generate(prompts, max_new=9) == want
    assert spec.acceptance_rate() == 1.0
    assert spec.spec_stats["bonus"] == spec.spec_stats["rounds"] == 2


class _GarbageDrafter(SelfDrafter):
    """Always wrong: proposes (argmax + 1) mod vocab."""

    def propose(self, engine, live, tok_in, k):
        return (super().propose(engine, live, tok_in, k) + 1) % engine.arch.vocab


def test_spec_adaptive_fallback_on_collapsed_acceptance():
    prompts = _prompts(_arch("yi-6b").vocab, (4, 6), seed=6)
    want = _plain("yi-6b", prompts, 10)
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=3,
                           drafter=_GarbageDrafter(_arch("yi-6b"), Runtime()),
                           min_accept=0.5, probe_interval=3, **KW)
    assert spec.generate(prompts, max_new=10) == want
    assert spec.acceptance_rate() == 0.0
    assert spec.spec_stats["fallback_rounds"] > 0 and spec.spec_stats["rounds"] >= 2


def test_spec_rollback_keeps_admission_reservation():
    """Per-round rollback never frees blocks of the reservation: after every
    round the slot owns its full block count and no table entry inside it is
    trash (the fallback tick writes the boundary block next)."""
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=3,
                           drafter=_GarbageDrafter(_arch("yi-6b"), Runtime()),
                           min_accept=0.9, probe_interval=100, **{**KW, "batch": 1})
    req = Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new=12)
    spec.submit(req)
    need = spec.cache.blocks_needed(spec._slot_tokens(req))
    while not spec.sched.idle():
        spec.step()
        if spec.sched.slots[0] is not None:
            assert len(spec.cache._owned[0]) == need
            assert all(spec.cache.tables[0, j] != TRASH_BLOCK for j in range(need))
    assert req.generated == _plain("yi-6b", [np.arange(4, dtype=np.int32)], 12, batch=1)[0]


def test_spec_headroom_guard_and_gate():
    kw = {**KW, "batch": 1, "max_seq": 16}
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=4, **kw)
    with pytest.raises(ValueError):  # 8 + 6 fits max_seq 16, not with 4 of headroom
        spec.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32), max_new=6))
    prompts = _prompts(_arch("yi-6b").vocab, (6,), seed=7)
    spec2 = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=4, **kw)
    assert spec2.generate(prompts, max_new=4) == _plain("yi-6b", prompts, 4, **kw)


def test_spec_megastep_fallback_composes():
    """A gate that never opens falls back through the megastep (fewer
    dispatches than tokens), token-identical."""
    prompts = _prompts(_arch("yi-6b").vocab, (5, 6), seed=4)
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=3, min_accept=2.0,
                           probe_interval=10**6, decode_steps=4, **KW)
    assert spec.generate(prompts, max_new=6) == _plain("yi-6b", prompts, 6)
    assert spec.spec_stats["rounds"] == 0 and spec.spec_stats["fallback_rounds"] > 0
    assert 0 < spec.throughput()["dispatches_per_token"] < 1


def test_prefix_share_composes_with_spec():
    rng = np.random.default_rng(10)
    vocab = _arch("yi-6b").vocab
    common = rng.integers(0, vocab, (9,)).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(0, vocab, (n,)).astype(np.int32)])
               for n in (2, 4, 3)]
    spec = SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=3, prefix_share=True, **KW)
    assert spec.generate(prompts, max_new=5) == _plain("yi-6b", prompts, 5)
    assert spec.cache.prefix_hits >= 1


@pytest.mark.parametrize("name", ["rwkv6-7b", "h2o-danube-1.8b"])
def test_spec_refuses_or_falls_back_without_rollback(name):
    """Recurrent state and rings cannot unwind a rejected draft: ``strict``
    refuses; the default serves plain (token-identical, spec never on)."""
    arch, params = _arch(name), _params(name)
    with pytest.raises(ValueError):
        SpecServeEngine(arch, params, strict=True, **KW)
    prompts = _prompts(arch.vocab, (5, 3), seed=3)
    spec = SpecServeEngine(arch, params, **KW)
    assert not spec.spec_supported and spec.drafter is None
    assert spec.generate(prompts, max_new=3) == _plain(name, prompts, 3)
    assert not spec.spec_active() and spec.spec_stats["rounds"] == 0
    assert spec.spec_stats["fallback_rounds"] > 0


def test_spec_refusals():
    with pytest.raises(ValueError, match="greedy"):
        SpecServeEngine(_arch("yi-6b"), _params("yi-6b"),
                        sample=SampleConfig(method="temperature", temperature=0.9), **KW)
    darch = dataclasses.replace(_arch("smollm-135m"), vocab=128)
    drafter = ModelDrafter(darch, init_lm(torch.Generator().manual_seed(7), darch, device="cpu"),
                           slots=2, max_seq=64, spec_k=2, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpecServeEngine(_arch("yi-6b"), _params("yi-6b"), spec_k=2, drafter=drafter, **KW)
    with pytest.raises(ValueError, match="fully paged"):
        ModelDrafter(_arch("rwkv6-7b"), _params("rwkv6-7b"), slots=2, max_seq=64, spec_k=2,
                     device="cpu")


# -- against the JAX package -------------------------------------------------------

JAX_CASES = ("self-int8", "model smollm-135m")
JAX_PROMPT_LENS, JAX_NEW = (6, 4, 9), 8


@pytest.fixture(scope="module")
def jax_spec():
    """Per case: the JAX params (target, and the draft model's) as numpy and
    the reference spec engine's driven requests and ``spec_stats``."""
    arch = jreduced(jget_arch("yi-6b"))
    params = jdeploy_params(unbox(jinit_lm(jax.random.PRNGKey(0), arch)), arch.quant)
    darch = jreduced(jget_arch("smollm-135m"))
    dparams = unbox(jinit_lm(jax.random.PRNGKey(7), darch))
    prompts = _prompts(arch.vocab, JAX_PROMPT_LENS, seed=11)
    kw = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4, spec_k=3)
    out = {}
    for case in JAX_CASES:
        drafter = None
        if case.startswith("model"):
            drafter = JModelDrafter(darch, dparams, slots=2, max_seq=64, spec_k=3, block_size=4,
                                    prefill_chunk=4)
        e = JSpecServeEngine(arch, params, drafter=drafter, min_accept=0.0, **kw)
        e.generate(prompts, max_new=JAX_NEW)
        out[case] = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, dparams),
                     e.last_requests, dict(e.spec_stats))
    return out


@pytest.mark.parametrize("case", JAX_CASES)
def test_spec_matches_jax_spec_engine(jax_spec, case):
    """Deployed yi-6b, k=3, drafted by the int8 self-drafter or by reduced
    smollm-135m (its own paged cache, ``sync`` with the pending delta after
    a full acceptance): tokens within ``parity_up_to_ties`` of JAX's spec
    engine and identical to the port's plain engine; ``spec_stats`` equal to
    JAX's where no verify margin sits within the eps; both caches drained."""
    params_np, dparams_np, ref_reqs, ref_stats = jax_spec[case]
    arch = _arch("yi-6b")
    params = from_jax_numpy(params_np)
    prompts = _prompts(arch.vocab, JAX_PROMPT_LENS, seed=11)
    drafter = None
    if case.startswith("model"):
        drafter = ModelDrafter(_arch("smollm-135m"), from_jax_numpy(dparams_np), slots=2,
                               max_seq=64, spec_k=3, block_size=4, prefill_chunk=4, device="cpu")
    spec = SpecServeEngine(arch, params, spec_k=3, drafter=drafter, min_accept=0.0, **KW)
    got = spec.generate(prompts, max_new=JAX_NEW)
    ok, ties, detail = parity_up_to_ties(ref_reqs, got, EPS)
    assert ok, detail
    assert got == _plain("yi-6b", prompts, JAX_NEW, params=params)
    if min(m for r in ref_reqs for m in r.margins) > EPS:
        assert ties == 0 and spec.spec_stats == ref_stats
    assert spec.spec_stats["rounds"] > 0 and _drained(spec)
    if drafter is not None:
        assert drafter.cache.free_blocks == drafter.cache.num_blocks - 1


def test_launcher_spec_flags(capsys):
    """``--spec-k`` with the default self-int8 drafter and with ``--spec-draft
    <config>`` serve the plain launcher's tokens and report ``_spec_report``'s
    fields; the reference's checks refuse ``--spec-draft`` without
    ``--spec-k`` and ``--spec-k`` without ``--paged``."""
    base = ["--arch", "yi-6b", "--reduced", "--paged", "--int-forward", "--device", "cpu",
            "--requests", "3", "--prompt-len", "5", "--max-new", "5", "--batch", "2",
            "--max-seq", "64", "--block-size", "4", "--prefill-chunk", "4"]
    plain = launch_serve.main(base)
    for extra in (["--spec-k", "3"], ["--spec-k", "2", "--spec-draft", "smollm-135m"]):
        capsys.readouterr()
        res = launch_serve.run(base + extra)
        assert res["outs"] == plain
        rep = res["report"]["spec"]
        assert set(rep) == {"active", "supported", "k", "acceptance_rate", "rounds",
                            "fallback_rounds", "proposed", "accepted", "emitted", "bonus"}
        assert rep["active"] and rep["supported"] and rep["k"] == int(extra[1])
        assert "[speculative] k=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(base + ["--spec-draft", "smollm-135m"])
    with pytest.raises(SystemExit):
        launch_serve.main([a for a in base if a != "--paged"] + ["--spec-k", "2"])
