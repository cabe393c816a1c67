"""The slice as a whole: the port's paged engine against the JAX engine.

Reduced smollm-135m (G = 4 query heads per KV head after reduction) and
yi-6b (untied head) are initialized by JAX, deployed to int8, and served by
``repro.serve.engine.PagedServeEngine(rt=Runtime(int_forward=True,
decode_kernel=True))`` (Pallas in interpret mode) and by the port's engine on
``device="cpu"`` (the kernels' plain versions) on the same prompts: three
requests over two slots, so a slot is recycled, prompts longer than one
prefill chunk, and a dead row riding a decode step in the trash block.

Tolerances: the two compute the same fp32 arithmetic in another order, and
their logits agree to ~1e-6 (``test_torch_model.py``).  Token streams must
agree under ``parity_up_to_ties`` at eps 1e-4 — a mismatch is excused only
where the reference's top-2 logit margin is below that — and the per-step
greedy margins (top-2 logit gaps, the engines' per-step logit readout) agree
to 1e-4.  The JAX engines run once per module.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import Runtime
from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "yi-6b")
ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=4)
MAX_NEW = 5
EPS = 1e-4


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (5, 9, 3)]


@pytest.fixture(scope="module")
def reference():
    """Per arch: the deployed JAX params as numpy, and the JAX engine's driven
    requests (tokens + margins)."""
    out = {}
    for name in ARCHS:
        arch = jreduced(jget_arch(name))
        params = jdeploy_params(unbox(jinit_lm(jax.random.PRNGKey(0), arch)), arch.quant)
        e = JPagedServeEngine(arch, params, rt=JRuntime(int_forward=True, decode_kernel=True),
                              **ENGINE)
        e.generate(_prompts(arch.vocab), max_new=MAX_NEW)
        out[name] = (jax.tree.map(np.asarray, params), e.last_requests)
    return out


def _port_engine(name, params_np, **kw):
    arch = reduced(get_arch(name))
    return PagedServeEngine(arch, from_jax_numpy(params_np), device="cpu",
                            rt=Runtime(int_forward=True, decode_kernel=True), **ENGINE, **kw)


@pytest.mark.parametrize("name", ARCHS)
def test_paged_engine_matches_jax_engine(reference, name):
    params_np, ref_reqs = reference[name]
    e = _port_engine(name, params_np)
    outs = e.generate(_prompts(reduced(get_arch(name)).vocab), max_new=MAX_NEW)
    ok, ties, detail = parity_up_to_ties(ref_reqs, outs, EPS)
    assert ok, detail
    assert ties == 0
    for r, req in zip(ref_reqs, e.last_requests):
        assert len(req.generated) == MAX_NEW
        np.testing.assert_allclose(req.margins, r.margins, rtol=0, atol=EPS)


def test_paged_engine_stats_contract(reference):
    """Prefill books the prompt tokens and the first generated token; decode
    books one token per live row per tick; every fused call site is counted."""
    params_np, _ = reference["smollm-135m"]
    e = _port_engine("smollm-135m", params_np)
    prompts = _prompts(reduced(get_arch("smollm-135m")).vocab)
    e.generate(prompts, max_new=MAX_NEW)
    tp = e.throughput()
    assert tp["prefill_tokens"] == sum(len(p) for p in prompts)
    assert tp["decode_tokens"] == len(prompts) * (MAX_NEW - 1)
    assert tp["decode_dispatches"] >= MAX_NEW - 1 and tp["decode_tok_s"] > 0
    assert tp["int_chain_requant_dispatches"] == 7 * 2 and tp["int_chain_fallback"] == 0
    assert e.cache.free_blocks == e.cache.num_blocks - 1  # every block released
    e.reset_stats()
    assert e.throughput()["decode_tokens"] == 0


def test_launcher_runs_and_refuses_unported_flags(capsys):
    base = ["--arch", "yi-6b", "--reduced", "--paged", "--int-forward", "--decode-kernel",
            "--device", "cpu", "--requests", "2", "--prompt-len", "5", "--max-new", "3",
            "--batch", "2", "--max-seq", "16", "--block-size", "4", "--prefill-chunk", "4"]
    outs = launch_serve.main(base)
    assert [len(o) for o in outs] == [3, 3]
    assert "decode:" in capsys.readouterr().out
    for extra in (["--spec-k", "2", "--sample", "temperature"], ["--pin-prompt", "4"],
                  ["--spec-draft=smollm-135m"],
                  ["--decode-steps", "0"], ["--eos-auto", "--eos-id", "3"]):
        with pytest.raises(SystemExit):
            launch_serve.main(base + extra)
    unpaged = [a for a in base if a != "--paged"]
    for extra in (["--kv-int8"], ["--sample", "topk", "--top-k", "4"]):
        with pytest.raises(SystemExit):  # a paged-only flag without --paged
            launch_serve.main(unpaged + extra)


def test_launcher_samples_traces_and_writes_metrics(tmp_path, capsys):
    """``--sample topk --top-k 4 --trace PATH --metrics-json PATH`` on the
    megastep: the sampled tokens reproduce from ``--seed``, the trace and the
    snapshot are written and read back, and the int-forward run prints its
    accumulator headroom (0 violations)."""
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    argv = ["--arch", "yi-6b", "--reduced", "--paged", "--int-chain", "--decode-kernel",
            "--decode-steps", "2", "--sample", "topk", "--top-k", "4", "--temperature", "0.8",
            "--device", "cpu", "--requests", "3", "--prompt-len", "5", "--max-new", "4",
            "--batch", "2", "--max-seq", "16", "--block-size", "4", "--prefill-chunk", "4"]
    first = launch_serve.run(argv + ["--trace", str(trace), "--metrics-json", str(metrics)])
    out = capsys.readouterr().out
    assert launch_serve.main(argv) == first["outs"]
    assert [len(o) for o in first["outs"]] == [4, 4, 4]
    assert "acc headroom:" in out and first["report"]["headroom"]["violations"] == 0
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"submit", "admit", "prefill_chunk", "decode_megastep", "emit"} <= names
    snap = json.loads(metrics.read_text())
    assert snap["requests_completed"]["value"] == 3
    assert snap["serve_decode_tokens"]["value"] == first["report"]["paged_engine"]["decode_tokens"]
    assert snap["acc_headroom_violations"]["value"] == 0
    assert snap["int_chain_requant_dispatches"]["value"] == 0


def test_launcher_megastep_with_eos_id(capsys):
    """``--decode-steps 4 --eos-id N``: the megastep windows give the per-tick
    launcher's tokens, each request cut at its first N (EOS included), in
    fewer decode dispatches than tokens."""
    base = ["--arch", "yi-6b", "--reduced", "--paged", "--int-chain", "--decode-kernel",
            "--device", "cpu", "--requests", "3", "--prompt-len", "5", "--max-new", "6",
            "--batch", "2", "--max-seq", "16", "--block-size", "4", "--prefill-chunk", "4"]
    full = launch_serve.main(base)
    eos = full[1][2]
    want = [o[: o.index(eos) + 1] if eos in o else o for o in full]
    assert len(want[1]) < 6  # request 1 ends early
    capsys.readouterr()
    outs = launch_serve.main(base + ["--decode-steps", "4", "--eos-id", str(eos)])
    assert outs == want
    out = capsys.readouterr().out
    dispatches = int(out.split(" dispatches = ")[0].rsplit("(", 1)[1].split(", ")[-1])
    assert 0 < dispatches < sum(len(o) - 1 for o in outs)
