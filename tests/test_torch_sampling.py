"""Non-greedy sampling in the port: ``sample_tokens`` against the reference's
``repro.serve.sampling`` in distribution, and the sampled paged engine.

``jax.random`` streams cannot be reproduced in PyTorch, so the two packages
are compared in distribution.  Fixed logits (V = 12, a tie between the
third and fourth largest, so top-3 keeps four tokens) go through both
packages' ``sample_tokens`` 20,000 times each (one batched call, seeded);
each package's counts must match the exact masked softmax by Pearson's
chi-square test at p > 1e-4 (masked tokens: zero draws), for three
temperatures and top-k of 1, 3 and past the vocab (clamped: plain
temperature sampling), and for the ``temperature`` method.  The top-k set,
ties with the k-th value included, equals the reference's mask set.
Temperature at or below ``TEMPERATURE_EPS`` is the argmax bit for bit and
draws nothing.  The engine (reduced yi-6b on the CPU): the same seed gives
the same tokens per tick and on the megastep, another seed other tokens; a
sampled megastep honours EOS and ``max_new``; the speculative engine
refuses sampling as the reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from repro.serve.sampling import SampleConfig as JSampleConfig
from repro.serve.sampling import sample_tokens as jsample_tokens

from repro_torch.configs import get_arch, reduced
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.serve.sampling import (
    TEMPERATURE_EPS,
    SampleConfig,
    mask_topk,
    sample_tokens,
)
from repro_torch.serve.spec import SpecServeEngine

torch.set_num_threads(1)

V = 12
DRAWS = 20_000
P_MIN = 1e-4
KW = dict(batch=2, max_seq=64, block_size=4, prefill_chunk=4, device="cpu")


def _logits() -> np.ndarray:
    lf = np.random.default_rng(5).normal(0.0, 1.5, V).astype(np.float32)
    order = np.argsort(-lf)
    lf[order[3]] = lf[order[2]]  # the 4th largest ties the 3rd
    return lf


def _exact(lf: np.ndarray, cfg: SampleConfig) -> np.ndarray:
    """The masked softmax in float64."""
    x = lf.astype(np.float64)
    if cfg.method == "topk":
        kth = np.sort(x)[::-1][min(cfg.top_k, V) - 1]
        x = np.where(x < kth, -np.inf, x)
    p = np.exp((x - x.max()) / cfg.temperature)
    return p / p.sum()


CASES = [("topk", t, k) for t in (0.5, 1.0, 2.0) for k in (1, 3, V + 4)] + [
    ("temperature", 1.0, 0)]


@pytest.mark.parametrize("method,temperature,top_k", CASES)
def test_sampling_matches_masked_softmax_in_both_packages(method, temperature, top_k):
    cfg = SampleConfig(method=method, temperature=temperature, top_k=top_k)
    lf = _logits()
    p = _exact(lf, cfg)
    batch = np.broadcast_to(lf, (DRAWS, V))
    port = sample_tokens(torch.from_numpy(np.ascontiguousarray(batch)), cfg,
                         torch.Generator().manual_seed(3)).numpy()
    ref = np.asarray(jsample_tokens(jnp.asarray(batch),
                                    JSampleConfig(method, temperature, top_k),
                                    jax.random.PRNGKey(3)))
    for name, toks in (("port", port), ("jax", ref)):
        assert toks.dtype == np.int32 and toks.shape == (DRAWS,)
        counts = np.bincount(toks, minlength=V)
        keep = p > 0
        assert counts[~keep].sum() == 0, f"{name} drew a masked token"
        if keep.sum() == 1:
            assert counts[keep].item() == DRAWS, name
            continue
        stat, pval = chisquare(counts[keep], DRAWS * p[keep])
        assert pval > P_MIN, f"{name}: chi-square {stat:.2f}, p {pval:.3g}"


@pytest.mark.parametrize("top_k", [1, 3, 4, V, V + 4])
def test_topk_set_matches_reference_mask(top_k):
    """The tokens left unmasked, ties with the k-th value included, are the
    reference's (``lax.top_k`` + ``where``)."""
    lf = np.stack([_logits(), np.zeros(V, np.float32), np.arange(V, dtype=np.float32)])
    port = np.isfinite(mask_topk(torch.from_numpy(lf), top_k).numpy())
    k = min(top_k, V)
    x = jnp.asarray(lf)
    ref = np.isfinite(np.asarray(jnp.where(x < jax.lax.top_k(x, k)[0][..., -1:], -jnp.inf, x)))
    np.testing.assert_array_equal(port, ref)
    assert port[1].all()  # a row of equal logits keeps every token


@pytest.mark.parametrize("method", ["temperature", "topk"])
def test_temperature_at_eps_is_greedy_bit_for_bit(method):
    lf = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    for t in (0.0, TEMPERATURE_EPS, 1e-7):
        cfg = SampleConfig(method=method, temperature=t, top_k=5)
        assert cfg.greedy
        got = sample_tokens(lf.to(torch.bfloat16), cfg, gen)
        assert torch.equal(got, torch.argmax(lf.to(torch.bfloat16).float(), -1).to(torch.int32))
    assert torch.equal(gen.get_state(), state), "a greedy sample drew from the generator"


_PARAMS = {}


def _yi():
    if "yi" not in _PARAMS:
        arch = reduced(get_arch("yi-6b"))
        _PARAMS["yi"] = (arch, init_lm(torch.Generator().manual_seed(0), arch, device="cpu"))
    return _PARAMS["yi"]


def _prompts(vocab, lens=(5, 9, 3), seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


TOPK = SampleConfig("topk", temperature=0.8, top_k=40)


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_engine_sampling_reproduces_from_seed(decode_steps):
    arch, params = _yi()
    prompts = _prompts(arch.vocab)

    def run(seed, sample=TOPK):
        e = PagedServeEngine(arch, params, sample=sample, seed=seed,
                             decode_steps=decode_steps, **KW)
        return e.generate(prompts, max_new=6), e

    a, e = run(0)
    b, _ = run(0)
    c, _ = run(1)
    greedy, g = run(0, SampleConfig())
    cold, _ = run(0, SampleConfig("topk", temperature=1e-7, top_k=40))
    assert a == b, "the same seed gives the same tokens"
    assert a != c, "another seed gives other tokens"
    assert a != greedy and cold == greedy, "temperature 1e-7 is the greedy stream"
    assert all(len(o) == 6 and all(0 <= t < arch.vocab for t in o) for o in a)
    assert torch.equal(g._gen.get_state(),
                       torch.Generator().manual_seed(0).get_state()), "greedy drew nothing"


def test_sampled_megastep_honours_eos_and_max_new():
    """A sampled window's device finish mask ends a request the tick it
    emits its EOS id: the rerun from the same seed cuts each request at its
    first EOS, and every block is freed."""
    arch, params = _yi()
    prompts = _prompts(arch.vocab, lens=(6, 7))

    def run(eos):
        e = PagedServeEngine(arch, params, sample=TOPK, seed=4, decode_steps=3, eos_id=eos,
                             **KW)
        return e.generate(prompts, max_new=8), e

    full, _ = run(None)
    eos = full[0][3]
    want = [o[: o.index(eos) + 1] if eos in o else o for o in full]
    outs, e = run(eos)
    assert outs == want and len(outs[0]) <= 4
    assert all(len(o) <= 8 for o in outs)
    assert e.cache.free_blocks == e.cache.num_blocks - 1


def test_spec_engine_refuses_non_greedy_sampling():
    arch, params = _yi()
    with pytest.raises(ValueError, match="greedy sampling only"):
        SpecServeEngine(arch, params, spec_k=2, sample=TOPK, **KW)
