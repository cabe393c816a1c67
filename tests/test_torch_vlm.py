"""The vision-language family (llava-next-34b) in the port against the JAX
package.

Reduced llava-next-34b: 2 layers, d_model 64, 4 heads over 1 KV head, 8
patch embeddings (the anyres frontend is a stub in both packages: the
patches come in precomputed), fp32 compute, params from the JAX
initializer loaded with ``from_jax_numpy``.  Covered:

* ``init_lm`` builds the reference's ``lm`` tree for ``family="vlm"``;
* ``apply_lm`` with the patches prepended to the token embeddings (the
  batch built as ``tests/test_arch_smoke.py`` builds it: 8 patches and 8
  tokens), float and deployed ``int_chain`` (activation scales pinned to
  powers of two), against JAX; the cacheless attention through the flash
  kernel (its plain version here), causal over patches and text;
* ``build_prefill_step`` against the reference's;
* the paged engine on text (the engines take tokens only, as the
  reference's do), per tick and on the megastep, against JAX's per-tick
  ``PagedServeEngine``; the launcher;
* ``lm_loss`` keeps refusing hymba, llama4's MoE stacks and vlm: their
  training is not ported.

Tolerances: logits rtol 1e-4 of their scale; engine margins 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import apply_lm as japply_lm
from repro.models.lm import init_lm as jinit_lm
from repro.models.steps import build_prefill_step as jbuild_prefill_step
from repro.nn.module import unbox
from repro.serve.engine import PagedServeEngine as JPagedServeEngine
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime, apply_lm, init_lm, lm_loss
from repro_torch.models.steps import build_prefill_step
from repro_torch.serve.engine import PagedServeEngine, parity_up_to_ties

torch.set_num_threads(1)

NAME = "llava-next-34b"
TOL = 1e-4
ENGINE = dict(batch=2, max_seq=32, block_size=4, prefill_chunk=8)
MAX_NEW = 5


def _pin_scales(tree):
    """Every activation scale pinned to the power of two below it."""
    if isinstance(tree, dict):
        return {k: (jnp.floor(v) if k == "log2_scale" else _pin_scales(v))
                for k, v in tree.items()}
    return tree


def _batch(arch, B=2, S=16):
    """``tests/test_arch_smoke.py``'s vlm batch: ``frontend.seq_len`` patch
    embeddings and ``S - seq_len`` tokens, numpy from seed 0."""
    rng = np.random.default_rng(0)
    si = arch.frontend.seq_len
    return {"tokens": rng.integers(0, arch.vocab, (B, S - si)).astype(np.int32),
            "frontend_embeds": rng.normal(size=(B, si, arch.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def model():
    """Reduced llava-next-34b from the JAX initializer (scales pinned), float
    and deployed, as numpy."""
    jarch = jreduced(jget_arch(NAME))
    fl = _pin_scales(jax.jit(lambda k: unbox(jinit_lm(k, jarch)))(jax.random.PRNGKey(0)))
    dep = jax.jit(lambda p: jdeploy_params(p, jarch.quant))(fl)
    return jarch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


def _arch():
    return reduced(get_arch(NAME))


def test_init_lm_builds_the_lm_tree(model):
    """The port's ``init_lm`` for ``family="vlm"``: the reference's tree
    (embedding, stacks, final norm, untied head), leaf for leaf in shape."""
    _, fl, _ = model
    arch = _arch()
    assert arch.family == "vlm" and arch.frontend.seq_len == 8
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(fl)[0]}
    got = {jax.tree_util.keystr(p): tuple(v.shape)
           for p, v in jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: t.numpy(), params))[0]}
    assert got == want


_LM = {"float": ("float", {}), "int_chain": ("deployed", dict(int_chain=True))}


@pytest.mark.parametrize("path", list(_LM))
def test_patches_then_tokens_match_jax(model, path, monkeypatch):
    """Logits over 8 patches then 8 tokens against JAX's; the cacheless
    attention runs the flash kernel (its plain version), once a layer."""
    jarch, fl, dep = model
    which, kw = _LM[path]
    p = fl if which == "float" else dep
    batch = _batch(jarch)
    jl = jax.jit(lambda p, t, f: japply_lm(p, jarch, tokens=t, frontend_embeds=f,
                                           rt=JRuntime(**kw))[0])(
        jax.tree.map(jnp.asarray, p), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["frontend_embeds"]))
    calls = []
    plain = ops.flash_attention_plain
    monkeypatch.setattr(ops, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tl, _ = apply_lm(from_jax_numpy(p), _arch(), tokens=torch.from_numpy(batch["tokens"]),
                     frontend_embeds=torch.from_numpy(batch["frontend_embeds"]),
                     rt=Runtime(**kw))
    jl = np.asarray(jl)
    assert tl.shape == (2, 16, jarch.vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())
    assert len(calls) == _arch().n_layers


def test_prefill_step_matches_jax(model):
    """``build_prefill_step`` on the patches and tokens: the last position's
    logits against the reference's step."""
    jarch, fl, _ = model
    batch = _batch(jarch)
    jstep = jax.jit(jbuild_prefill_step(jarch))
    jl = np.asarray(jstep(jax.tree.map(jnp.asarray, fl),
                          {k: jnp.asarray(v) for k, v in batch.items()}))
    tl = build_prefill_step(_arch())(from_jax_numpy(fl),
                                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (2, 1, jarch.vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4 * np.abs(jl).max())


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (11, 6, 14)]


@pytest.fixture(scope="module")
def jax_engine(model):
    """The JAX paged engine's requests on the float params, per tick: three
    text prompts over two slots."""
    jarch, fl, _ = model
    e = JPagedServeEngine(jarch, jax.tree.map(jnp.asarray, fl), **ENGINE)
    e.generate(_prompts(jarch.vocab), max_new=MAX_NEW)
    return e.last_requests


@pytest.mark.parametrize("steps", [1, 4], ids=["per-tick", "megastep"])
def test_paged_engine_on_text_matches_jax(model, jax_engine, steps):
    _, fl, _ = model
    e = PagedServeEngine(_arch(), from_jax_numpy(fl), decode_steps=steps, device="cpu",
                         **ENGINE)
    outs = e.generate(_prompts(e.arch.vocab), max_new=MAX_NEW)
    ok, ties, detail = parity_up_to_ties(jax_engine, outs, TOL)
    assert ok and ties == 0, detail
    for r, q in zip(jax_engine, e.last_requests):
        np.testing.assert_allclose(q.margins, r.margins, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["hymba-1.5b", "llama4-scout-17b-a16e", NAME])
def test_lm_loss_keeps_refusing(name):
    """``lm_loss`` refuses none of these any more: hymba and llama4's MoE
    stacks train (``tests/test_torch_train_moe.py``,
    ``tests/test_torch_train_recurrent.py`` hold them to the reference), and
    so does the vlm family, its patches ahead of the text and its targets
    over the whole sequence (``tests/test_torch_train_frontend.py``): a
    finite loss whose gradient reaches every leaf."""
    from repro_torch.nn.module import tree_leaves_with_path, tree_map

    arch = reduced(get_arch(name))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": toks, "targets": toks}
    if arch.family == "vlm":
        si = arch.frontend.seq_len
        batch = {"tokens": toks, "targets": torch.zeros((1, si + 8), dtype=torch.int32),
                 "frontend_embeds": torch.randn((1, si, arch.d_model),
                                                generator=torch.Generator().manual_seed(1))}
    params = tree_map(lambda t: t.requires_grad_(),
                      init_lm(torch.Generator().manual_seed(0), arch, device="cpu"))
    loss, _ = lm_loss(params, arch, batch)
    leaves = [v for _, v in tree_leaves_with_path(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert torch.isfinite(loss) and all(g is not None and torch.isfinite(g).all()
                                        for g in grads)


def test_launcher_serves_llava(capsys):
    """``--arch llava-next-34b --paged --int-chain --decode-kernel
    --decode-steps 4`` serves the reduced model on text prompts."""
    from repro_torch.launch import serve as launch_serve

    outs = launch_serve.main(["--arch", NAME, "--reduced", "--paged", "--int-chain",
                              "--decode-kernel", "--decode-steps", "4", "--device", "cpu",
                              "--requests", "3", "--prompt-len", "10", "--max-new", "4",
                              "--batch", "2", "--max-seq", "32", "--block-size", "4",
                              "--prefill-chunk", "8"])
    assert [len(o) for o in outs] == [4, 4, 4]
    text = capsys.readouterr().out
    assert "15 folded, 0 chained, 0 standalone act-quant" in text
    assert "0 violations" in text
