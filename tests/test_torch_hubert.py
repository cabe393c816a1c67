"""hubert-xlarge (the audio family) in the port against the JAX package.

Covered, on reduced hubert-xlarge (2 bidirectional layers, d_model 32, 2
heads of 16, d_ff 64, 32 classes, LayerNorm, biases, the non-gated GELU MLP,
fp32 compute) built with the JAX initializer, activation scales pinned to
powers of two (``jnp.exp2`` and ``torch.exp2`` agree there) and random
biases (zero at init; set so the bias runs through the requant epilogue):

* the parameter tree of ``init_lm`` for the audio family (no ``embed``, a
  boundary ``head`` of ``n_classes``) against the JAX tree;
* ``apply_lm(frontend_embeds=...)`` logits for every frame against JAX's, on
  the float path (``Runtime()``), the deployed ``int_forward`` path and
  ``int_chain`` (every linear on the fused kernel's plain version, ``mlp.w_in``
  through the gelu requant epilogue into ``mlp.w_out``), with the chain
  reports site for site (the reference lists a scanned stack's sites once,
  the port every layer's);
* chaining as a pure dispatch fusion: chained and unchained logits bitwise
  equal;
* the non-gated MLP under ``int_chain`` (``w_in`` returns an ``IntAct``, the
  host gelu is skipped for it) against its unchained form and JAX's;
* ``build_prefill_step``: the last frame's logits of ``apply_lm``, and JAX's.

Tolerances: logits rtol 1e-4 of their scale on the float path (fp32 matmuls
and softmax summed in another order, as ``test_torch_model.py``); the
integer paths agree exactly here (every float difference is absorbed by the
next act-quant), and are held to the same 1e-4 in case a code sits on a
rounding tie.
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
from repro.nn import transformer as jtransformer
from repro.nn.module import unbox
from repro.serve.engine import deploy_params as jdeploy_params

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.models.lm import Runtime, apply_lm, init_lm
from repro_torch.models.steps import build_prefill_step
from repro_torch.nn import linear as tlinear
from repro_torch.nn.transformer import _apply_mlp

torch.set_num_threads(1)

NAME = "hubert-xlarge"


def _pin_and_bias(tree, rng):
    """Activation scales pinned to the power of two below them; biases drawn."""
    if isinstance(tree, dict):
        return {k: (jnp.floor(v) if k == "log2_scale" else
                    jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32) if k == "b" else
                    _pin_and_bias(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def model():
    """Reduced hubert from the JAX initializer, float and deployed, as numpy."""
    jarch = jreduced(jget_arch(NAME))
    fl = _pin_and_bias(unbox(jinit_lm(jax.random.PRNGKey(0), jarch)), np.random.default_rng(1))
    dep = jax.jit(lambda p: jdeploy_params(p, jarch.quant))(fl)
    return jarch, jax.tree.map(np.asarray, fl), jax.tree.map(np.asarray, dep)


def _frames(arch, B=2, S=24, seed=2):
    return np.random.default_rng(seed).normal(size=(B, S, arch.d_model)).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_init_lm_audio_tree_matches_jax(model):
    _, fl, _ = model
    arch = reduced(get_arch(NAME))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")

    def shapes(tree, as_shape):
        if isinstance(tree, dict):
            return {k: shapes(v, as_shape) for k, v in tree.items()}
        return tuple(as_shape(tree))

    assert "embed" not in params
    assert tuple(params["head"]["v"].shape) == (arch.d_model, arch.n_classes)
    assert shapes(params, lambda t: t.shape) == shapes(fl, lambda a: a.shape)


_PATHS = {"float": ("float", {}), "int_forward": ("deployed", dict(int_forward=True)),
          "int_chain": ("deployed", dict(int_chain=True))}


@pytest.mark.parametrize("path", list(_PATHS))
def test_logits_match_jax(model, path):
    """Framewise logits of a cacheless encode of 24 frames, and the chain
    report: 6 linears a layer and the head, ``mlp.w_in`` chained under
    ``int_chain``, none standalone."""
    jarch, fl, dep = model
    arch = reduced(get_arch(NAME))
    which, kw = _PATHS[path]
    p = fl if which == "float" else dep
    jrt, rt = JRuntime(**kw), Runtime(**kw)
    x = _frames(arch)
    jl = jax.jit(lambda p, f: japply_lm(p, jarch, frontend_embeds=f, rt=jrt)[0])(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tl, cache = apply_lm(from_jax_numpy(p), arch, frontend_embeds=torch.from_numpy(x), rt=rt)
    assert cache is None and tl.shape == (2, 24, arch.n_classes)
    _close(tl.numpy(), jl)
    if not kw:
        return
    sites = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_in", "mlp.w_out"]
    n = arch.stacks[0].count
    kind = "folded" if rt.int_chain else "standalone"
    assert jrt.chain_report[kind] == sites + ["head"]
    assert rt.chain_report[kind] == sites * n + ["head"]
    assert jrt.chain_report["chained"] == (["mlp.w_in"] if rt.int_chain else [])
    assert rt.chain_report["chained"] == (["mlp.w_in"] * n if rt.int_chain else [])
    other = "standalone" if rt.int_chain else "folded"
    assert rt.chain_report[other] == rt.chain_report["fallback"] == []


def test_int_chain_is_a_pure_dispatch_fusion(model):
    """The gelu requant epilogue replays the host's gelu op by op, so the
    chained encode gives the unchained one's logits bit for bit."""
    _, _, dep = model
    arch = reduced(get_arch(NAME))
    params = from_jax_numpy(dep)
    x = torch.from_numpy(_frames(arch, seed=3))
    chained = apply_lm(params, arch, frontend_embeds=x, rt=Runtime(int_chain=True))[0]
    unchained = apply_lm(params, arch, frontend_embeds=x, rt=Runtime(int_forward=True))[0]
    assert torch.equal(chained, unchained)


def test_non_gated_mlp_chains_w_in_into_w_out(model):
    """Under ``int_chain`` ``mlp.w_in`` hands ``w_out`` the int8 codes of its
    gelu requant epilogue, and the host gelu is skipped for them (applying it
    to the ``IntAct`` was a fault): the output equals the unchained MLP's
    bit for bit, and JAX's ``_apply_mlp``."""
    jarch, _, dep = model
    q = jarch.quant
    mlp = jax.tree.map(lambda a: a[0], dep["stacks"]["0"]["mlp"])
    x = np.random.default_rng(4).normal(size=(2, 5, jarch.d_model)).astype(np.float32)
    rep: dict = {}
    with tlinear.chain_report_scope(rep):
        got = _apply_mlp(from_jax_numpy(mlp), torch.from_numpy(x), q, torch.float32,
                         int_forward=True, int_chain=True)
    assert rep["chained"] == ["mlp.w_in"] and rep["folded"] == ["mlp.w_in", "mlp.w_out"]
    unchained = _apply_mlp(from_jax_numpy(mlp), torch.from_numpy(x), q, torch.float32,
                           int_forward=True)
    assert torch.equal(got, unchained)
    want = jax.jit(lambda p, x: jtransformer._apply_mlp(p, x, q, jnp.float32, int_forward=True,
                                                        int_chain=True))(
        jax.tree.map(jnp.asarray, mlp), jnp.asarray(x))
    _close(got.numpy(), want)


def test_prefill_step_gives_the_last_frame(model):
    jarch, _, dep = model
    arch = reduced(get_arch(NAME))
    x = _frames(arch, seed=5)
    params = from_jax_numpy(dep)
    rt = Runtime(int_chain=True)
    step = build_prefill_step(arch, rt)
    last = step(params, {"frontend_embeds": torch.from_numpy(x)})
    full = apply_lm(params, arch, frontend_embeds=torch.from_numpy(x), rt=rt)[0]
    assert last.shape == (2, 1, arch.n_classes)
    assert torch.equal(last, full[:, -1:])
    jstep = jax.jit(jbuild_prefill_step(jarch, JRuntime(int_chain=True)))
    _close(last.numpy(), jstep(jax.tree.map(jnp.asarray, dep), {"frontend_embeds": jnp.asarray(x)}))
