"""The port's vision networks against the JAX package on the CPU.

Parameters are drawn by the JAX initializers and carried over with
``from_jax_numpy``; inputs come from the seeded streams.  Widths are cut
(MobileNetV1 and ResNet18 at ``width`` 0.125-0.25, UNet at ``base=8``),
batch 2.  Tolerances, all fp32:

* ``apply_conv`` — activation codes equal; outputs within 1e-5 of the
  largest |y| (the conv's fp32 sums in another order);
* the A2Q layers of these two checks and the layer-by-layer one run with
  every ``t`` 0.05 below its initial value (``_off_ties``): the initializer
  sets ``t = log2 ||w||_1`` on every column under its cap, which puts the
  column's largest weight at exactly ``2^(M-1) - 1``, where one ulp of
  ``exp2`` (the packages' differ, ROADMAP queue 3) truncates it to one code
  or the next; ``tests/test_torch_lut.py`` holds those codes (flips counted
  and explained);
* whole networks in mode ``none`` — within 1e-4 of the largest |y|
  (the sum-order error carried through up to 28 layers and their batch
  norms, which divide by a batch std that can be small);
* A2Q networks layer by layer, each conv and linear fed JAX's own input
  (a tie-rounded activation code would otherwise carry through depth) —
  the codes of that input equal, outputs within 1e-5 of the largest |y|;
* one A2Q train step — loss rtol 1e-5, every gradient leaf within 1e-4 of
  its largest |g| (ResNet18's activation scales 1e-3, see its test); every
  A2Q column's ``t`` is first moved off its norm caps, so no ``min(t, T)``
  or ``max(t - T, 0)`` sits at a tie (the caps are one ulp apart across
  the packages);
* ``vision_penalty`` with ``t`` raised — rtol 1e-5 (each term ``t - T``
  cancels two values near 16 to about 0.5, so one ulp of them, 1.9e-6, is
  4e-6 of a term).
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core.a2q import a2q_norm_cap as ja2q_norm_cap
from repro.core.quantizers import act_quant_int as jact_quant_int
from repro.data.synthetic import ImageClassStream as JImageClassStream
from repro.data.synthetic import SuperResStream as JSuperResStream
from repro.models import vision as jvision
from repro.nn import linear as jlinear
from repro.nn.module import unbox
from repro.optim.optimizers import adamw as jadamw

from repro_torch.configs.base import QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core.a2q import a2q_norm_cap
from repro_torch.core.bounds import l1_budget
from repro_torch.core.quantizers import act_quant_int
from repro_torch.data.synthetic import BinaryMnistStream, SuperResStream
from repro_torch.models import vision
from repro_torch.nn import linear as tlinear
from repro_torch.nn.module import keystr, tree_leaves_with_path, tree_map, tree_to
from repro_torch.optim.optimizers import adamw
from repro_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
# the hidden widths of the chip run's A2Q networks, at a P their init caps
A2Q = dict(mode="a2q", weight_bits=6, act_bits=6, acc_bits=16)
KW = {"mobilenetv1": {"width": 0.25}, "resnet18": {"width": 0.125}, "espcn": {},
      "unet": {"base": 8}, "linear": {}}
JINIT = {**{k: v[0] for k, v in jvision.VISION_MODELS.items()},
         "linear": jvision.init_linear_classifier}
JAPPLY = {**{k: v[1] for k, v in jvision.VISION_MODELS.items()},
          "linear": jvision.apply_linear_classifier}
TAPPLY = {**{k: v[1] for k, v in vision.VISION_MODELS.items()},
          "linear": vision.apply_linear_classifier}
MODELS = ("mobilenetv1", "resnet18", "espcn", "unet", "linear")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _q(mode="a2q", **kw):
    cfg = {**A2Q, "mode": mode, **kw}
    return JQuantConfig(**cfg), QuantConfig(**cfg)


@functools.cache
def _params(model, mode):
    """(JAX quant config, port config, JAX params as numpy; the init jitted:
    eager JAX dispatches it op by op, 3x slower)."""
    jq, tq = _q(mode)
    return jq, tq, _np(jax.jit(lambda k: unbox(JINIT[model](k, jq, **KW[model])))(KEY))


def _batch(model, B=2):
    if model in ("mobilenetv1", "resnet18"):
        b = JImageClassStream(global_batch=B, seed=1).batch(0)
        return {"x": b["x"], "y": b["y"]}
    if model == "linear":
        return BinaryMnistStream(global_batch=B, seed=1).batch(0)
    b = JSuperResStream(global_batch=B, hr=24, seed=1).batch(0)
    return {"lr": b["lr"], "hr": b["hr"]}


def _off_ties(tree):
    """A numpy tree with every A2Q layer's ``t`` 0.05 lower (see above)."""
    out = jax.tree.map(np.copy, tree)
    for node, _ in _a2q_layers(out):
        node["t"][...] = node["t"] - np.float32(0.05)
    return out


def _in(batch):
    return batch["x"] if "x" in batch else batch["lr"]


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


# --- tree helpers ------------------------------------------------------------


def test_tree_helpers_walk_lists_in_jax_order(tmp_path):
    """A vision tree (lists of blocks) survives ``from_jax_numpy`` whole;
    ``tree_leaves_with_path`` gives ``tree_flatten_with_path``'s leaves in
    its order, keys spelled as ``keystr`` spells them; ``tree_map``,
    ``tree_to``, the optimizers and a checkpoint round trip walk the lists."""
    _, _, ref = _params("resnet18", "a2q")
    port = from_jax_numpy(ref)
    assert isinstance(port["blocks"], list) and len(port["blocks"]) == len(ref["blocks"])
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    mine = tree_leaves_with_path(port)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [keystr(p) for p, _ in mine]
    for (_, a), (_, b) in zip(flat, mine):
        np.testing.assert_array_equal(b.numpy(), a)
    doubled = tree_map(lambda a, b: a + b, port, tree_to(port, "cpu"))
    assert isinstance(doubled["blocks"], list)
    torch.testing.assert_close(doubled["blocks"][3]["c1"]["v"], 2 * port["blocks"][3]["c1"]["v"])
    opt = adamw()
    state = opt.init(port)
    new, state = opt.update(tree_map(torch.ones_like, port), state, port, 1e-3)
    assert isinstance(new["blocks"], list) and isinstance(state["m"]["blocks"], list)
    ckpt.save(str(tmp_path), new, step=1)
    back, step = ckpt.restore(str(tmp_path), port)
    assert step == 1
    for (_, a), (_, b) in zip(tree_leaves_with_path(back), tree_leaves_with_path(new)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- apply_conv --------------------------------------------------------------

# (c_in, c_out, kernel, stride, H, groups, mode, boundary, bias, padding)
CONV_CASES = {
    "k3s1-odd-a2q": (8, 16, 3, 1, 9, 1, "a2q", False, False, "SAME"),
    "k3s2-even-a2q-bias": (8, 16, 3, 2, 8, 1, "a2q", False, True, "SAME"),
    "k5s1-boundary-a2q": (1, 16, 5, 1, 8, 1, "a2q", True, False, "SAME"),
    "k1s2-odd-qat": (16, 8, 1, 2, 7, 1, "qat", False, False, "SAME"),
    "dw3s2-odd-a2q": (16, 16, 3, 2, 9, 16, "a2q", False, False, "SAME"),
    "dw3s1-none-bias": (16, 16, 3, 1, 8, 16, "none", False, True, "SAME"),
    "k3s2-even-qat-boundary-bias": (3, 8, 3, 2, 10, 1, "qat", True, True, "SAME"),
    "k3s2-valid-a2q": (8, 8, 3, 2, 9, 1, "a2q", False, False, "VALID"),
    "k3s1-deployed-a2q-bias": (8, 16, 3, 1, 8, 1, "deployed", False, True, "SAME"),
    "dw3s2-deployed-boundary": (16, 16, 3, 2, 8, 16, "deployed", True, False, "SAME"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_apply_conv_matches_jax(case):
    c_in, c_out, k, stride, H, groups, mode, boundary, bias, padding = CONV_CASES[case]
    jq, tq = _q("a2q" if mode == "deployed" else mode)
    p = _np(unbox(jlinear.init_conv(jax.random.PRNGKey(len(case)), c_in, c_out, (k, k), jq,
                                    groups=groups, use_bias=bias, boundary=boundary)))
    rng = np.random.default_rng(len(case))
    if bias:
        p["b"] = rng.normal(size=c_out).astype(np.float32)
    p = _off_ties(p)
    if mode == "deployed":
        p = _np(jlinear.deploy_linear(jax.tree.map(jnp.asarray, p), jq, boundary=boundary,
                                      input_signed=False))
    # ReLU-like inputs with a few negatives (the unsigned quantizer clips them)
    x = (np.abs(rng.normal(size=(2, H, H + 1, c_in))) * 2 - 0.2).astype(np.float32)
    kw = dict(stride=(stride, stride), padding=padding, groups=groups, boundary=boundary)
    want = np.asarray(jlinear.apply_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jq, **kw))
    got = tlinear.apply_conv(from_jax_numpy(p), torch.from_numpy(x), tq, **kw)
    _close(got, want, 1e-5, case)
    if "aq" in p:
        N = 8 if boundary else jq.act_bits
        jc, _ = jact_quant_int({"log2_scale": jnp.asarray(p["aq"]["log2_scale"])},
                               jnp.asarray(x), N, False)
        tc, _ = act_quant_int({"log2_scale": torch.from_numpy(p["aq"]["log2_scale"])},
                              torch.from_numpy(x), N, False)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("hw", [(8, 6), (9, 7)])
def test_pool_and_resize_match_jax(hw):
    """UNet's max pool (``reduce_window`` with ``-inf``, 2x2 stride 2,
    ``"SAME"``: odd edges pad after) and the NNRC resize (``jax.image.resize``
    nearest at factors 2 and 3) bit for bit."""
    H, W = hw
    x = np.random.default_rng(H).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "SAME")
    np.testing.assert_array_equal(vision._max_pool_same(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    for f in (2, 3):
        np.testing.assert_array_equal(vision._nn_resize(torch.from_numpy(x), f).numpy(),
                                      np.asarray(jvision._nn_resize(jnp.asarray(x), f)))


# --- whole networks, mode none ----------------------------------------------


@functools.cache
def _jit_apply(model, mode):
    jq = _params(model, mode)[0]
    return jax.jit(lambda p, x: JAPPLY[model](p, x, jq))


@pytest.mark.parametrize("model", MODELS)
def test_float_network_matches_jax(model):
    mode = "none"
    _, tq, p = _params(model, mode)
    x = _in(_batch(model))
    want = np.asarray(_jit_apply(model, mode)(p, jnp.asarray(x)))
    got = TAPPLY[model](from_jax_numpy(p), torch.from_numpy(x), tq)
    _close(got, want, 1e-4, model)


# --- A2Q networks, layer by layer -------------------------------------------


@functools.cache
def _jax_layers(model):
    """JAX's A2Q forward (``t`` off the ties), jitted, returning every conv's
    and linear's ``(input, output)`` in call order."""
    jq, _, p = _params(model, "a2q")
    p = _off_ties(p)

    def run(p, x):
        rec = []

        def recorded(fn):
            def call(params, x, q, **kw):
                y = fn(params, x, q, **kw)
                rec.append((x, y))
                return y
            return call

        with mock.patch.object(jvision, "apply_conv", recorded(jlinear.apply_conv)), \
                mock.patch.object(jvision, "apply_linear", recorded(jlinear.apply_linear)):
            out = JAPPLY[model](p, x, jq)
        return out, rec

    out, rec = jax.jit(run)(p, jnp.asarray(_in(_batch(model))))
    return np.asarray(out), [(np.asarray(a), np.asarray(b)) for a, b in rec]


@pytest.mark.parametrize("model", MODELS)
def test_a2q_network_layer_by_layer_matches_jax(model):
    """The port's ``apply_*`` runs whole; each conv and linear it calls
    takes JAX's input to that layer (same call order) and its output is
    held to JAX's: the activation codes equal, the output within 1e-5."""
    jq, tq, p = _params(model, "a2q")
    p = _off_ties(p)
    _, rec = _jax_layers(model)
    calls = iter(rec)
    seen = []

    def held(fn):
        def call(params, x, q, **kw):
            xj, yj = next(calls)
            boundary = kw.get("boundary", False)
            N = 8 if boundary else tq.act_bits
            signed = kw.get("input_signed", False)
            xt = torch.from_numpy(xj)
            if "aq" in params:
                tc, _ = act_quant_int(params["aq"], xt, N, signed)
                jaq = {"log2_scale": jnp.asarray(params["aq"]["log2_scale"].numpy())}
                jc, _ = jact_quant_int(jaq, jnp.asarray(xj), N, signed)
                np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            y = fn(params, xt, q, **kw)
            _close(y, yj, 1e-5, f"{model} layer {len(seen)}")
            seen.append(tuple(y.shape))
            return y
        return call

    with mock.patch.object(vision, "apply_conv", held(tlinear.apply_conv)), \
            mock.patch.object(vision, "apply_linear", held(tlinear.apply_linear)):
        TAPPLY[model](from_jax_numpy(p), torch.from_numpy(_in(_batch(model))), tq)
    assert len(seen) == len(rec) and next(calls, None) is None


# --- one A2Q train step ------------------------------------------------------


def _a2q_layers(tree, top=None):
    """``(node, boundary)`` of every A2Q layer of a vision tree."""
    if isinstance(tree, dict):
        if "v" in tree and "t" in tree:
            yield tree, top
            return
        for k, v in tree.items():
            yield from _a2q_layers(v, k if top is None else "")
    elif isinstance(tree, list):
        for v in tree:
            yield from _a2q_layers(v, "")


BOUNDARY = {"mobilenetv1": ("stem", "head"), "resnet18": ("stem", "head"),
            "espcn": ("c1", "out"), "unet": ("stem", "out")}


def _pushed(model, p, jq):
    """A copy with every A2Q column off its caps: columns 0, 3, 6, ... with
    ``t`` 3.5 above the apply cap (past the penalty's cap too, which is 1 to
    3 above it: signed inputs at the hidden width), the rest 0.05 and 0.1
    below it."""
    out = jax.tree.map(np.copy, p)
    for node, top in _a2q_layers(out):
        N = 8 if top in BOUNDARY[model] else jq.act_bits
        T = np.asarray(ja2q_norm_cap(jnp.asarray(node["d"]), jq.acc_bits, N, False))
        cols = np.arange(node["t"].shape[-1]) % 3
        node["t"][...] = T + np.where(cols == 0, 3.5, np.where(cols == 1, -0.05, -0.1))
    return out


def _jax_loss(model, jq):
    def loss(p, batch):
        if "y" in batch:
            logits = JAPPLY[model](p, batch["x"], jq)
            onehot = jax.nn.one_hot(batch["y"], logits.shape[-1])
            out = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))
        else:
            out = jnp.mean((JAPPLY[model](p, batch["lr"], jq) - batch["hr"]) ** 2)
        return out + jq.reg_lambda * jvision.vision_penalty(p, jq)
    return loss


def test_a2q_train_step_matches_jax_espcn():
    """ESPCN whole: the loss (MSE + the penalty) and every gradient leaf
    against ``jax.grad``, then one step of the port's
    ``build_vision_train_step`` against the reference's adamw update."""
    model = "espcn"
    jq, tq, p = _params(model, "a2q")
    p = _pushed(model, p, jq)
    batch = _batch(model)
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(model, jq)))(
        p, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(p))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = vision.vision_loss(live, model, tb, tq)
    leaves = tree_leaves_with_path(live)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves], materialize_grads=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(jvision.vision_penalty(p, jq)) > 0  # the pushed columns reach the penalty
    flat, _ = jax.tree_util.tree_flatten_with_path(_np(jg))
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [keystr(k) for k, _ in leaves]
    for (path, want), got in zip(flat, grads):
        _close(got, want, 1e-4, f"{model} grad {jax.tree_util.keystr(path)}")

    opt = adamw()
    new, _, _ = vision.build_vision_train_step(model, tq, opt, 1e-3)(
        from_jax_numpy(p), opt.init(from_jax_numpy(p)), tb)
    jopt = jadamw()
    want, _ = jopt.update(jg, jopt.init(p), jax.tree.map(jnp.asarray, p), 1e-3)
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(_np(want))[0],
                                 tree_leaves_with_path(new)):
        _close(g, w, 1e-5, f"{model} updated {jax.tree_util.keystr(path)}")


LAYER_FNS = ("apply_conv", "apply_linear", "_bn")


def _jax_probed(model, jq, p, batch):
    """``jax.value_and_grad`` of the reference's loss with a zero probe
    added to every conv's, linear's and batch norm's output: returns the
    loss, the param gradients, each layer's cotangent (the probe's
    gradient) and each layer's input, in call order."""
    fns = {"apply_conv": jlinear.apply_conv, "apply_linear": jlinear.apply_linear,
           "_bn": jvision._bn}

    def loss(p, probes, batch):
        ins = []
        it = iter(probes) if probes is not None else None

        def probed(fn):
            def call(params, x, *a, **kw):
                ins.append(x)
                y = fn(params, x, *a, **kw)
                return y if it is None else y + next(it)
            return call

        with contextlib.ExitStack() as stack:
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(jvision, name, probed(fn)))
            out = _jax_loss(model, jq)(p, batch)
        return out, ins

    jb = jax.tree.map(jnp.asarray, batch)
    _, ins = jax.eval_shape(lambda p, b: loss(p, None, b), p, jb)
    # each layer's output has its input's shape but for its own channels: probe by eval_shape
    outs = []

    def shapes(p, b):
        ys = []

        def rec(fn):
            def call(params, x, *a, **kw):
                y = fn(params, x, *a, **kw)
                ys.append(y)
                return y
            return call

        with contextlib.ExitStack() as stack:
            for name, fn in fns.items():
                stack.enter_context(mock.patch.object(jvision, name, rec(fn)))
            _jax_loss(model, jq)(p, b)
        return ys

    outs = jax.eval_shape(shapes, p, jb)
    probes = [jnp.zeros(o.shape, o.dtype) for o in outs]
    (jl, ins), (jg, dys) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        p, probes, jb)
    return float(jl), _np(jg), [np.asarray(d) for d in dys], [np.asarray(x) for x in ins]


def test_a2q_train_step_layer_by_layer_matches_jax_resnet18():
    """ResNet18 (width 0.125): through 26 A2Q layers and their batch norms a
    tie-rounded activation code carries on (queue 3, "A2Q at rounding
    ties"), so each conv, linear and batch norm of the port's
    ``vision_loss`` takes JAX's input to it and JAX's cotangent of its
    output: its parameters' vector-Jacobian product plus the penalty's
    gradient equals ``jax.grad``'s leaf (within 1e-4 of its largest |g|; an
    activation scale's within 1e-3 of it: that 0-dim gradient is one sum,
    over every element of the layer's input, of terms of both signs that
    cancel to 1e-2-1e-4 of their magnitude, in another fp32 order in each
    package), every leaf of the tree is reached once, and the loss computed
    from the head's output agrees to rtol 1e-5."""
    model = "resnet18"
    jq, tq, p = _params(model, "a2q")
    p = _pushed(model, p, jq)
    batch = _batch(model)
    jl, jg, dys, ins = _jax_probed(model, jq, p, batch)
    live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(p))
    path_of = {}
    for path, leaf in tree_leaves_with_path(live):
        path_of[id(leaf)] = keystr(path)
    pen = vision.vision_penalty(live, tq) * tq.reg_lambda
    got = {}
    for path, leaf in tree_leaves_with_path(live):
        g, = torch.autograd.grad(pen, [leaf], retain_graph=True, materialize_grads=True)
        got[keystr(path)] = g
    calls = iter(zip(ins, dys))
    fns = {"apply_conv": tlinear.apply_conv, "apply_linear": tlinear.apply_linear,
           "_bn": vision._bn}

    def held(fn):
        def call(params, x, *a, **kw):
            xj, dy = next(calls)
            y = fn(params, torch.from_numpy(xj), *a, **kw)
            leaves = [leaf for _, leaf in tree_leaves_with_path(params)]
            for leaf, g in zip(leaves, torch.autograd.grad(
                    y, leaves, torch.from_numpy(dy), retain_graph=True, materialize_grads=True)):
                got[path_of[id(leaf)]] = got[path_of[id(leaf)]] + g
            return y
        return call

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with contextlib.ExitStack() as stack:
        for name, fn in fns.items():
            stack.enter_context(mock.patch.object(vision, name, held(fn)))
        loss = vision.vision_loss(live, model, tb, tq)
    assert next(calls, None) is None
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in flat)
    for path, want in flat:
        k = jax.tree_util.keystr(path)
        _close(got[k], want, 1e-3 if k.endswith("['aq']['log2_scale']") else 1e-4, f"grad {k}")


@pytest.mark.parametrize("model", ["mobilenetv1", "resnet18", "espcn", "unet"])
def test_vision_penalty_keeps_the_reference_walk(model):
    """Every layer's ``t`` raised by 3.5 (3 would put a boundary layer's
    capped columns at a tie of the penalty's cap, which is 3 above the
    apply cap there): the port's ``vision_penalty`` equals the reference's
    (rtol 1e-5), which walks dicts only and caps at the hidden width with
    signed inputs — so the layers inside lists add 0 — and it is below the
    sum over every A2Q layer at its own cap."""
    jq, tq, p = _params(model, "a2q")
    raised = jax.tree.map(np.copy, p)
    for node, _ in _a2q_layers(raised):
        node["t"][...] = node["t"] + np.float32(3.5)
    want = float(jvision.vision_penalty(raised, jq))
    port = from_jax_numpy(raised)
    got = float(vision.vision_penalty(port, tq))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tops = {k: v for k, v in port.items() if not isinstance(v, list)}
    assert float(vision.vision_penalty(tops, tq)) == got  # the lists add nothing
    full = 0.0
    for node, top in _a2q_layers(from_jax_numpy(raised)):
        N = 8 if top in BOUNDARY[model] else tq.act_bits
        T = a2q_norm_cap(node["d"], tq.acc_bits, N, False)
        full += float(torch.clamp_min(node["t"] - T, 0).sum())
    assert got < full


# --- the reference's trainability checks, on the port -----------------------


def test_linear_classifier_trains_on_binary_mnist():
    """The paper's App. A setup learns to more than 0.85 in 60 adamw steps
    with a 32-bit accumulator (the reference's ``test_vision.py`` check)."""
    q = QuantConfig(mode="qat", weight_bits=8, act_bits=1, acc_bits=32)
    p = vision.init_linear_classifier(torch.Generator().manual_seed(0), q, device="cpu")
    stream = BinaryMnistStream(global_batch=128, seed=0)
    opt = adamw()
    state = opt.init(p)
    step = vision.build_vision_train_step("linear", q, opt, 5e-3)
    for i in range(60):
        b = stream.batch(i)
        p, state, loss = step(p, state, {"x": torch.from_numpy(b["x"]),
                                         "y": torch.from_numpy(b["y"])})
        assert torch.isfinite(loss)
    test = stream.batch(10_000)
    logits = vision.apply_linear_classifier(p, torch.from_numpy(test["x"]), q)
    acc = float((logits.argmax(-1).numpy() == test["y"]).mean())
    assert acc > 0.85, acc


def test_a2q_espcn_training_keeps_the_budget():
    """After 10 A2Q adamw steps (M=N=6, P=14) every deployed column of ESPCN
    keeps Eq. 15's budget at its layer's own widths (unsigned inputs), as
    the reference's ``test_vision.py`` checks after its steps."""
    q = QuantConfig(mode="a2q", weight_bits=6, act_bits=6, acc_bits=14)
    p = vision.init_espcn(torch.Generator().manual_seed(0), q, device="cpu")
    stream = SuperResStream(global_batch=4, hr=24)
    opt = adamw()
    state = opt.init(p)
    step = vision.build_vision_train_step("espcn", q, opt, 1e-3)
    losses = []
    for i in range(10):
        b = stream.batch(i)
        p, state, loss = step(p, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    dep = vision.deploy_vision(p, q, "espcn")
    for name, node in dep.items():
        N = 8 if name in ("c1", "out") else q.act_bits
        col = node["q8"].to(torch.int64).abs().reshape(-1, node["q8"].shape[-1]).sum(0)
        assert (col <= l1_budget(q.acc_bits, N, False)).all(), name
