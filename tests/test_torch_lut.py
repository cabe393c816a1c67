"""The port's deploy of the vision networks' conv layers and its accounting
(``core/sparsity.py``, ``core/lut.py``, ``layer_geometries``,
``requantize_from_float``) against the JAX package on the CPU.

* Conv codes at the networks' own full-width leaf shapes (K=9 depthwise, the
  K=25 and K=27 stems, C_out=1 and 10, K=4608): ``deploy_linear``'s codes
  equal the reference's, or differ by flips that ``code_flips_explained``
  explains (the port sums each column's l1 norm in ``pairwise_sum``'s
  order, XLA in its own, and the packages' ``exp2`` differ in the last
  bits: an element within a few ulps of an integer truncates either way);
  the count is stated per shape (``_flips`` folds both packages' ``g/s``
  into the check).  ``s8`` within 8 fp32 ulps (``exp2`` of the two
  libraries, ROADMAP queue 3; 4 seen here); every column's ``sum |q|``
  within ``l1_budget``.
* Accounting on one tree per network, trained one adamw step by the port
  and deployed by both packages: the codes equal up to explained flips
  (the count stated per network); ``tree_sparsity``'s keys, order and
  numbers, ``pack_sparse_count`` and ``model_luts`` equal the reference's
  on the same inputs; ``layer_geometries`` equal, its sparsities up to the
  flips of the codes it counts; the deployed forward equals the
  fake-quant forward bit for bit.
* ``requantize_from_float`` — ``v``/``w`` equal, the log2 scales and norms
  rtol 1e-6 (``log2`` of two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuantConfig
from repro.core import lut as jlut
from repro.core.a2q import _effective_gs as jeffective_gs
from repro.core.a2q import a2q_int_weights as ja2q_int_weights
from repro.core import sparsity as jsparsity
from repro.models import vision as jvision
from repro.nn import linear as jlinear
from repro.nn.module import unbox

from repro_torch.configs.base import QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.core import lut, sparsity
from repro_torch.core.a2q import _effective_gs, a2q_int_weights, pairwise_sum
from repro_torch.core.bounds import l1_budget
from repro_torch.data.synthetic import ImageClassStream, SuperResStream
from repro_torch.kernels.a2q_quantize import code_flips_explained
from repro_torch.models import vision
from repro_torch.nn.linear import deploy_linear
from repro_torch.nn.module import tree_map
from repro_torch.optim.optimizers import adamw

torch.set_num_threads(1)

A2Q = dict(mode="a2q", weight_bits=6, act_bits=6, acc_bits=16)
JQ, TQ = JQuantConfig(**A2Q), QuantConfig(**A2Q)
KW = {"mobilenetv1": {"width": 0.25}, "resnet18": {"width": 0.125}, "espcn": {},
      "unet": {"base": 8}}
BOUNDARY = {"mobilenetv1": ("stem", "head"), "resnet18": ("stem", "head"),
            "espcn": ("c1", "out"), "unet": ("stem", "out")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t2np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _flips(node, N, q, q_ref):
    """``(flips, explained)`` of the port's codes ``q`` against the
    reference's ``q_ref`` for one A2Q layer ``node`` (numpy ``v, t, d``) at
    input width ``N``, unsigned: ``code_flips_explained`` with the
    reference's effective divisor ``l1_ref * gs / gs_ref``, so its
    near-integer test sees the reference's ``gs_ref * v / l1_ref`` and its
    slack both l1 sums' and both ``g/s``'s differences (the packages' ``exp2``
    and ``log2`` differ by a few ulps)."""
    C = node["v"].shape[-1]
    v = torch.from_numpy(node["v"]).reshape(-1, C)
    gs, _ = _effective_gs({k: torch.from_numpy(node[k]) for k in "td"}, TQ.acc_bits, N, False)
    jgs, _ = jeffective_gs({k: jnp.asarray(node[k]) for k in "td"}, JQ.acc_bits, N, False)
    l1_ref = np.asarray(jnp.sum(jnp.abs(jnp.asarray(node["v"])).reshape(-1, C), axis=0))
    l1_eff = torch.from_numpy(l1_ref) * gs / torch.from_numpy(np.asarray(jgs))
    q = torch.as_tensor(q).reshape(-1, C)
    q_ref = torch.as_tensor(np.asarray(q_ref)).reshape(-1, C)
    return code_flips_explained(q, q_ref, v, gs, pairwise_sum(v.abs()), l1_eff)


# --- conv codes at the networks' leaf shapes ---------------------------------

# site -> (c_in, c_out, kernel, groups, boundary, expected code flips); kernel
# None is a linear head
SHAPES = {
    # the initializer puts every uncapped column's largest weight at exactly
    # 2^(M-1) - 1, where the packages' g/s (a few ulps apart) truncate it to
    # one code or the next: K=9 leaves every column under its cap
    "mobilenetv1 dw K=9 C=1024": (1024, 1024, 3, 1024, False, 250),
    "espcn c1 K=25 C=64": (1, 64, 5, 1, True, 0),
    "mobilenetv1 stem K=27 C=32": (3, 32, 3, 1, True, 0),
    "resnet18 stem K=27 C=64": (3, 64, 3, 1, True, 0),
    "espcn out K=288 C=1": (32, 1, 3, 1, True, 0),
    "mobilenetv1 head K=1024 C=10": (1024, 10, None, 1, True, 0),
    "resnet18 c2 K=4608 C=512": (512, 512, 3, 1, False, 0),
}


@pytest.mark.parametrize("site", list(SHAPES))
def test_conv_deploy_codes_match_jax(site):
    c_in, c_out, k, groups, boundary, want_flips = SHAPES[site]
    key = jax.random.PRNGKey(len(site))
    if k is None:
        p = jlinear.init_linear(key, c_in, c_out, JQ, axes=(None, None), boundary=boundary,
                                input_signed=False, use_bias=True)
    else:
        p = jlinear.init_conv(key, c_in, c_out, (k, k), JQ, groups=groups, boundary=boundary)
    p = _np(unbox(p))
    ref = _np(jlinear.deploy_linear(jax.tree.map(jnp.asarray, p), JQ, boundary=boundary,
                                    input_signed=False))
    tp = from_jax_numpy(p)
    got = deploy_linear(tp, TQ, boundary=boundary, input_signed=False)
    assert got["q8"].dtype == torch.int8 and tuple(got["q8"].shape) == p["v"].shape
    N = 8 if boundary else TQ.act_bits
    flips, explained = _flips(p, N, got["q8"], ref["q8"])
    assert explained and flips == want_flips, (flips, explained)
    np.testing.assert_array_max_ulp(got["s8"].numpy(), ref["s8"], maxulp=8)
    col = got["q8"].to(torch.int64).abs().reshape(-1, c_out).sum(0)
    assert (col <= l1_budget(TQ.acc_bits, N, False)).all()
    if "b" in p:
        np.testing.assert_array_equal(got["b"].numpy(), p["b"])


# --- accounting on a trained and deployed tree --------------------------------


def _jax_deploy(tree, model):
    """The reference's ``deploy_linear`` over a vision tree, at the widths
    its apply uses (boundary layers at 8 bits, unsigned inputs)."""
    def walk(node, top):
        if isinstance(node, dict):
            if {"v", "t", "d"} <= set(node):
                return _np(jlinear.deploy_linear(jax.tree.map(jnp.asarray, node), JQ,
                                                 boundary=top in BOUNDARY[model],
                                                 input_signed=False))
            return {k: walk(v, k if top is None else "") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, "") for v in node]
        return node
    return walk(tree, None)


def _codes(tree):
    """The deployed tree's integer weights only, in its structure."""
    if isinstance(tree, dict):
        if "q8" in tree:
            return tree["q8"]
        out = {k: _codes(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if not (v is None or isinstance(v, dict) and not v)}
    if isinstance(tree, list):
        return [_codes(v) for v in tree]
    return None


def _trained(model):
    """One port adamw step from a port init, and its batch."""
    init, _ = vision.VISION_MODELS[model]
    p = init(torch.Generator().manual_seed(3), TQ, device="cpu", **KW[model])
    if model in ("mobilenetv1", "resnet18"):
        b = ImageClassStream(global_batch=2, seed=2).batch(0)
    else:
        b = SuperResStream(global_batch=2, hr=24, seed=2).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    opt = adamw()
    p, _, _ = vision.build_vision_train_step(model, TQ, opt, 1e-3)(p, opt.init(p), batch)
    return p, batch


def _a2q_pairs(tree, other, top=None):
    """``(node, other's node, boundary)`` of every A2Q layer of a param tree,
    walked beside a second tree of the same structure."""
    if isinstance(tree, dict):
        if {"v", "t", "d"} <= set(tree):
            yield tree, other, top
            return
        for k, v in tree.items():
            yield from _a2q_pairs(v, other[k], k if top is None else "")
    elif isinstance(tree, list):
        for v, o in zip(tree, other):
            yield from _a2q_pairs(v, o, "")


# explained code flips of each trained tree's deploy against the reference's
DEPLOY_FLIPS = {"mobilenetv1": 4, "resnet18": 0, "espcn": 0, "unet": 0}


@pytest.mark.parametrize("model", list(KW))
def test_accounting_matches_reference(model):
    """One tree per network, trained one port adamw step: deployed by both
    packages, every layer's codes equal up to explained flips; then each
    accounting function of the port, on the port's codes, trees and
    geometries, returns what the reference's returns on the same inputs
    (keys, order and numbers exactly), and ``layer_geometries`` itself
    equals the reference's up to the flips of the codes it counts."""
    params, batch = _trained(model)
    ref = _t2np(params)
    dep = vision.deploy_vision(params, TQ, model)
    jdep = _jax_deploy(ref, model)
    flips = 0
    for (node, jnode, top), (_, pnode, _) in zip(_a2q_pairs(ref, jdep), _a2q_pairs(ref, dep)):
        N = 8 if top in BOUNDARY[model] else TQ.act_bits
        n, ok = _flips(node, N, pnode["q8"], jnode["q8"])
        assert ok, (model, top)
        flips += n
    assert flips == DEPLOY_FLIPS[model], flips

    codes = _codes(dep)
    got = sparsity.tree_sparsity(codes)
    want = jsparsity.tree_sparsity(_t2np(codes))
    assert list(got["per_leaf"]) == list(want["per_leaf"]) and got == want
    if model in ("mobilenetv1", "resnet18"):
        assert "['blocks'][0]['dw']" in got["per_leaf"] or "['blocks'][0]['c1']" in got["per_leaf"]
    for a in jax.tree.leaves(_t2np(codes)):
        assert sparsity.pack_sparse_count(torch.from_numpy(a)) == jsparsity.pack_sparse_count(a)
        assert sparsity.tensor_sparsity(a) == jsparsity.tensor_sparsity(a)

    geoms = vision.layer_geometries(params, TQ)
    # numpy leaves as they are: jax.tree.map would rebuild the dicts in sorted
    # key order, and layer_geometries walks a dict in its own order
    jgeoms = jvision.layer_geometries(ref, JQ)
    assert len(geoms) == len(jgeoms)
    for g, jg, (node, _, _) in zip(geoms, jgeoms, _a2q_pairs(ref, ref)):
        q, _ = a2q_int_weights({k: torch.from_numpy(node[k]) for k in "vtd"}, TQ.weight_bits,
                               TQ.acc_bits, TQ.act_bits, False)
        jq, _ = ja2q_int_weights({k: jnp.asarray(node[k]) for k in "vtd"}, JQ.weight_bits,
                                 JQ.acc_bits, JQ.act_bits, False)
        n, ok = _flips(node, TQ.act_bits, q, np.asarray(jq))
        assert ok
        assert {**g.__dict__, "sparsity": 0} == {**jg.__dict__, "sparsity": 0}
        assert abs(g.sparsity - jg.sparsity) * q.numel() <= n
    for P in (16, 32):
        g2 = [lut.LayerGeometry(**{**g.__dict__, "acc_bits": P}) for g in geoms]
        j2 = [jlut.LayerGeometry(**g.__dict__) for g in g2]
        for exploit in (False, True):
            assert lut.model_luts(g2, exploit) == jlut.model_luts(j2, exploit)

    # the deployed tree runs through the same apply, its q8 * s8 weights the
    # fake-quant weights exactly
    x = batch["x"] if "x" in batch else batch["lr"]
    apply = vision.VISION_MODELS[model][1]
    with torch.no_grad():
        torch.testing.assert_close(apply(dep, x, TQ), apply(params, x, TQ), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["a2q", "qat"])
def test_requantize_from_float_matches_reference(mode):
    jf = JQuantConfig(mode="none")
    jq = JQuantConfig(**{**A2Q, "mode": mode})
    tq = QuantConfig(**{**A2Q, "mode": mode})
    key = jax.random.PRNGKey(5)
    fl = _np(unbox(jvision.init_espcn(key, jf)))
    fresh = _np(unbox(jvision.init_espcn(jax.random.PRNGKey(6), jq)))
    want = _np(jvision.requantize_from_float(fresh, fl, jq))
    got = _t2np(vision.requantize_from_float(from_jax_numpy(fresh), from_jax_numpy(fl), tq))
    flat_w, tw = jax.tree_util.tree_flatten_with_path(want)
    flat_g, tg = jax.tree_util.tree_flatten_with_path(got)
    assert tw == tg
    for (path, a), (_, b) in zip(flat_w, flat_g):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['t']", "['d']", "['log2_scale']")):
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
