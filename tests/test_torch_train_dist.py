"""The port's compressed data-parallel train step and its state against the
JAX package on the CPU.

* ``build_train_step(arch, opt, Runtime(mesh, rules, grad_compress))`` on
  reduced smollm-135m with a data axis of four groups on one device,
  against the reference's jitted step on four fake devices (one JAX
  process, a module fixture; ``REF_XLA_FLAGS`` as
  ``tests/test_torch_dist.py``'s): two adamw steps from the same params and
  batches, int8 on the ``tensor`` scale.  The reference's wire
  codes (read at its reshards) are fed to the port's quantizer, as
  ``tests/test_torch_train_moe.py``'s ``reference_codes`` feeds activation
  codes: a gradient the two packages carry an ulp apart can sit at a
  rounding tie of ``y / scale``, and one code apart moves adam's update of
  that element by up to the lr.  Each fed code must be the port's own or
  one apart within ``ERR_TOL * qmax`` codes of a tie (counted).  Losses within 1e-4, params within
  ``PARAM_TOL`` of each leaf's largest |p|, both residual trees nonzero and
  within ``ERR_TOL`` of the largest |payload| their phase quantized (a
  residual carries its gradient's difference between the packages, which
  sum in other orders: up to 3.5e-4 of a leaf's own payload in the second
  step, 8.4e-4 of an activation scale's, whose gradient cancels to a small
  part of its terms).
* ``init_grad_err`` and ``make_state_specs`` against the reference's for
  full-size trees (``meta`` tensors of the reference's shapes).
* The residual pair through a checkpoint, and an uncompressed checkpoint
  restored with ``allow_missing`` (the reference's slow test's cases).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_dist import REF_XLA_FLAGS, _boxed, _FakeMesh, _jspec_tree, _meta_like
from test_torch_train import _push
from test_torch_train_moe import _off_trunc_ties

from repro.configs import get_arch as jget_arch
from repro.dist import collectives as jcol
from repro.dist import sharding as jshard
from repro.optim import optimizers as jopt
from repro.train import state as jstate

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist import collectives as tcol
from repro_torch.dist.collectives import GradCompressConfig
from repro_torch.dist.sharding import Mesh, ShardingRules, param_specs
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.models.steps import build_train_step
from repro_torch.nn.module import keystr, tree_leaves_with_path, tree_map
from repro_torch.optim.optimizers import adafactor, adamw, sgdm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import init_grad_err, init_state, make_state_specs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, STEPS, LR, BATCH, SEQ = 4, 2, 2e-3, 8, 32
SCALES = ("tensor",)
PARAM_TOL = 1e-5  # of each leaf's largest |p|
ERR_TOL = 1e-4  # of the tree's largest |payload| in the phase (the gradient gates' 1e-4)

_JAX_STEP = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch, reduced
from repro.data.synthetic import TokenStream
from repro.dist import collectives as C
from repro.dist.collectives import GradCompressConfig
from repro.dist.sharding import ShardingRules, param_specs
from repro.models import Runtime, init_lm
from repro.models.steps import build_train_step
from repro.optim.optimizers import adamw
from repro.train.state import init_grad_err

cfg = json.loads(open(sys.argv[2]).read())
flat = dict(np.load(sys.argv[1]))
params = {}
for key, v in flat.items():
    node = params
    *head, last = key.split("/")
    for k in head:
        node = node.setdefault(k, {})
    node[last] = jnp.asarray(v)
arch = reduced(get_arch("smollm-135m"))
mesh = Mesh(np.array(jax.devices()), ("data",))
rules = ShardingRules.default(mesh, arch)
pspecs = param_specs(jax.eval_shape(lambda: init_lm(jax.random.PRNGKey(0), arch)), mesh, rules)
rec, traced = [], [0]
orig = C._constrain
def constrain(x, m, spec):  # numbered in trace order
    y = orig(x, m, spec)
    at, traced[0] = traced[0], traced[0] + 1
    jax.debug.callback(lambda v: rec.append((at, np.asarray(v))), y)
    return y
C._constrain = constrain
stream = TokenStream(vocab=arch.vocab, seq_len=cfg["seq"], global_batch=cfg["batch"])
out = {}
for scale in cfg["scales"]:
    opt = adamw()
    gc = GradCompressConfig(bits=8, scale_axis=scale, axis="data")
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32),
             "grad_err": init_grad_err(params, cfg["n"], pspecs=pspecs, axis="data")}
    step = jax.jit(build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules, grad_compress=gc),
                                    lr_schedule=lambda s: jnp.float32(cfg["lr"])))
    for i in range(cfg["steps"]):
        rec.clear()
        traced[0] = 0
        with mesh:
            state, m = step(state, {k: jnp.asarray(v) for k, v in stream.batch(i).items()})
        jax.effects_barrier()
        seen = [v for _, v in sorted(rec, key=lambda t: t[0])]
        leaves = jax.tree_util.tree_flatten_with_path(state["params"])[0]
        # the step's own constraints come first (the grouped batch), then 4 a leaf
        seen = seen[len(seen) - 4 * len(leaves):]
        for j, (path, _) in enumerate(leaves):
            key = "/".join(p.key for p in path)
            out[f"{scale}/{i}/q/{key}"] = seen[4 * j]
            out[f"{scale}/{i}/q2/{key}"] = seen[4 * j + 2]
        for k, v in m.items():
            out[f"{scale}/{i}/m/{k}"] = np.asarray(v)
        for tree in ("params",):
            for path, v in jax.tree_util.tree_flatten_with_path(state[tree])[0]:
                out[f"{scale}/{i}/{tree}/" + "/".join(p.key for p in path)] = np.asarray(v)
        for part in ("local", "server"):
            for path, v in jax.tree_util.tree_flatten_with_path(state["grad_err"][part])[0]:
                out[f"{scale}/{i}/{part}/" + "/".join(p.key for p in path)] = np.asarray(v)
np.savez(sys.argv[3], **out)
print("ok")
'''


def _key(path) -> str:
    return "/".join(str(k) for k in path)


@pytest.fixture(scope="module")
def model():
    """Reduced smollm-135m drawn by the port, every A2Q column's ``t`` moved
    off its cap (``_push``: at the cap the two packages split ``t``'s and
    ``d``'s gradients differently, which moves a leaf's whole wire scale)
    and every weight off a truncation tie (``_off_trunc_ties``)."""
    arch = reduced(get_arch("smollm-135m"))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    params, _ = _off_trunc_ties(_push(tree_map(lambda t: t.numpy(), params), arch), arch)
    return arch, tree_map(torch.from_numpy, params)


@pytest.fixture(scope="module")
def ref(model, tmp_path_factory):
    """The reference's compressed steps on four fake devices: codes,
    metrics, params and residuals after each step, by scale."""
    _, params = model
    d = tmp_path_factory.mktemp("train_dist")
    np.savez(d / "params.npz", **{_key(p): v.numpy() for p, v in tree_leaves_with_path(params)})
    (d / "cfg.json").write_text(json.dumps({"n": N, "steps": STEPS, "lr": LR, "batch": BATCH,
                                            "seq": SEQ, "scales": SCALES}))
    (d / "step.py").write_text(_JAX_STEP)
    env = dict(os.environ, XLA_FLAGS=REF_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(d / "step.py"), str(d / "params.npz"),
                          str(d / "cfg.json"), str(d / "ref.npz")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "ref.npz"))


def _visit_order(tree, path=()):
    """Leaf paths in ``tree_map``'s order (each dict's own)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _visit_order(v, path + (k,))]
    return [path]


@pytest.mark.parametrize("scale", SCALES)
def test_compressed_step_tracks_reference(model, ref, scale, monkeypatch):
    """Two compressed adamw steps (int8, four groups of two rows) against
    the reference's on four devices, the reference's wire codes fed in."""
    arch, params = model
    mesh = Mesh.on_device("cpu", data=N)
    rules = ShardingRules.default(mesh, arch)
    gc = GradCompressConfig(bits=8, scale_axis=scale)
    opt = adamw()
    params = tree_map(torch.clone, params)
    state = init_state(params, opt).tree()
    state["grad_err"] = init_grad_err(params, N, pspecs=param_specs(params, mesh, rules),
                                      axis="data")
    step = build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules, grad_compress=gc),
                            lr_schedule=lambda s: torch.tensor(LR, dtype=torch.float32))
    order = _visit_order(params)
    orig_q = tcol._quantize
    fed = {"calls": 0, "flips": 0, "codes": 0, "mag": {}}

    def feed(i):
        def quantize(y, s, qmax, wire):
            mine = orig_q(y, s, qmax, wire)
            k = fed["calls"]
            fed["calls"] += 1
            key = _key(order[k // 2])
            part = "local" if k % 2 == 0 else "server"
            fed["mag"][part, key] = float(y.abs().max())
            want = torch.from_numpy(ref[f"{scale}/{i}/{'q' if k % 2 == 0 else 'q2'}/{key}"])
            want = want[tuple(slice(0, d) for d in mine.shape)].to(wire)  # the pad
            diff = (mine.to(torch.int32) - want.to(torch.int32)).abs()
            assert int(diff.max()) <= 1, (key, int(diff.max()))
            if diff.any():  # one apart: y / s within the gradient gates' 1e-4 of the
                # leaf's range (ERR_TOL * qmax codes) of a tie, k + 1/2
                u = (y / s)[diff.bool()]
                gap = float((u.abs() - u.abs().floor() - 0.5).abs().max())
                assert gap <= ERR_TOL * qmax, (key, gap)
            fed["flips"] += int(diff.sum())
            fed["codes"] += mine.numel()
            return want
        return quantize

    stream = TokenStream(vocab=arch.vocab, seq_len=SEQ, global_batch=BATCH)
    for i in range(STEPS):
        fed["calls"] = 0
        monkeypatch.setattr(tcol, "_quantize", feed(i))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in stream.batch(i).items()})
        monkeypatch.setattr(tcol, "_quantize", orig_q)
        assert fed["calls"] == 2 * len(order)
        for k in ("loss", "ce", "penalty", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref[f"{scale}/{i}/m/{k}"]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for path, p in tree_leaves_with_path(state["params"]):
            want = ref[f"{scale}/{i}/params/{_key(path)}"]
            diff = np.abs(p.numpy() - want).max()
            assert diff <= PARAM_TOL * max(np.abs(want).max(), 1e-12), (path, diff)
        for part in ("local", "server"):
            leaves = tree_leaves_with_path(state["grad_err"][part])
            assert max(float(e.abs().max()) for _, e in leaves) > 0
            top = max(m for (pt, _), m in fed["mag"].items() if pt == part)
            for path, e in leaves:
                w = ref[f"{scale}/{i}/{part}/{_key(path)}"]
                assert e.shape == w.shape, (part, path)
                assert np.abs(e.numpy() - w).max() <= ERR_TOL * top, (part, path)
    assert int(state["step"]) == STEPS
    print(f"{scale}: {fed['flips']} of {fed['codes']} wire codes of the last step fed one apart")


def test_compressed_step_refuses_a_batch_the_groups_do_not_divide(model):
    arch, params = model
    mesh = Mesh.on_device("cpu", data=N)
    opt = sgdm()
    state = init_state(params, opt).tree()
    state["grad_err"] = init_grad_err(params, N)
    step = build_train_step(arch, opt, Runtime(mesh=mesh, grad_compress=GradCompressConfig()))
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(vocab=arch.vocab, seq_len=8, global_batch=6).batch(0).items()}
    with pytest.raises(ValueError, match="multiple"):
        step(state, batch)


@pytest.mark.parametrize("name", ["smollm-135m", "deepseek-v3-671b", "hubert-xlarge"])
def test_state_specs_and_grad_err_match_reference(name):
    """``make_state_specs`` (adamw, adafactor, sgdm; with and without the
    residual specs) and ``init_grad_err``'s shapes (owner dims from the
    specs, and dim 0) against the reference's, at full size on two meshes."""
    boxed = _boxed(name, False)
    params = _meta_like(boxed)
    jparams = jax.tree.map(lambda b: b.value, boxed,
                           is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "value"))
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 4, "model": 8}):
        jm, tm = _FakeMesh(shape), Mesh(tuple(shape), tuple(shape.values()))
        jr = jshard.ShardingRules.default(jm, jget_arch(name))
        tr = ShardingRules.default(tm, get_arch(name))
        jgc = jcol.resolve_grad_compress(jcol.GradCompressConfig(bits=8), jm)
        tgc = tcol.resolve_grad_compress(GradCompressConfig(bits=8), tm)
        for jo, to in ((jopt.adamw(), adamw()), (jopt.adafactor(), adafactor()),
                       (jopt.sgdm(), sgdm())):
            for use_gc in (False, True):
                want = _jspec_tree(jstate.make_state_specs(boxed, jo, jm, jr,
                                                           jgc if use_gc else None))
                got = make_state_specs(params, to, tm, tr, tgc if use_gc else None)
                assert got == want, (name, shape, use_gc)
        pspecs = jshard.param_specs(boxed, jm, jr)
        n = shape["data"]
        for with_specs in (False, True):
            want = jax.eval_shape(lambda: jstate.init_grad_err(
                jparams, n, pspecs=pspecs if with_specs else None, axis="data"))
            got = init_grad_err(params, n, pspecs=param_specs(params, tm, tr) if with_specs
                                else None, axis="data")
            assert tree_map(lambda t: tuple(t.shape), got) == \
                jax.tree.map(lambda s: tuple(s.shape), want)
            assert all(t.dtype == torch.float32 and t.device.type == "meta"
                       for _, t in tree_leaves_with_path(got))


def test_grad_err_pair_survives_checkpoints(model, tmp_path):
    """A compressed step's residual pair saved and restored bit for bit;
    an uncompressed checkpoint restored into a compressed state with
    ``allow_missing`` keeps zero residuals, and without it raises."""
    arch, params = model
    mesh = Mesh.on_device("cpu", data=N)
    opt = adamw()
    params = tree_map(torch.clone, params)
    state = init_state(params, opt).tree()
    state["grad_err"] = init_grad_err(params, N)
    step = build_train_step(arch, opt, Runtime(mesh=mesh, grad_compress=GradCompressConfig()))
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(vocab=arch.vocab, seq_len=16, global_batch=BATCH).batch(0).items()}
    state, _ = step(state, batch)
    assert all(float(e.abs().sum()) > 0 for e in (
        torch.stack([t.abs().sum() for _, t in tree_leaves_with_path(state["grad_err"][part])])
        for part in ("local", "server")))
    ckpt.save(str(tmp_path / "a"), state, 1)

    def like():
        s = init_state(tree_map(torch.zeros_like, params), opt).tree()
        s["grad_err"] = init_grad_err(params, N)
        return s

    restored, n = ckpt.restore(str(tmp_path / "a"), like())
    assert n == 1
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(restored), tree_leaves_with_path(state)):
        assert pa == pb and torch.equal(a, b), keystr(pa)
    plain = {k: v for k, v in state.items() if k != "grad_err"}
    ckpt.save(str(tmp_path / "b"), plain, 5)
    restored, _ = ckpt.restore(str(tmp_path / "b"), like(), allow_missing=True)
    assert sum(float(t.abs().sum()) for _, t in tree_leaves_with_path(restored["grad_err"])) == 0
    assert torch.equal(restored["params"]["final_norm"]["scale"],
                       state["params"]["final_norm"]["scale"])
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "b"), like())
