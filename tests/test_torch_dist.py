"""The port's distribution layer against the JAX package on the CPU: the
compressed collectives at n = 4 shards, the sharding rules and specs, and
the mesh planner.

Reference outputs at n = 4 come from one JAX process with four fake CPU
devices (a module fixture; its mesh is built with ``jax.sharding.Mesh``,
whose axes are ``Auto``; ``REF_XLA_FLAGS``), given the same numpy inputs:

* ``compressed_allreduce_tree`` (the global-view transport) at bits 8 and
  16, ``tensor`` and ``column`` scales, over leaves whose owner dim is an
  FSDP dim, a free dim, a padded dim (the column dim too) and a scalar,
  through three rounds of error feedback; its codes are read where its
  reshards pass them (``_constrain``);
* ``compressed_psum_tree`` under ``shard_map`` (the shard-local
  transport), its codes read where they enter the all-to-all and the
  all-gather; the port's runs over four gloo processes.

Codes and int32 sums must be equal; totals and residuals bit for bit but for
``ULPS`` ulps of the largest magnitude their leaf's arithmetic saw (XLA may
fuse a residual's ``y - q * scale`` into one rounding).  The specs
are held to the reference's (read as tuples) for every registered arch over
several mesh shapes, at full size (the params as ``meta`` tensors of the
reference's shapes) and on the port's own reduced trees."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.dist import collectives as jcol
from repro.dist import sharding as jshard
from repro.train.elastic import plan_mesh as jplan_mesh

from repro_torch.configs import get_arch, reduced
from repro_torch.dist import collectives as tcol
from repro_torch.dist.collectives import (
    GradCompressConfig,
    compressed_allreduce,
    compressed_allreduce_tree,
    owner_dim,
    resolve_grad_compress,
    server_shape,
    strip_axis,
)
from repro_torch.dist.sharding import Mesh, ShardingRules, cache_specs, param_specs
from repro_torch.models.lm import init_cache, init_lm
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.train.elastic import plan_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 4
ROUNDS = 3
ULPS = 4  # totals and residuals: fp32 ulps of the leaf's magnitude, three rounds carried
FORMATS = ((8, "tensor"), (8, "column"), (16, "tensor"), (16, "column"))
LEAVES = {  # name -> (shape, param spec on a (data=4, model=1) mesh)
    "fsdp": ((8, 6), ("data", None)),  # owner: the FSDP dim
    "free": ((6, 8), ("model", None)),  # owner: the first free dim
    "padded": ((5, 3), None),  # owner dim 0, 5 rows padded to 8
    "padded_col": ((3, 5), ("model", None)),  # owner: the column dim, padded
    "scalar": ((), None),
}
PSUM_LEAVES = {"mat": (6, 5), "vec": (9,), "scalar": ()}
# four fake devices; the backend's optimizations off, so XLA's CPU code does
# not contract ``a * b + c`` into one rounding (an FMA), which moves the
# requantization's ties (``value_sum / wide`` at k + 1/2): the reference's
# arithmetic as written, as its eager execution and the port round it
REF_XLA_FLAGS = "--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0"


def _fmt(bits, scale):
    return f"{bits}{scale}"


def _inputs() -> dict:
    """``g/{round}/{leaf}`` stacked (N, *shape) gradients, ``x/...`` for the
    psum, from one numpy seed; some rows scaled apart so a shared scale
    matters, one column of zeros (a column scale at its tiny floor)."""
    rng = np.random.default_rng(0)
    out = {}
    for r in range(ROUNDS):
        for name, (shape, _) in LEAVES.items():
            g = rng.normal(size=(N,) + shape).astype(np.float32)
            g *= np.float32(10.0) ** rng.integers(-2, 2, size=(N,) + (1,) * len(shape))
            if len(shape) == 2:
                g[..., 1] = 0
            out[f"g/{r}/{name}"] = g.astype(np.float32)
        for name, shape in PSUM_LEAVES.items():
            out[f"x/{r}/{name}"] = rng.normal(size=(N,) + shape).astype(np.float32)
    return out


_JAX_SIDE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.dist import collectives as C

inp = dict(np.load(sys.argv[1]))
cfg = json.loads(open(sys.argv[2]).read())
N, ROUNDS = cfg["n"], cfg["rounds"]
out = {}

# --- the global-view transport (jitted), codes read at its reshards
mesh = Mesh(np.array(jax.devices()).reshape(N, 1), ("data", "model"))
rec, traced = [], [0]
orig = C._constrain
def constrain(x, m, spec):  # numbered in trace order
    y = orig(x, m, spec)
    at, traced[0] = traced[0], traced[0] + 1
    jax.debug.callback(lambda v: rec.append((at, np.asarray(v))), y)
    return y
C._constrain = constrain
leaves = cfg["leaves"]
pspecs = {k: (P(*v[1]) if v[1] is not None else None) for k, v in leaves.items()}
for bits, scale in cfg["formats"]:
    f = f"{bits}{scale}"
    fn = jax.jit(lambda g, e, bits=bits, scale=scale: C.compressed_allreduce_tree(
        g, e, mesh=mesh, axis="data", bits=bits, scale_axis=scale, pspec_tree=pspecs))
    err = {"local": {k: jnp.zeros((N,) + tuple(v[0]), jnp.float32) for k, v in leaves.items()},
           "server": {k: jnp.zeros(C.server_shape(tuple(v[0]), N, C.owner_dim(
                          pspecs[k], len(v[0]), "data")), jnp.float32)
                      for k, v in leaves.items()}}
    for r in range(ROUNDS):
        g = {k: jnp.asarray(inp[f"g/{r}/{k}"]) for k in leaves}
        rec.clear()
        traced[0] = 0
        with mesh:
            total, err = fn(g, err)
        jax.effects_barrier()
        seen = [v for _, v in sorted(rec, key=lambda t: t[0])]
        assert len(seen) == 4 * len(leaves), len(seen)
        for i, k in enumerate(sorted(leaves)):  # flatten order: 4 reshards a leaf
            out[f"ar/{f}/{r}/{k}/q"] = seen[4 * i]
            out[f"ar/{f}/{r}/{k}/q2"] = seen[4 * i + 2]
            out[f"ar/{f}/{r}/{k}/total"] = np.asarray(total[k])
            out[f"ar/{f}/{r}/{k}/local"] = np.asarray(err["local"][k])
            out[f"ar/{f}/{r}/{k}/server"] = np.asarray(err["server"][k])
C._constrain = orig

# --- the shard-local transport under shard_map, codes read where they
# enter the all-to-all and the all-gather (keyed by leaf at trace time)
mesh1 = Mesh(np.array(jax.devices()), ("data",))
crec, cur = [], [None]
o_a2a, o_ag = jax.lax.all_to_all, jax.lax.all_gather
def tap(tag, x, axis):
    key = (cur[0], tag)
    jax.debug.callback(lambda v, i: crec.append((key, int(i), np.asarray(v))), x,
                       jax.lax.axis_index(axis))
def a2a(x, axis, *a, **kw):
    tap("q", x, axis)
    return o_a2a(x, axis, *a, **kw)
def ag(x, axis, *a, **kw):
    tap("q2", x, axis)
    return o_ag(x, axis, *a, **kw)
jax.lax.all_to_all, jax.lax.all_gather = a2a, ag
names = sorted(cfg["psum_leaves"])
for bits, scale in cfg["formats"]:
    f = f"{bits}{scale}"
    def body(xs, es, bits=bits, scale=scale):
        outs = {}
        for k in names:
            cur[0] = k
            t, e = C.compressed_psum(xs[k][0], "data", es[k][0], bits, scale)
            outs[k] = (t[None], e[None])
        return ({k: v[0] for k, v in outs.items()}, {k: v[1] for k, v in outs.items()})
    fn = jax.jit(jax.shard_map(body, mesh=mesh1, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")), check_vma=False))
    err = {k: jnp.zeros((N,) + tuple(cfg["psum_leaves"][k]), jnp.float32) for k in names}
    for r in range(ROUNDS):
        crec.clear()
        total, err = fn({k: jnp.asarray(inp[f"x/{r}/{k}"]) for k in names}, err)
        jax.effects_barrier()
        for k in names:
            for tag in ("q", "q2"):
                got = sorted((i, v) for key, i, v in crec if key == (k, tag))
                out[f"ps/{f}/{r}/{k}/{tag}"] = np.stack([v for _, v in got])
            out[f"ps/{f}/{r}/{k}/total"] = np.asarray(total[k])
            out[f"ps/{f}/{r}/{k}/err"] = np.asarray(err[k])
np.savez(sys.argv[3], **out)
print("ok")
'''

_PORT_PSUM = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist import collectives as C

torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
inp = dict(np.load(sys.argv[4]))
cfg = json.loads(open(sys.argv[5]).read())
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
rec = []
oq = C._quantize
C._quantize = lambda *a: rec.append(oq(*a)) or rec[-1]
out = {}
for bits, scale in cfg["formats"]:
    f = f"{bits}{scale}"
    err = {k: torch.zeros(s) for k, s in cfg["psum_leaves"].items()}
    for r in range(cfg["rounds"]):
        x = {k: torch.from_numpy(np.asarray(inp[f"x/{r}/{k}"][rank]))
             for k in cfg["psum_leaves"]}
        for k in sorted(x):  # one leaf at a time, so the codes are keyed
            rec.clear()
            total, err[k] = C.compressed_psum_tree({k: x[k]}, None, {k: err[k]}, bits, scale)
            total, err[k] = total[k], err[k][k]
            out[f"ps/{f}/{r}/{k}/q"] = rec[0].numpy().reshape(-1)
            out[f"ps/{f}/{r}/{k}/q2"] = rec[1].numpy()
            out[f"ps/{f}/{r}/{k}/total"] = total.numpy()
            out[f"ps/{f}/{r}/{k}/err"] = err[k].numpy()
dist.destroy_process_group()
np.savez(sys.argv[6], **out)
'''


def _config():
    return {"n": N, "rounds": ROUNDS, "formats": FORMATS,
            "leaves": {k: [list(s), list(p) if p is not None else None]
                       for k, (s, p) in LEAVES.items()},
            "psum_leaves": {k: list(s) for k, s in PSUM_LEAVES.items()}}


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    """(inputs, the reference's outputs) — one JAX process with four fake
    devices."""
    d = tmp_path_factory.mktemp("dist")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    (d / "cfg.json").write_text(json.dumps(_config()))
    (d / "ref.py").write_text(_JAX_SIDE)
    env = dict(os.environ, XLA_FLAGS=REF_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(d / "ref.py"), str(d / "in.npz"),
                          str(d / "cfg.json"), str(d / "ref.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return inputs, dict(np.load(d / "ref.npz")), d


def _close(got, want, what, size):
    """Bit for bit but for ``ULPS`` fp32 ulps of ``size``, the largest
    magnitude the leaf's arithmetic saw (its payload or its total): a
    residual ``y - q * scale`` cancels to a small part of ``y``, its ``y``
    rounds the previous round's residual in, and XLA may round a sum in
    another order."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = ULPS * np.spacing(np.float32(size))
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)


def _size(*arrays) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)).max()) for a in arrays)


def _ar_mesh():
    return Mesh.on_device("cpu", data=N, model=1)


@pytest.mark.parametrize("bits,scale", FORMATS, ids=[_fmt(*f) for f in FORMATS])
def test_compressed_allreduce_tree_matches_reference(io, bits, scale, monkeypatch):
    """Three rounds of error feedback through the port's global-view
    transport, fed the stacked gradients the reference was fed: each leaf's
    codes (phase 1, owner dim padded; phase 2), the owners' int32 sums, the
    totals and both residuals."""
    inputs, ref, _ = io
    f = _fmt(bits, scale)
    rec = {"q": [], "sum": []}
    oq, osum = tcol._quantize, tcol._owner_sum
    monkeypatch.setattr(tcol, "_quantize", lambda *a: rec["q"].append(oq(*a)) or rec["q"][-1])
    monkeypatch.setattr(tcol, "_owner_sum", lambda q: rec["sum"].append(osum(q)) or rec["sum"][-1])
    pspecs = {k: p for k, (_, p) in LEAVES.items()}
    mesh = _ar_mesh()
    err = {"local": {k: torch.zeros((N,) + s) for k, (s, _) in LEAVES.items()},
           "server": {k: torch.zeros(server_shape(s, N, owner_dim(p, len(s), "data")))
                      for k, (s, p) in LEAVES.items()}}
    for r in range(ROUNDS):
        g = {k: torch.from_numpy(inputs[f"g/{r}/{k}"]) for k in LEAVES}
        rec["q"].clear(), rec["sum"].clear()
        total, err = compressed_allreduce_tree(g, err, mesh=mesh, axis="data", bits=bits,
                                               scale_axis=scale, pspec_tree=pspecs)
        for i, k in enumerate(g):  # tree_map's order: the dict's own
            key = f"ar/{f}/{r}/{k}"
            q1, q2, s = rec["q"][2 * i], rec["q"][2 * i + 1], rec["sum"][i]
            assert q1.dtype == (torch.int8 if bits <= 8 else torch.int16)
            # the port quantizes before the owner dim's padding, the reference's
            # reshards see the padded codes: the pad must be zeros
            want_q = ref[f"{key}/q"]
            inner = tuple(slice(0, d) for d in q1.shape)
            np.testing.assert_array_equal(q1.numpy(), want_q[inner], err_msg=key)
            assert np.abs(want_q).sum() == np.abs(want_q[inner]).sum()
            np.testing.assert_array_equal(s.numpy(), ref[f"{key}/q"].astype(np.int32).sum(0),
                                          err_msg=key)
            np.testing.assert_array_equal(q2.numpy(), ref[f"{key}/q2"], err_msg=key)
            size = _size(inputs[f"g/{r}/{k}"], ref[f"{key}/total"])
            _close(total[k], ref[f"{key}/total"], key + "/total", size)
            _close(err["local"][k], ref[f"{key}/local"], key + "/local", size)
            _close(err["server"][k], ref[f"{key}/server"], key + "/server", size)
    assert any(float(v.abs().max()) > 0 for v in err["server"].values())


class _FakeMesh:
    """What the reference's placement logic reads of a mesh."""

    def __init__(self, shape):
        self.shape, self.axis_names = dict(shape), tuple(shape)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_psum(io):
    """The port's ``compressed_psum_tree`` over four gloo processes, each
    recording its codes (one leaf a call): ``{rank: outputs}``."""
    _, _, d = io
    (d / "psum.py").write_text(_PORT_PSUM)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(d / "psum.py"), str(r), str(N), port,
                               str(d / "in.npz"), str(d / "cfg.json"), str(d / f"psum{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(N)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-3000:]
    return {r: dict(np.load(d / f"psum{r}.npz")) for r in range(N)}


@pytest.mark.parametrize("bits,scale", FORMATS, ids=[_fmt(*f) for f in FORMATS])
def test_compressed_psum_tree_over_gloo_matches_reference(io, port_psum, bits, scale):
    """Four gloo processes against the reference's ``shard_map`` on four
    devices, three rounds: every shard's codes into the all-to-all, every
    owner's requantized codes into the all-gather, each shard's total and
    residual."""
    _, ref, _ = io
    f = _fmt(bits, scale)
    for r in range(ROUNDS):
        for k in PSUM_LEAVES:
            key = f"ps/{f}/{r}/{k}"
            for rank in range(N):
                mine = port_psum[rank]
                q = ref[f"{key}/q"][rank].reshape(-1)
                np.testing.assert_array_equal(mine[f"{key}/q"], q[:mine[f"{key}/q"].size],
                                              err_msg=key)
                assert not q[mine[f"{key}/q"].size:].any()  # the pad
                np.testing.assert_array_equal(mine[f"{key}/q2"], ref[f"{key}/q2"][rank],
                                              err_msg=key)
                size = _size(io[0][f"x/{r}/{k}"], ref[f"{key}/total"])
                _close(mine[f"{key}/total"], ref[f"{key}/total"][rank], key + "/total", size)
                _close(mine[f"{key}/err"], ref[f"{key}/err"][rank], key + "/err", size)


def _overflows(fn) -> bool:
    """Whether ``fn`` stops at the overflow guard (an empty payload fails
    past it otherwise, before any arithmetic)."""
    try:
        fn()
    except ValueError as e:
        if "overflow" in str(e):
            return True
    except Exception:
        pass
    return False


def test_overflow_guard_raises_where_the_reference_does(monkeypatch):
    """The static int32 guard at the reference's edges (2**17 shards at
    int16 overflow, at int8 not; 65,539 at int16 just over), on the global
    view from the mesh (``(n, 0)`` payloads, so nothing past the guard is
    computed) and on the shard-local transport from the group's size before
    any collective (one gloo process told it has 2**17 peers)."""
    import torch.distributed as dist

    edges = [(1 << 17, 16), (1 << 17, 8), ((1 << 16) + 3, 16), ((1 << 16) + 2, 16),
             (1 << 24, 8), (16909321, 8), (16909320, 8), (2, 2)]
    for n, bits in edges:
        z = np.zeros((n, 0), np.float32)
        want = _overflows(lambda: jcol.compressed_allreduce(
            z, z, np.zeros((0,), np.float32), mesh=_FakeMesh({"data": n}), axis="data", bits=bits))
        got = _overflows(lambda: compressed_allreduce(
            torch.zeros(n, 0), torch.zeros(n, 0), torch.zeros(0), mesh=Mesh(("data",), (n,)),
            axis="data", bits=bits))
        assert got == want == (n * (2 ** (bits - 1) - 1) > 2**31 - 1), (n, bits, got, want)
    g = torch.randn(2, 3)
    compressed_allreduce(g, torch.zeros_like(g), torch.zeros(4), mesh=Mesh(("data",), (2,)),
                         axis="data", bits=16)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        calls = []
        for name in ("all_reduce", "all_to_all_single", "all_gather"):
            monkeypatch.setattr(dist, name, lambda *a, name=name, **k: calls.append(name))
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1 << 17)
        with pytest.raises(ValueError, match="overflow"):
            tcol.compressed_psum(torch.ones(4), None, torch.zeros(4), bits=16)
        assert calls == []
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_wire_helpers_match_reference():
    """``owner_dim``, ``server_shape``, ``strip_axis`` and
    ``resolve_grad_compress`` on the reference's own edge cases, and bad
    formats refused."""
    from jax.sharding import PartitionSpec as P

    specs = [None, ("model", "data"), (None, "data", "model"), ("model", None),
             ("model", "model2"), (("pod", "data"), "model"), ("model", ("data", "model2")),
             (None, ("pod", "data")), (("data",), "model"), (("pod", "model"), "data"),
             (("pod", "model"), None)]
    for spec in specs:
        for ndim in (1, 2, 3):
            want = jcol.owner_dim(None if spec is None else P(*spec), ndim, "data")
            assert owner_dim(spec, ndim, "data") == want, (spec, ndim)
        if spec is not None:
            assert strip_axis(list(spec), "data") == jcol.strip_axis(list(spec), "data")
    for shape, n, od in (((30, 576), 16, 0), ((), 4, 0), ((5, 3), 4, 1), ((7,), 3, 0)):
        assert server_shape(shape, n, od) == jcol.server_shape(shape, n, od)

    cfg = GradCompressConfig(bits=8)
    jcfg = jcol.GradCompressConfig(bits=8)
    for shape in ({"data": 8, "model": 2}, {"pod": 2, "data": 8, "model": 2}, {"data": 1},
                  {"model": 4}):
        got = resolve_grad_compress(cfg, _FakeMesh(shape))
        want = jcol.resolve_grad_compress(jcfg, _FakeMesh(shape))
        assert (got and got.axis) == (want and want.axis)
    assert resolve_grad_compress(cfg, None) is None
    t = torch.zeros((N, 2))
    for bad in (dict(bits=1), dict(bits=17), dict(scale_axis="row")):
        with pytest.raises(ValueError):
            compressed_allreduce(t, t, torch.zeros(N), mesh=_ar_mesh(), axis="data", **bad)


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 8, "model": 4}, {"data": 4, "model": 2},
          {"data": 8}, {"model": 8}, {"data": 1, "model": 1})


def _jspec_tree(tree):
    return jax.tree.map(lambda s: tuple(s), tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _meta_like(jtree):
    """A port tree of ``meta`` tensors with the reference's shapes."""
    import repro.nn.module as jm

    def one(x):
        v = x.value if isinstance(x, jm.Boxed) else x
        return torch.empty(v.shape, dtype=torch.float32, device="meta")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return one(t)

    return walk(jtree)


_BOXED: dict = {}


def _boxed(name, small):
    from repro.models.lm import init_lm as jinit_lm

    if (name, small) not in _BOXED:
        a = jget_arch(name)
        a = jreduced(a) if small else a
        _BOXED[name, small] = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0), a))
    return _BOXED[name, small]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_match_reference_every_arch(name):
    """``ShardingRules.default`` and ``param_specs`` at full size (the
    reference's shapes as ``meta`` tensors) over six mesh shapes, with
    ``fsdp`` off and ``tp_extra`` on one of them; and on the port's own
    reduced tree, whose paths and shapes are the reference's."""
    boxed = _boxed(name, False)
    params = _meta_like(boxed)
    for shape in MESHES:
        jm, tm = _FakeMesh(shape), Mesh(tuple(shape), tuple(shape.values()))
        for kw in ({}, {"fsdp": False, "tp_extra": True}):
            jr = jshard.ShardingRules.default(jm, jget_arch(name), **kw)
            tr = ShardingRules.default(tm, get_arch(name), **kw)
            assert (tr.rules, tr.unit_counts) == (jr.rules, jr.unit_counts)
            want = _jspec_tree(jshard.param_specs(boxed, jm, jr))
            assert param_specs(params, tm, tr) == want, (name, shape, kw)
    small = init_lm(torch.Generator().manual_seed(0), reduced(get_arch(name)), device="cpu")
    jsmall = _boxed(name, True)
    assert {p: tuple(v.shape) for p, v in tree_leaves_with_path(small)} == \
        {p: tuple(v.shape) for p, v in tree_leaves_with_path(_meta_like(jsmall))}
    for shape in ({"data": 2, "model": 2}, {"data": 4, "model": 4}):
        jm, tm = _FakeMesh(shape), Mesh(tuple(shape), tuple(shape.values()))
        jr = jshard.ShardingRules.default(jm, jreduced(jget_arch(name)))
        tr = ShardingRules.default(tm, reduced(get_arch(name)))
        assert param_specs(small, tm, tr) == _jspec_tree(jshard.param_specs(jsmall, jm, jr))


@pytest.mark.parametrize("name", ["smollm-135m", "rwkv6-7b", "hymba-1.5b", "deepseek-v3-671b",
                                  "h2o-danube-1.8b"])
def test_cache_specs_match_reference(name):
    """``cache_specs`` of the contiguous decode cache (``init_cache`` on
    ``meta``, full size, batch 8) against the reference's, over the mesh
    shapes; and of a paged layout with int8 scale pools, MLA pools and the
    allocator's leaves, built from the reference's own test's shapes."""
    from repro.models.lm import init_cache as jinit_cache

    arch, jarch = get_arch(name), jget_arch(name)
    mine = init_cache(arch, 8, 4096, device="meta")
    ref = jax.eval_shape(lambda: jinit_cache(jarch, 8, 4096))
    paged = {"0": {"kp": (4, 65, 16, 8, 128), "vp": (4, 65, 16, 8, 128), "kps": (4, 65, 16, 8),
                   "vps": (4, 65, 16, 8), "ckvp": (4, 65, 16, 512), "ckvs": (4, 65, 16),
                   "kpep": (4, 65, 16, 64)},
             "bt": (8, 16), "wm": (8,), "rc": (65,)}
    for shape in MESHES:
        jm, tm = _FakeMesh(shape), Mesh(tuple(shape), tuple(shape.values()))
        jr = jshard.ShardingRules.default(jm, jarch)
        tr = ShardingRules.default(tm, arch)
        assert cache_specs(mine, tm, tr) == _jspec_tree(jshard.cache_specs(ref, jm, jr))
        pt = tree_map(lambda s: torch.empty(s, device="meta"), paged)
        pj = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jax.numpy.float32), paged,
                          is_leaf=lambda x: isinstance(x, tuple))
        assert cache_specs(pt, tm, tr) == _jspec_tree(jshard.cache_specs(pj, jm, jr))


def test_plan_mesh_matches_reference():
    """``plan_mesh`` for 1-1024 devices, with and without each arch's TP
    divisors, and on the reference's degenerate inputs."""
    divisors = [()] + [tuple(s.attn.heads for s in get_arch(n).stacks if s.attn)
                       for n in ARCH_NAMES]
    for n in list(range(1, 70)) + [96, 128, 250, 256, 512, 1000, 1024]:
        for div in divisors:
            for kw in ({}, {"prefer_model": 4}, {"max_pods": 2}):
                assert plan_mesh(n, model_divisors=div, **kw) == \
                    jplan_mesh(n, model_divisors=div, **kw), (n, div, kw)
    with pytest.raises(ValueError):
        plan_mesh(0)
