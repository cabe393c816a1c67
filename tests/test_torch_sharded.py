"""Sharded execution in the port against the JAX package on the CPU: the
reference's sharding rules as DTensor placements over four gloo ranks.

One world of four processes (plain subprocesses over ``tcp://localhost``,
a module fixture, ``torch.set_num_threads(1)``) runs every sharded case on
``Mesh.over_ranks`` and writes what it got; the reference runs in this
process on one device, and where its own sharded path is the gate (the
layouts, the EP branch at llama4-scout's capacity) in one JAX subprocess
with four fake devices on ``jax.sharding.Mesh`` (``Auto`` axes; ``jax.
make_mesh``'s ``Explicit`` axes fail under JAX 0.9, see ROADMAP queue 3).

* **Placements**: every arch's full-size ``param_specs`` at ``(2, 2)``,
  ``(4, 1)`` and ``(1, 4)``: each rank's DTensor shard (offset and shape)
  is the block JAX's ``NamedSharding`` gives the device at its position;
  an entry listing two axes out of the mesh's order is refused by name.
* **The sharded train step** on reduced yi-6b at ``(2, 2)``, ``t`` moved
  off its cap (``_push``): two ``sgdm`` steps against the reference's
  single-device step on the same numpy params, at
  ``tests/test_torch_train.py``'s gate (losses rtol 1e-4, under the
  reference's own 1e-3; params within 1e-5 of each leaf's largest |p|);
  four ``adamw`` steps against the port's unsharded step (``ADAM_TOL``,
  the gate phase 4x holds on the card).
* **A2Q's l1 of a K-sharded ``v``**: bit for bit the whole tree's.
* **MoE EP** over ``model`` and ``(model, data)`` at cf 8.0 within 1e-4 of
  the reference's local path; at llama4-scout's cf 1.25 with tokens split
  over ``data``, against the reference's own EP branch on four devices
  (each shard's capacity is of its own tokens); reduced llama4-scout's
  train step with ``ep_axis="model"`` (cf 8.0: no drops) against the
  port's unsharded step.
* **The recurrent and MLA decoders**: one ``sgdm`` step each of reduced
  rwkv6-7b, hymba-1.5b and deepseek-v3 at ``(2, 2)`` against the unsharded
  step (losses, every gradient and param leaf); a deployed MoE's prefill
  with its int8 expert codes sharded, dequantized and W8A8.
* **The compressed step on the TP mesh**: reduced smollm-135m, int8
  ``column``, 12 ``adamw`` steps within the reference's 0.05 nat of the
  uncompressed sharded step and of PR 29's stacked-groups step; fed the
  stacked step's group gradients, every wire code equals the stacked
  step's on the same batches; the transport alone bit for bit against the
  stacked view's.
* **The KV-sharded serve step** (``cache_specs``: ``k`` dim 3 on
  ``model``) at the reference's gates: logits within 1e-2 of the
  single-device step, ``kpos`` written at 0.
* **Re-sharding on restore**: ``(2, 2)`` -> ``(4, 1)`` and unsharded ->
  ``(2, 2)``, bit for bit.
* **The launcher**: ``--mesh auto --device cpu --reduced`` on four gloo
  ranks prints the reference's ``mesh:`` line, and its two steps are
  within 1e-5 of a world of one.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard
from test_torch_dist import _boxed, _meta_like
from test_torch_train import _model, _np, _push

from repro.configs import ARCH_NAMES
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.models.steps import build_serve_step as jbuild_serve_step
from repro.models.steps import build_train_step as jbuild_train_step
from repro.nn import moe as jmoe
from repro.nn.module import unbox
from repro.optim import optimizers as jopt
from repro.train.elastic import plan_mesh as jplan_mesh

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist.sharding import Mesh, ShardingRules, param_specs, placements
from repro_torch.nn.module import tree_leaves_with_path

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 4
MESHES = {"22": (2, 2), "41": (4, 1), "14": (1, 4)}
LR = 2e-3  # the reference's own tests' lr
TRAIN_STEPS, ADAM_STEPS, COMPRESS_STEPS = 2, 4, 12
ADAM_TOL = 1e-4  # sharded against unsharded adamw: rtol on each loss
PARAM_TOL = 1e-5  # of each leaf's largest |p| (tests/test_torch_train.py)
ADAM_PARAM_TOL = 1e-3  # of lr x steps, the most adamw moves an element
MOE8 = dict(n_experts=8, top_k=2, d_ff=16, capacity_factor=8.0)  # the reference's EP tests
MOE_L4 = dict(n_experts=16, top_k=1, d_ff=32, capacity_factor=1.25)  # llama4-scout's routing
LAUNCHER = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--mesh", "auto", "--steps", "2",
            "--batch", "8", "--seq", "32"]
DECODERS = ("rwkv6-7b", "hymba-1.5b", "deepseek-v3-671b")  # sharded against unsharded steps
GRAD_TOL = 1e-3  # of each gradient leaf's largest |g| (floor: GRAD_FLOOR of the tree's largest)
GRAD_FLOOR = 1e-6
KV4 = 4  # kv heads of the serve case (the reference's: 4 on a 4-way model axis)
WIRE_LEAVES = {  # name -> (shape, param spec on (data=2, model=2)): owner and TP dims
    "fsdp_tp": ((8, 6), ("data", "model")),  # owner: the FSDP rows; columns over model
    "tp_rows": ((6, 8), ("model", None)),  # owner: the free columns; rows over model
    "padded": ((5, 3), (None, None)),  # owner: rows, padded to 6
    "tp_cols_padded": ((3, 4), (None, "model")),  # owner: rows padded to 4; columns over model
    "scalar": ((), ()),
}


def _kv4(arch):
    s0 = arch.stacks[0]
    return dataclasses.replace(arch, stacks=(dataclasses.replace(
        s0, attn=dataclasses.replace(s0.attn, kv_heads=KV4)),) + arch.stacks[1:])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _put(out, prefix, tree):
    """A numpy tree's leaves into ``out`` under ``prefix/key/...``."""
    for path, v in _np_leaves(tree):
        out[prefix + "/" + _key(path)] = np.asarray(v)


def _np_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k], path + (k,))]
    return [(path, tree)]


WORLD = r'''
import contextlib, json, os, sys, time, dataclasses, collections
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import MoEConfig, QuantConfig
from repro_torch.core.a2q import apply_a2q, pairwise_sum
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist import collectives as C
from repro_torch.dist.collectives import GradCompressConfig, owner_dim
from repro_torch.dist.sharding import (Mesh, ShardingRules, cache_specs, full_tree,
                                       param_specs, placements, shard_tree)
from repro_torch.models.lm import Runtime, init_cache, init_lm
from repro_torch.models.steps import build_serve_step, build_train_step
from repro_torch.nn import moe
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.optim.optimizers import adamw, sgdm
from repro_torch.roofline.cost import CostTrace
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import init_grad_err, init_state, shard_state, specs_to_shardings

cfg = json.load(open(os.path.join(d, "cfg.json")))
inp = dict(np.load(os.path.join(d, "in.npz")))
out, info, t0 = {}, {}, time.time()


def tree_of(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix + "/"):
            node = tree
            *head, last = key[len(prefix) + 1:].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(v.copy())
    return tree


def put(prefix, tree):
    for path, v in tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(map(str, path))] = v.detach().numpy()


def batches(arch, n, seed=0):
    s = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=8, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in s.batch(i).items()} for i in range(n)]


lr = lambda s: torch.tensor(cfg["lr"], dtype=torch.float32)
meshes = {k: Mesh.over_ranks("cpu", data=s[0], model=s[1]) for k, s in cfg["meshes"].items()}
mesh = meshes["22"]
dm = mesh.device_mesh()

# --- the sharded train step (reduced yi-6b, (2, 2)): sgdm against the
# reference, adamw against the port's unsharded step; the redistributions
arch = reduced(get_arch("yi-6b"))
rules = ShardingRules.default(mesh, arch)
params = tree_of("yi")
redist = collections.Counter()
orig_redist = DTensor._op_dispatcher.redistribute_local_args


def counted(op_info, suggested, *a, **k):
    redist[str(suggested.op)] += 1
    return orig_redist(op_info, suggested, *a, **k)


opt = sgdm()
st = shard_state(init_state(tree_map(torch.clone, params), opt).tree(), opt, mesh, rules)
step = build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules), lr_schedule=lr)
for i, b in enumerate(batches(arch, cfg["train_steps"], seed=2)):
    comm = CommDebugMode()
    if i:
        DTensor._op_dispatcher.redistribute_local_args = counted
    trace = CostTrace()
    with comm if i else contextlib.nullcontext(), trace if i else contextlib.nullcontext():
        st, m = step(st, b)
    DTensor._op_dispatcher.redistribute_local_args = orig_redist
    out[f"train/loss/{i}"] = m["loss"].numpy()
info["train_comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
info["train_coll"] = trace.collectives()
info["train_redistributed"] = dict(redist)
put("train/params", full_tree(st["params"]))
info["t_train"] = time.time() - t0

opt = adamw()
st_u = init_state(tree_map(torch.clone, params), opt).tree()
st_s = shard_state(init_state(tree_map(torch.clone, params), opt).tree(), opt, mesh, rules)
step_u = build_train_step(arch, opt, Runtime(), lr_schedule=lr)
step_s = build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules), lr_schedule=lr,
                          donate=True)
for i, b in enumerate(batches(arch, cfg["adam_steps"])):
    st_u, mu = step_u(st_u, b)
    st_s, ms = step_s(st_s, b)
    out[f"adam/loss/{i}"] = np.stack([mu["loss"].numpy(), ms["loss"].numpy()])
put("adam/sharded", full_tree(st_s["params"]))
put("adam/unsharded", st_u["params"])
info["t_adam"] = time.time() - t0

# --- re-sharding on restore
saved = full_tree(st_s["params"])
ckpt.save(os.path.join(d, "ck22"), st_s["params"], 3)
specs41 = param_specs(saved, meshes["41"], ShardingRules.default(meshes["41"], arch))
r41, n41 = ckpt.restore(os.path.join(d, "ck22"), saved,
                        shardings=specs_to_shardings(specs41, meshes["41"]))
ok41 = n41 == 3 and all(torch.equal(a.full_tensor(), b) for (_, a), (_, b) in
                        zip(tree_leaves_with_path(r41), tree_leaves_with_path(saved)))
ok41 = ok41 and all(list(a.placements) == placements(s, meshes["41"]) for (_, a), (_, s) in
                    zip(tree_leaves_with_path(r41), tree_leaves_with_path(specs41)))
ckpt.save(os.path.join(d, "ck1"), saved, 5)  # plain tensors: the unsharded run's state
specs22 = param_specs(saved, mesh, rules)
r22, n22 = ckpt.restore(os.path.join(d, "ck1"), saved, shardings=specs_to_shardings(specs22, mesh))
ok22 = n22 == 5 and all(torch.equal(a.full_tensor(), b) for (_, a), (_, b) in
                        zip(tree_leaves_with_path(r22), tree_leaves_with_path(saved)))
info["reshard"] = {"22_to_41": bool(ok41), "unsharded_to_22": bool(ok22)}

# --- A2Q's l1 of a K-sharded v: the whole tree's, bit for bit
v = torch.from_numpy(inp["l1/v"])
want = pairwise_sum(v.abs())
l1 = {}
for tag, pl in (("data", [Shard(0), Replicate()]), ("data_model", [Shard(0), Shard(0)]),
                ("data_cols_model", [Shard(0), Shard(1)])):
    got = pairwise_sum(distribute_tensor(v, dm, pl).abs()).full_tensor()
    l1[tag] = bool(torch.equal(got, want))
vs = torch.from_numpy(inp["l1/stacked"])  # (layers, K, C), K over data
l1["stacked"] = bool(torch.equal(
    pairwise_sum(distribute_tensor(vs, dm, [Shard(1), Shard(2)]).abs()).full_tensor(),
    pairwise_sum(vs.abs())))
node = {"v": v, "t": torch.from_numpy(inp["l1/t"]), "d": torch.from_numpy(inp["l1/d"])}
placed = {"v": distribute_tensor(v, dm, [Shard(0), Shard(1)]),
          "t": distribute_tensor(node["t"], dm, [Replicate(), Shard(0)]),
          "d": distribute_tensor(node["d"], dm, [Replicate(), Shard(0)])}
l1["apply_a2q"] = bool(torch.equal(apply_a2q(placed, 8, 16, 8, True).full_tensor(),
                                   apply_a2q(node, 8, 16, 8, True)))
odd = torch.from_numpy(inp["l1/odd"])  # 48 rows: 24 a shard, not a power of two
l1["odd_max_rel"] = float(((pairwise_sum(distribute_tensor(odd, dm, [Shard(0), Replicate()])
                                         .abs()).full_tensor() - pairwise_sum(odd.abs())).abs()
                           / pairwise_sum(odd.abs())).max())
info["l1"] = l1

# --- MoE EP
q = QuantConfig(mode="none")
mp, x = tree_of("moe8/p"), torch.from_numpy(inp["moe8/x"])
c8 = MoEConfig(**cfg["moe8"])
for tag, ep in (("model", "model"), ("model_data", ("model", "data")), ("none", None)):
    y = moe.apply_moe(mp, x, c8, q, compute_dtype=torch.float32, mesh=mesh, ep_axis=ep)
    out[f"moe8/{tag}"] = y.full_tensor().numpy()
# the experts as DTensors (experts on model, the embed dim on data), as the
# param specs lay them out
espec = {"w_in": [Shard(1), Shard(0)], "w_gate": [Shard(1), Shard(0)],
         "w_out": [Shard(2), Shard(0)]}
dmp = {k: ({"w": distribute_tensor(v["w"], dm, espec[k])} if k in espec else
           distribute_tensor(v, dm, [Shard(0), Replicate()])) for k, v in mp.items()}
y = moe.apply_moe(dmp, x, c8, q, compute_dtype=torch.float32, mesh=mesh, ep_axis="model")
out["moe8/model_dtensor"] = y.full_tensor().numpy()
ml4, xl4 = tree_of("moel4/p"), torch.from_numpy(inp["moel4/x"])
y = moe.apply_moe(ml4, xl4, MoEConfig(**cfg["moel4"]), q, compute_dtype=torch.float32,
                  mesh=mesh, ep_axis="model")
out["moel4/model"] = y.full_tensor().numpy()
# reduced llama4-scout's train step with ep_axis="model" (cf 8.0: no drops)
la = reduced(get_arch("llama4-scout-17b-a16e"))
la = dataclasses.replace(la, stacks=tuple(
    dataclasses.replace(s, moe=dataclasses.replace(s.moe, capacity_factor=8.0)) if s.moe else s
    for s in la.stacks))
lp = init_lm(torch.Generator().manual_seed(0), la, device="cpu")
lrules = ShardingRules.default(mesh, la)
opt = sgdm()
lu = init_state(tree_map(torch.clone, lp), opt).tree()
ls = shard_state(init_state(tree_map(torch.clone, lp), opt).tree(), opt, mesh, lrules)
lb = batches(la, 1)[0]
lu, mu = build_train_step(la, opt, Runtime(), lr_schedule=lr)(lu, lb)
ls, ms = build_train_step(la, opt, Runtime(mesh=mesh, rules=lrules, ep_axis="model"),
                          lr_schedule=lr)(ls, lb)
out["ep_train/loss"] = np.stack([mu["loss"].numpy(), ms["loss"].numpy()])
put("ep_train/sharded", full_tree(ls["params"]))
put("ep_train/unsharded", lu["params"])
info["t_moe"] = time.time() - t0

# --- the recurrent and MLA decoders' sharded train step, against the
# unsharded step: losses, gradients (recorded from the step's own _grads)
# and params; MoE layers at cf 8.0 (no drops) with EP over model
from repro_torch.models import steps as S


def cf8(a):
    return dataclasses.replace(a, stacks=tuple(
        dataclasses.replace(s, moe=dataclasses.replace(s.moe, capacity_factor=8.0)) if s.moe
        else s for s in a.stacks))


og = S._grads
for name in cfg["decoders"]:
    da = cf8(reduced(get_arch(name)))
    dp = init_lm(torch.Generator().manual_seed(0), da, device="cpu")
    drules = ShardingRules.default(mesh, da)
    ep = "model" if any(s.moe for s in da.stacks) else None
    opt = sgdm()
    du = init_state(tree_map(torch.clone, dp), opt).tree()
    ds = shard_state(init_state(tree_map(torch.clone, dp), opt).tree(), opt, mesh, drules)
    db = batches(da, 1, seed=3)[0]
    grads = []
    S._grads = lambda *a: (lambda r: grads.append(r[0]) or r)(og(*a))
    du, mu = build_train_step(da, opt, Runtime(), lr_schedule=lr)(du, db)
    ds, ms = build_train_step(da, opt, Runtime(mesh=mesh, rules=drules, ep_axis=ep),
                              lr_schedule=lr)(ds, db)
    S._grads = og
    out[f"dec/{name}/loss"] = np.stack([mu["loss"].numpy(), ms["loss"].numpy()])
    put(f"dec/{name}/unsharded", du["params"])
    put(f"dec/{name}/sharded", full_tree(ds["params"]))
    put(f"dec/{name}/grad_unsharded", grads[0])
    put(f"dec/{name}/grad_sharded", full_tree(grads[1]))
info["t_decoders"] = time.time() - t0

# --- a deployed MoE's prefill on (2, 2): the experts' int8 codes and scales
# (q8 / s8) placed by the param specs, EP over model, against the unsharded
# prefill of the same deployed tree, dequantized and on the W8A8 path
from repro_torch.models.steps import build_prefill_step
from repro_torch.serve.engine import deploy_params
ma = cf8(reduced(get_arch("llama4-scout-17b-a16e")))
mrules = ShardingRules.default(mesh, ma)
mtok = torch.from_numpy(np.random.default_rng(6).integers(0, ma.vocab, (4, 16)))
with torch.no_grad():
    mtree = deploy_params(init_lm(torch.Generator().manual_seed(0), ma, device="cpu"), ma.quant)
    mplaced = shard_tree(mtree, param_specs(mtree, mesh, mrules), mesh)
    info["moe_codes_placed"] = sorted({
        "/".join(map(str, path[-2:])): str(list(v.placements)) for path, v in
        tree_leaves_with_path(mplaced) if "moe" in path and path[-1] in ("q8", "s8")}.items())
    for tag, kw in (("dequant", {}), ("int_forward", {"int_forward": True})):
        out[f"moe_prefill/{tag}/unsharded"] = build_prefill_step(ma, Runtime(**kw))(
            mtree, {"tokens": mtok}).numpy()
        out[f"moe_prefill/{tag}/sharded"] = build_prefill_step(
            ma, Runtime(mesh=mesh, rules=mrules, ep_axis="model", **kw))(
            mplaced, {"tokens": mtok}).full_tensor().numpy()

# --- the compressed step on the TP mesh, its codes fed from the stacked step
sa = reduced(get_arch("smollm-135m"))
sp = tree_of("smollm")
srules = ShardingRules.default(mesh, sa)
gc = GradCompressConfig(bits=8, scale_axis="column", axis="data")
m1 = Mesh.on_device("cpu", data=2)
r1 = ShardingRules.default(m1, sa)
pspecs, pspecs1 = param_specs(sp, mesh, srules), param_specs(sp, m1, r1)
opt = adamw()
st1 = init_state(tree_map(torch.clone, sp), opt).tree()
st1["grad_err"] = init_grad_err(sp, 2, pspecs=pspecs1, axis="data")
step1 = build_train_step(sa, opt, Runtime(mesh=m1, rules=r1, grad_compress=gc), lr_schedule=lr)
st2 = init_state(tree_map(torch.clone, sp), opt).tree()
st2["grad_err"] = init_grad_err(sp, 2, pspecs=pspecs, axis="data")
st2 = shard_state(st2, opt, mesh, srules, gc)
step2 = build_train_step(sa, opt, Runtime(mesh=mesh, rules=srules, grad_compress=gc),
                         lr_schedule=lr)
st3 = shard_state(init_state(tree_map(torch.clone, sp), opt).tree(), opt, mesh, srules)
step3 = build_train_step(sa, opt, Runtime(mesh=mesh, rules=srules), lr_schedule=lr)
losses = []
for i, b in enumerate(batches(sa, cfg["compress_steps"])):
    st1, ma = step1(st1, b)
    st2, mb = step2(st2, b)
    st3, mc = step3(st3, b)
    losses.append([float(ma["loss"]), float(mb["loss"]), float(mc["loss"])])
out["compress/loss"] = np.asarray(losses)
for part in ("local", "server"):
    info[f"compress_{part}_nonzero"] = all(float(e.full_tensor().abs().sum()) > 0 for _, e in
                                           tree_leaves_with_path(st2["grad_err"][part])[:1])

# the wire on the step's own gradients: PR 29's stacked step's group
# gradients fed to the sharded step (each rank its group's, cut to its
# tensor-parallel block), every code of both steps compared
og, oq = S._grads, C._quantize
st1 = init_state(tree_map(torch.clone, sp), opt).tree()
st1["grad_err"] = init_grad_err(sp, 2, pspecs=pspecs1, axis="data")
st2 = init_state(tree_map(torch.clone, sp), opt).tree()
st2["grad_err"] = init_grad_err(sp, 2, pspecs=pspecs, axis="data")
st2 = shard_state(st2, opt, mesh, srules, gc)
cdata = mesh.coordinate("data")
recorded, codes = [], {1: [], 2: []}


def block(g, p):
    if not isinstance(p, DTensor):
        return g
    ls, off = compute_local_shape_and_global_offset(g.shape, p.device_mesh, p.placements)
    return DTensor.from_local(g[tuple(slice(o, o + n) for o, n in zip(off, ls))].clone(),
                              p.device_mesh, list(p.placements), run_check=False)


def recording(*a):
    recorded.append(og(*a))
    return recorded[-1]


def fed(live, *a):
    grads, metrics = recorded[cdata]
    return tree_map(block, grads, live), metrics


def visit(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in visit(v, path + (k,))]
    return [path]


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


order = visit(sp)
sub = mesh.submesh("model").device_mesh()
wire_codes = {"n": 0, "differ": 0, "owners_agree": True}
for i, b in enumerate(batches(sa, cfg["compress_steps"])):
    recorded.clear()
    codes[1].clear(), codes[2].clear()
    for k, (grads_fn, run, st) in enumerate(((recording, step1, st1), (fed, step2, st2)), 1):
        S._grads = grads_fn
        C._quantize = lambda *a, k=k: codes[k].append(oq(*a)) or codes[k][-1]
        new, _ = run(st, b)
        S._grads, C._quantize = og, oq
        if k == 1:
            st1 = new
        else:
            st2 = new
    assert len(codes[1]) == len(codes[2]) == 2 * len(order)
    for j, path in enumerate(order):
        p = at(st2["params"], path)
        shape = tuple(p.shape)
        own = owner_dim(at(pspecs, path), len(shape), "data")
        wire_codes["owners_agree"] &= own == owner_dim(at(pspecs1, path), len(shape), "data")
        inner = [pl for m, pl in enumerate(p.placements) if m != 0]
        ls, off = compute_local_shape_and_global_offset(torch.Size(shape or (1,)), sub, inner)
        for phase in (0, 1):
            ref, mine = codes[1][2 * j + phase], codes[2][2 * j + phase]
            if phase == 0:  # this rank's row
                want = ref[cdata].reshape(shape or (1,))
            else:  # this rank's owner slice of the padded codes
                c = ref.shape[own] // 2
                want = ref.narrow(own, cdata * c, c)
            sl = tuple(slice(None) if (phase and m == own) else slice(o, o + n)
                       for m, (o, n) in enumerate(zip(off, ls)))
            want = want[sl].reshape(mine.shape)
            wire_codes["n"] += mine.numel()
            wire_codes["differ"] += int((want != mine).sum())
info["wire_codes"] = wire_codes

# the wire itself: compressed_allreduce_shard on each rank's row and
# tensor-parallel block against the stacked global view, bit for bit
wire_ok = {}
cdata = mesh.coordinate("data")
for fmt in ("tensor", "column"):
    for name, spec in cfg["wire_leaves"].items():
        spec = tuple(spec)
        pl = placements(spec, mesh)
        tp = pl[1]
        stack_tp = Shard(tp.dim + 1) if tp.is_shard() else tp
        shape = tuple(inp[f"wire/0/{name}"].shape[1:])
        own = owner_dim(spec, len(shape), "data")
        el = torch.zeros((2,) + shape)
        es = torch.zeros(C.server_shape(shape, 2, own))
        el_d = distribute_tensor(el, dm, [Shard(0), stack_tp])
        es_d = distribute_tensor(es, dm, [Shard(own if shape else 0),
                                          tp if not tp.is_shard() or tp.dim != own else Replicate()])
        groups = [mesh.group("model")] if tp.is_shard() and (
            fmt == "tensor" or tp.dim != len(shape) - 1) else []
        ok = True
        for r in range(3):
            g = torch.from_numpy(inp[f"wire/{r}/{name}"])
            row = distribute_tensor(g, dm, [Shard(0), stack_tp]).to_local()[0]
            total, new_l, new_s = C.compressed_allreduce_shard(
                row, el_d.to_local()[0], es_d.to_local(), group=mesh.group("data"), bits=8,
                scale_axis=fmt, owner=own, scale_groups=groups)
            el_d.to_local()[0].copy_(new_l)
            es_d.to_local().copy_(new_s)
            w_total, el, es = C.compressed_allreduce(
                g, el, es, mesh=m1, axis="data", bits=8, scale_axis=fmt,
                pspec=spec)
            got = DTensor.from_local(total, dm, [Replicate(), tp], run_check=False).full_tensor()
            ok &= torch.equal(got, w_total)
            ok &= torch.equal(el_d.full_tensor(), el) and torch.equal(es_d.full_tensor(), es)
        wire_ok[f"{fmt}/{name}"] = bool(ok)
info["wire"] = wire_ok
info["t_compress"] = time.time() - t0

# --- the KV-sharded serve step
ka = reduced(get_arch("yi-6b"))
ka = dataclasses.replace(ka, stacks=(dataclasses.replace(
    ka.stacks[0], attn=dataclasses.replace(ka.stacks[0].attn, kv_heads=cfg["kv4"])),)
    + ka.stacks[1:])
krules = ShardingRules.default(mesh, ka)
kp = tree_of("kv")
cache = init_cache(ka, 8, 32, dtype=torch.float32, device="cpu")
cs = cache_specs(cache, mesh, krules)
info["kspec"] = [e if not isinstance(e, tuple) else list(e) for e in cs["0"]["attn"]["k"]]
tokens = torch.from_numpy(inp["kv_tokens"])
ref, _ = build_serve_step(ka, Runtime())(kp, tokens, tree_map(torch.clone, cache), 0)
lg, nc = build_serve_step(ka, Runtime(mesh=mesh, rules=krules))(
    shard_tree(kp, param_specs(kp, mesh, krules), mesh), tokens, shard_tree(cache, cs, mesh), 0)
out["kv/logits"] = lg.full_tensor().numpy()
out["kv/unsharded"] = ref.numpy()
out["kv/kpos"] = nc["0"]["attn"]["kpos"].full_tensor().numpy()
info["t_kv"] = time.time() - t0

# --- the sharded prefill on local shards: flash attention (GQA heads cut
# per rank) and, deployed, the W8A8 path (rows x output columns)
pa = reduced(get_arch("yi-6b"))
prules = ShardingRules.default(mesh, pa)
pp = tree_of("yi")
ptok = torch.from_numpy(np.random.default_rng(5).integers(0, pa.vocab, (4, 16)))
with torch.no_grad():
    for tag, tree, kw in (("prefill", pp, {}),
                          ("prefill_int", deploy_params(pp, pa.quant), {"int_forward": True})):
        out[f"{tag}/unsharded"] = build_prefill_step(pa, Runtime(**kw))(
            tree, {"tokens": ptok}).numpy()
        out[f"{tag}/sharded"] = build_prefill_step(pa, Runtime(mesh=mesh, rules=prules, **kw))(
            shard_tree(tree, param_specs(tree, mesh, prules), mesh),
            {"tokens": ptok}).full_tensor().numpy()

# --- the launcher in this world: --mesh auto over its four ranks
os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
from repro_torch.launch import train as launch_train
import io
said = io.StringIO()
with contextlib.redirect_stdout(said):
    res = launch_train.main(cfg["launcher"])
info["launcher_stdout"] = said.getvalue()
info["launcher_losses"] = [h["loss"] for h in res.history]
info["t_launcher"] = time.time() - t0

# --- placements: each rank's block of every (shape, spec) pair (the pairs
# are written while this world runs)
while not os.path.exists(os.path.join(d, "pairs.json")):
    time.sleep(0.2)
pairs = json.load(open(os.path.join(d, "pairs.json")))
layout = {}
for k, m in meshes.items():
    rows = []
    for shape, spec in pairs:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        ls, off = compute_local_shape_and_global_offset(torch.Size(shape), m.device_mesh(),
                                                        placements(spec, m))
        rows.append([list(off), list(ls)])
    layout[k] = rows
json.dump(layout, open(os.path.join(d, f"layout{rank}.json"), "w"))

if rank == 0:
    np.savez(os.path.join(d, "out.npz"), **out)
    json.dump(info, open(os.path.join(d, "info.json"), "w"))
dist.barrier()
dist.destroy_process_group()
'''

JAX_SIDE = r'''
import json, os, sys, time
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import MoEConfig, QuantConfig
from repro.nn import moe

d = sys.argv[1]
cfg = json.load(open(os.path.join(d, "cfg.json")))
inp = dict(np.load(os.path.join(d, "in.npz")))
while not os.path.exists(os.path.join(d, "pairs.json")):
    time.sleep(0.2)
pairs = json.load(open(os.path.join(d, "pairs.json")))
layout = {}
for k, (a, b) in cfg["meshes"].items():
    mesh = Mesh(np.array(jax.devices()).reshape(a, b), ("data", "model"))
    order = list(mesh.devices.flat)
    rows = []
    for shape, spec in pairs:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
        rows.append([[[s.start or 0 for s in m[dev]],
                      [(s.stop if s.stop is not None else n) - (s.start or 0)
                       for s, n in zip(m[dev], shape)]] for dev in order])
    layout[k] = rows
params = {}
for key, v in inp.items():
    if key.startswith("moel4/p/"):
        node = params
        *head, last = key[len("moel4/p/"):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
q = QuantConfig(mode="none")
c = MoEConfig(**cfg["moel4"])
with mesh:
    y = jax.jit(lambda p, x: moe.apply_moe(p, x, c, q, ep_axis="model", mesh=mesh,
                                           compute_dtype=jnp.float32))(params, inp["moel4/x"])
np.save(os.path.join(d, "ref_moel4.npy"), np.asarray(y))
json.dump(layout, open(os.path.join(d, "ref_layout.json"), "w"))
print("ok")
'''


def _pairs():
    """Every distinct (shape, spec) of every arch's full-size param specs on
    the three meshes (the reference's shapes as ``meta`` tensors)."""
    pairs = set()
    for name in ARCH_NAMES:
        params = _meta_like(_boxed(name, False))
        arch = get_arch(name)
        for shape in MESHES.values():
            mesh = Mesh(("data", "model"), shape)
            specs = param_specs(params, mesh, ShardingRules.default(mesh, arch))
            pl = dict(tree_leaves_with_path(params))
            for path, spec in tree_leaves_with_path(specs):
                pairs.add((tuple(pl[path].shape), tuple(spec)))
    return sorted(pairs, key=repr)


def _jax_moe(key, cfg, d, shape):
    c = JMoEConfig(**cfg)
    p = unbox(jmoe.init_moe(jax.random.PRNGKey(key), d, c, JQuantConfig(mode="none")))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(key + 1), shape, jnp.float32))
    return _np(p), x


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The world's outputs and the reference's, from one set of inputs:
    ``(inputs, out, info, layouts by rank, reference layout, reference EP)``."""
    d = tmp_path_factory.mktemp("sharded")
    jarch, arch, yi = _model("yi-6b")
    inputs = {}
    _put(inputs, "yi", _push(yi, arch))
    _, _, sm = _model("smollm-135m")
    _put(inputs, "smollm", sm)
    kparams = _np(unbox(jinit_lm(jax.random.PRNGKey(0), _kv4(jreduced(jget_arch("yi-6b"))))))
    _put(inputs, "kv", _push(kparams, arch))
    inputs["kv_tokens"] = np.random.default_rng(0).integers(0, arch.vocab, (8, 1)).astype(
        np.int64)
    p8, x8 = _jax_moe(0, MOE8, 8, (4, 8, 8))
    _put(inputs, "moe8/p", p8)
    inputs["moe8/x"] = x8
    pl4, xl4 = _jax_moe(2, MOE_L4, 16, (4, 8, 16))
    _put(inputs, "moel4/p", pl4)
    inputs["moel4/x"] = xl4
    rng = np.random.default_rng(3)
    inputs["l1/v"] = rng.normal(size=(64, 12)).astype(np.float32)
    inputs["l1/stacked"] = rng.normal(size=(2, 64, 12)).astype(np.float32)
    inputs["l1/t"] = rng.normal(size=(12,)).astype(np.float32) + 4
    inputs["l1/d"] = rng.normal(size=(12,)).astype(np.float32) - 6
    inputs["l1/odd"] = rng.normal(size=(48, 12)).astype(np.float32)
    for r in range(3):
        for name, (shape, _) in WIRE_LEAVES.items():
            g = rng.normal(size=(2,) + shape).astype(np.float32)
            g *= np.float32(10.0) ** rng.integers(-2, 2, size=(2,) + (1,) * len(shape))
            inputs[f"wire/{r}/{name}"] = g.astype(np.float32)
    np.savez(d / "in.npz", **inputs)
    cfg = {"meshes": MESHES, "launcher": LAUNCHER, "lr": LR, "train_steps": TRAIN_STEPS, "adam_steps": ADAM_STEPS,
           "compress_steps": COMPRESS_STEPS, "moe8": MOE8, "moel4": MOE_L4, "kv4": KV4,
           "decoders": DECODERS,
           "wire_leaves": {k: list(sp) for k, (_, sp) in WIRE_LEAVES.items()}}
    (d / "cfg.json").write_text(json.dumps(cfg))
    (d / "world.py").write_text(WORLD)
    (d / "ref.py").write_text(JAX_SIDE)
    ref = subprocess.Popen(
        [sys.executable, str(d / "ref.py"), str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src")))
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(d / "world.py"), str(r), str(N), port, str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(N)]
    pairs = [[list(s), [list(e) if isinstance(e, tuple) else e for e in sp]] for s, sp in _pairs()]
    (d / "pairs.tmp").write_text(json.dumps(pairs))
    (d / "pairs.tmp").rename(d / "pairs.json")  # whole when it appears
    errs = [p.communicate(timeout=600)[1].decode() for p in procs + [ref]]
    failed = [e[-2500:] for p, e in zip(procs + [ref], errs) if p.returncode]
    assert not failed, "\n----\n".join(failed)
    info = json.loads((d / "info.json").read_text())
    print({k: v for k, v in info.items() if k.startswith("t_") or k in (
        "train_comm", "train_redistributed", "wire_codes")})
    return (inputs, dict(np.load(d / "out.npz")), info,
            [json.loads((d / f"layout{r}.json").read_text()) for r in range(N)],
            json.loads((d / "ref_layout.json").read_text()), np.load(d / "ref_moel4.npy"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_lay_out_every_arch_as_the_reference(run, mesh):
    """Each rank's DTensor block (offset and shape in every dim) of every
    full-size param spec is the block JAX's ``NamedSharding`` gives the
    device at the rank's position of the row-major mesh."""
    _, _, _, layouts, ref, _ = run
    n_pairs = len(ref[mesh])
    assert n_pairs > 100
    for i in range(n_pairs):
        for rank in range(N):
            assert layouts[rank][mesh][i] == ref[mesh][i][rank], (mesh, i, rank)


def test_placements_refuse_axes_out_of_the_mesh_order():
    """An entry listing two axes in another order than the mesh's is not a
    pair of ``Shard(d)``: refused by name, never mapped silently."""
    mesh = Mesh(("data", "model"), (2, 2))
    assert placements((("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match=r"\('model', 'data'\)"):
        placements((None, ("model", "data")), mesh)
    with pytest.raises(ValueError, match="pod"):
        placements(("pod",), mesh)


def _jax_steps(jarch, params, opt, n, seed):
    stream = TokenStream(vocab=jarch.vocab, seq_len=32, global_batch=8, seed=seed)
    step = jax.jit(jbuild_train_step(jarch, opt, JRuntime(), lr_schedule=lambda s: jnp.float32(LR)))
    jp = jax.tree.map(jnp.asarray, params)
    state = {"params": jp, "opt_state": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    losses = []
    for i in range(n):
        state, m = step(state, {k: jnp.asarray(v) for k, v in stream.batch(i).items()})
        losses.append(float(m["loss"]))
    return losses, _np(state["params"])


def test_sharded_train_step_matches_reference(run):
    """Two ``sgdm`` steps of reduced yi-6b on ``(data=2, model=2)`` against
    the reference's single-device step from the same params (``t`` off its
    cap): losses rtol 1e-4 (the reference's sharded test allows 1e-3),
    every param within 1e-5 of its leaf's largest |p|."""
    inputs, out, _, _, _, _ = run
    jarch, arch, yi = _model("yi-6b")
    losses, want = _jax_steps(jarch, _push(yi, arch), jopt.sgdm(), TRAIN_STEPS, 2)
    for i, w in enumerate(losses):
        got = float(out[f"train/loss/{i}"])
        np.testing.assert_allclose(got, w, rtol=1e-4)
        assert abs(got - w) < 1e-3
    for path, w in _np_leaves(want):
        got = out["train/params/" + _key(path)]
        assert np.abs(got - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-12), path


def test_sharded_adamw_steps_match_unsharded(run):
    """Four ``adamw`` steps (``donate=True``, in place on the DTensors)
    against the port's unsharded step: each loss to ``ADAM_TOL``, params
    within ``ADAM_PARAM_TOL`` of the most the steps can move them (adam
    scales each element's gradient to about the lr, so an element whose
    sum the shards round otherwise moves by another part of it)."""
    _, out, _, _, _, _ = run
    for i in range(ADAM_STEPS):
        u, s = out[f"adam/loss/{i}"]
        np.testing.assert_allclose(s, u, rtol=ADAM_TOL)
    keys = [k for k in out if k.startswith("adam/unsharded/")]
    assert keys
    for k in keys:
        w, got = out[k], out[k.replace("unsharded", "sharded", 1)]
        assert np.abs(got - w).max() <= ADAM_PARAM_TOL * LR * ADAM_STEPS, k


def test_a2q_l1_of_a_k_sharded_v_is_the_whole_tree(run):
    """``pairwise_sum`` of a ``v`` whose rows are split over ``data``, over
    ``(data, model)``, with its columns over ``model`` too, and stacked
    layers: bit for bit the unsharded tree (64 rows, shards of 32 and 16);
    ``apply_a2q`` on it likewise.  48 rows in shards of 24 pad at other
    places: within a few ulps."""
    _, _, info, _, _, _ = run
    l1 = info["l1"]
    for k in ("data", "data_model", "data_cols_model", "stacked", "apply_a2q"):
        assert l1[k], k
    assert l1["odd_max_rel"] < 1e-6


def test_moe_ep_matches_reference_local_path(run):
    """EP over ``model`` (tokens over ``data``) and over ``(model, data)``
    (one expert a shard, tokens replicated) at cf 8.0 within 1e-4 of the
    reference's ``ep_axis=None`` path on the same params (the reference's
    slow tests' gate); EP over ``model`` from DTensor experts, and no EP on
    the mesh (the local path on the gathered operands), likewise."""
    inputs, out, _, _, _, _ = run
    c = JMoEConfig(**MOE8)
    p8 = jax.tree.map(jnp.asarray, _tree(inputs, "moe8/p"))
    want = np.asarray(jmoe.apply_moe(p8, jnp.asarray(inputs["moe8/x"]), c,
                                     JQuantConfig(mode="none"), compute_dtype=jnp.float32))
    for tag in ("model", "model_data", "model_dtensor", "none"):
        assert np.abs(out[f"moe8/{tag}"] - want).max() < 1e-4, tag


def test_moe_ep_at_llama4_capacity_matches_reference_ep(run):
    """llama4-scout's routing (16 experts, top-1, cf 1.25) with EP over
    ``model`` and tokens split over ``data``: each shard's capacity is of its
    own 16 tokens, so it drops tokens one device keeps; the port's output is
    the reference's own EP branch's on four devices, within 1e-5, and not
    the local path's."""
    inputs, out, _, _, _, ref = run
    np.testing.assert_allclose(out["moel4/model"], ref, atol=1e-5)
    c = JMoEConfig(**MOE_L4)
    local = np.asarray(jmoe.apply_moe(jax.tree.map(jnp.asarray, _tree(inputs, "moel4/p")),
                                      jnp.asarray(inputs["moel4/x"]), c,
                                      JQuantConfig(mode="none"), compute_dtype=jnp.float32))
    assert np.abs(local - ref).max() > 1e-3  # the shards' capacity drops differ


def test_moe_ep_train_step_matches_unsharded(run):
    """Reduced llama4-scout (cf 8.0: no token dropped either way) one
    ``sgdm`` step with ``ep_axis="model"`` on ``(2, 2)`` against the
    port's unsharded step: the experts' gradients flow back through the
    local shards (partial over the token axes), the tokens' through the
    EP all-reduce."""
    _, out, _, _, _, _ = run
    u, s = out["ep_train/loss"]
    np.testing.assert_allclose(s, u, rtol=1e-5)
    keys = [k for k in out if k.startswith("ep_train/unsharded/")]
    assert any("/moe/" in k for k in keys)
    for k in keys:
        w, got = out[k], out[k.replace("unsharded", "sharded", 1)]
        assert np.abs(got - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-12), k


@pytest.mark.parametrize("name", DECODERS)
def test_sharded_train_step_of_recurrent_and_mla_decoders(run, name):
    """One ``sgdm`` step of reduced rwkv6-7b (the recurrence on each rank's
    rows and heads, ``u``'s gradient a partial sum where the rows split),
    hymba-1.5b (the mamba heads likewise, GQA's KV heads cut per rank) and
    deepseek-v3 (MLA's heads cut from a partial sum, EP over ``model``) on
    ``(2, 2)`` against the unsharded step from the same params: the loss at
    the yi-6b case's gate, every gradient leaf within ``GRAD_TOL`` of its
    largest |g| (a gradient off by a factor of a mesh dim is off by 1 or
    more), every param within ``PARAM_TOL`` of its leaf's largest |p|."""
    _, out, _, _, _, _ = run
    u, s = out[f"dec/{name}/loss"]
    np.testing.assert_allclose(s, u, rtol=1e-4)
    keys = [k for k in out if k.startswith(f"dec/{name}/grad_unsharded/")]
    assert len(keys) > 20
    top = max(np.abs(out[k]).max() for k in keys)
    for k in keys:
        w, got = out[k], out[k.replace("grad_unsharded", "grad_sharded", 1)]
        assert np.abs(got - w).max() <= GRAD_TOL * max(np.abs(w).max(), GRAD_FLOOR * top), k
    keys = [k for k in out if k.startswith(f"dec/{name}/unsharded/")]
    assert len(keys) > 20
    for k in keys:
        w, got = out[k], out[k.replace("unsharded", "sharded", 1)]
        assert np.abs(got - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-12), k


@pytest.mark.parametrize("tag", ["dequant", "int_forward"])
def test_sharded_deployed_moe_prefill(run, tag):
    """Reduced llama4-scout deployed (int8 expert codes ``q8`` and scales
    ``s8`` placed by the param specs: experts over ``model``), prefilled on
    ``(2, 2)`` with EP over ``model`` against the unsharded prefill of the
    same tree, dequantized and on the W8A8 path: within 1e-5 of the logits'
    largest |value|, as the yi-6b prefill."""
    _, out, info, _, _, _ = run
    placed = dict(info["moe_codes_placed"])
    assert {"w_in/q8", "w_in/s8", "w_out/q8", "w_out/s8"} <= set(placed)
    assert all("Shard" in v for k, v in placed.items() if k.startswith("w_")), placed
    want, got = out[f"moe_prefill/{tag}/unsharded"], out[f"moe_prefill/{tag}/sharded"]
    assert got.shape == want.shape == (4, 1, 256)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_compressed_step_on_tp_mesh(run):
    """Reduced smollm-135m, int8 ``column`` over ``data`` on ``(2, 2)``, 12
    ``adamw`` steps: within 0.05 nat of the uncompressed sharded step at
    every step (the reference's ``test_compressed_grad_training_on_tp_mesh``
    gate) and of PR 29's stacked-groups step on the same batches (its
    groups' gradients on one device; the tensor-parallel sums round
    otherwise, so an activation or a gradient at a rounding tie can move a
    code), with both residual trees live."""
    _, out, info, _, _, _ = run
    losses = out["compress/loss"]
    assert losses.shape == (COMPRESS_STEPS, 3)
    stacked, sharded, uncompressed = losses.T
    assert np.abs(sharded - uncompressed).max() < 0.05
    assert np.abs(sharded - stacked).max() < 0.05
    assert losses[-1, 1] < losses[0, 1] - 0.5  # it learns
    assert info["compress_local_nonzero"] and info["compress_server_nonzero"]
    print("compressed step: largest |sharded - stacked|", np.abs(sharded - stacked).max(),
          "|sharded - uncompressed|", np.abs(sharded - uncompressed).max())


def test_compressed_step_on_tp_mesh_sends_the_stacked_steps_codes(run):
    """PR 29's stacked-groups step and the sharded compressed step on the
    same 12 batches, the sharded step fed the stacked step's group
    gradients (each rank its group's, cut to its tensor-parallel block):
    every wire code of every leaf, phase 1 and 2, on every rank equals the
    stacked step's (the owner dims agree).  On their own gradients the two
    steps' codes part where the tensor-parallel sums round a gradient or
    an activation across a tie (``test_compressed_step_on_tp_mesh``)."""
    c = run[2]["wire_codes"]
    assert c["owners_agree"] and c["n"] > 0
    assert c["differ"] == 0, c


@pytest.mark.parametrize("fmt", ["tensor", "column"])
def test_compressed_wire_on_tp_mesh_is_the_stacked_wire(run, fmt):
    """``compressed_allreduce_shard`` on each rank's row and tensor-parallel
    block, three rounds of error feedback, against the stacked global view
    (``compressed_allreduce``, PR 29's step's transport) on the same
    gradients: totals and both residuals bit for bit (so every wire code
    equals), for an FSDP owner dim with columns over ``model``, rows over
    ``model`` (the scale agreed over it too), padded owner dims and a
    scalar."""
    wire = run[2]["wire"]
    for name in WIRE_LEAVES:
        assert wire[f"{fmt}/{name}"], name


def test_kv_sharded_serve_step(run):
    """One decode step with the cache's KV heads on ``model`` (``k`` dim 3,
    4 heads) and its batch on ``data``, an fp32 cache: logits within 1e-2 of
    the reference's single-device step (its slow test's gate) and within
    1e-5 of the port's own unsharded step; ``kpos`` written at position 0."""
    inputs, out, info, _, _, _ = run
    assert info["kspec"][3] == "model" and info["kspec"][1] == "data", info["kspec"]
    jarch = _kv4(jreduced(jget_arch("yi-6b")))
    params = jax.tree.map(jnp.asarray, _tree(inputs, "kv"))
    cache = jinit_cache(jarch, 8, 32, dtype=jnp.float32)
    want, _ = jbuild_serve_step(jarch, JRuntime())(params, jnp.asarray(inputs["kv_tokens"]),
                                                   cache, jnp.zeros((), jnp.int32))
    want = np.asarray(want, np.float32)
    assert np.abs(out["kv/logits"] - want).max() < 1e-2
    np.testing.assert_allclose(out["kv/logits"], out["kv/unsharded"], atol=1e-5)
    assert (out["kv/kpos"][:, :, 0] == 0).all() and (out["kv/kpos"][:, :, 1:] == -1).all()


@pytest.mark.parametrize("tag", ["prefill", "prefill_int"])
def test_sharded_prefill_on_local_shards(run, tag):
    """Reduced yi-6b's prefill on ``(2, 2)`` (4 query heads over 1 KV head:
    each rank's two query heads read its cut of the one KV head) against the
    unsharded step: the float path's flash attention, and the deployed
    tree's W8A8 path (``int_forward``, each rank's rows and output
    columns), within 1e-5 of the logits' largest |value|."""
    _, out, _, _, _, _ = run
    want, got = out[f"{tag}/unsharded"], out[f"{tag}/sharded"]
    assert got.shape == want.shape == (4, 1, 256)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", ["22_to_41", "unsharded_to_22"])
def test_reshard_on_restore(run, case):
    """A checkpoint of global arrays restores onto another mesh, each leaf
    placed by the live mesh's specs: ``(2, 2)`` -> ``(4, 1)`` and an
    unsharded run's -> ``(2, 2)``, bit for bit."""
    assert run[2]["reshard"][case]


def _tree(inputs, prefix):
    tree = {}
    for key, v in inputs.items():
        if key.startswith(prefix + "/"):
            node = tree
            *head, last = key[len(prefix) + 1:].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = v
    return tree


def test_launcher_mesh_auto_over_four_gloo_ranks(run, capsys):
    """``repro_torch.launch.train.main`` with ``--mesh auto --device cpu
    --reduced`` in the world of four ranks (``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` as ``torchrun`` sets them) prints the reference's
    ``mesh:`` line for four devices (rank 0 alone) and trains the same two
    steps as a world of one (here, no ``WORLD_SIZE``: unsharded, no
    ``mesh:`` line), within 1e-5."""
    from repro_torch.launch import train as launch_train

    info = run[2]
    arch = jreduced(jget_arch("yi-6b"))
    plan = jplan_mesh(N, model_divisors=[s.attn.heads for s in arch.stacks if s.attn])
    line = f"mesh: {dict(zip(plan['axes'], plan['shape']))}"
    assert line in info["launcher_stdout"].splitlines()
    os.environ.pop("WORLD_SIZE", None)
    single = launch_train.main(LAUNCHER)
    assert "mesh:" not in capsys.readouterr().out
    got = info["launcher_losses"]
    assert len(got) == len(single.history) == 2
    np.testing.assert_allclose(got, [h["loss"] for h in single.history], rtol=1e-5)


def test_kernel_ops_refuse_a_dtensor_operand():
    """Every ``kernels.ops`` op refuses a DTensor operand by name (a kernel
    would read one rank's shard as the whole tensor), before any other
    check; here in a world of one gloo rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import ops

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh.over_ranks("cpu", data=1)

        def dt(*shape, dtype=torch.float32):
            return DTensor.from_local(torch.zeros(shape, dtype=dtype), mesh.device_mesh(),
                                      [Replicate()])

        z = torch.zeros
        calls = {
            "int_matmul": lambda: ops.int_matmul(dt(4, 8, dtype=torch.int8),
                                                 z(8, 4, dtype=torch.int8)),
            "a2q_quantize": lambda: ops.a2q_quantize(dt(8, 4), z(4), z(4), weight_bits=8,
                                                     acc_bits=16, input_bits=8,
                                                     input_signed=True),
            "flash_attention": lambda: ops.flash_attention(dt(1, 2, 4, 8), z(1, 2, 4, 8),
                                                           z(1, 2, 4, 8)),
            "paged_attention": lambda: ops.paged_attention(
                dt(1, 2, 8), z(2, 4, 2, 8), z(2, 4, 2, 8), z(1, 1, dtype=torch.int32),
                z(1, dtype=torch.int32)),
            "paged_mla_attention": lambda: ops.paged_mla_attention(
                dt(1, 2, 8), z(1, 2, 4), z(2, 4, 8), z(2, 4, 4), z(1, 1, dtype=torch.int32),
                z(1, dtype=torch.int32), scale=1.0),
            "rwkv6_scan": lambda: ops.rwkv6_scan(dt(1, 2, 3, 4), z(1, 2, 3, 4), z(1, 2, 3, 4),
                                                 z(1, 2, 3, 4), z(2, 4)),
        }
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"^{name}: an operand is a DTensor"):
                call()
    finally:
        dist.destroy_process_group()


def test_dry_run_collectives_equal_the_real_world(run):
    """The dry-run's trace of one ``sgdm`` step of reduced yi-6b on a fake
    ``(2, 2)`` world (fake tensors, nothing allocated) makes the collectives
    of the four gloo ranks' real second step: the same counts as
    ``CommDebugMode``'s, and the same counts and result bytes by kind as the
    real step's own trace."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.lm import Runtime
    from repro_torch.optim.optimizers import sgdm

    _, _, info, _, _, _ = run
    arch = reduced(get_arch("yi-6b"))
    with fake_mesh(dryrun.trace_device(), data=2, model=2) as mesh:
        rules = ShardingRules.default(mesh, arch)
        got = dryrun.trace_step(arch, ShapeSpec("t", "train", 32, 8), mesh, rules,
                                Runtime(mesh=mesh, rules=rules), optimizer=sgdm(),
                                lr_schedule=lambda s: torch.tensor(LR))["collectives"]
    assert not dist.is_initialized()
    funcol = {"all-gather": "all_gather_into_tensor", "reduce-scatter": "reduce_scatter_tensor",
              "all-reduce": "all_reduce"}
    comm = {k.split(".")[-1]: v for k, v in info["train_comm"].items()}
    assert got["counts"] == info["train_coll"]["counts"]
    assert got["bytes_by_kind"] == info["train_coll"]["bytes_by_kind"]
    for kind, n in got["counts"].items():
        assert n == comm.get(funcol.get(kind, kind), 0), (kind, n, info["train_comm"])
    assert got["counts"]["all-gather"] > 0 and got["counts"]["reduce-scatter"] > 0
