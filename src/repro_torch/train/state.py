"""Train state: params + optimizer state + step, the compressed gradient
reduction's residuals, the state's specs and their shardings (port of
``repro.train.state``; ``shard_state`` places a state on a mesh bound to a
world's ranks)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.dist.collectives import GradCompressConfig, owner_dim, server_shape, strip_axis
from repro_torch.dist.sharding import NamedSharding, ShardingRules, param_specs
from repro_torch.nn.module import tree_leaves_with_path, tree_map, tree_map_with_path
from repro_torch.optim.optimizers import Optimizer

__all__ = ["TrainState", "init_state", "init_grad_err", "make_state_specs",
           "specs_to_shardings", "shard_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}

    @staticmethod
    def from_tree(t):
        return TrainState(t["params"], t["opt_state"], t["step"])


def init_state(params, optimizer: Optimizer) -> TrainState:
    """The state at step 0 of ``params`` (a tree of tensors on one device);
    the step is an int32 0-dim tensor on that device."""
    leaf = tree_leaves_with_path(params)[0][1]
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=leaf.device))


def init_grad_err(params, n_shards: int, pspecs=None, axis: Optional[str] = None):
    """Zero error-feedback residuals for the compressed gradient reduction
    (``dist.collectives.compressed_allreduce``), on each param's device:

    * ``local``  — the phase-1 (quantization) residual, one fp32 row per
      shard: leaf ``(d0, ...)`` -> ``(n_shards, d0, ...)``;
    * ``server`` — the phase-2 (requantization) residual kept by each
      owner: param-shaped with the ownership dim padded to a multiple of
      ``n_shards`` (``server_shape``).  ``pspecs``/``axis`` (the param spec
      tree and the compression axis) pick the ownership dim the reduction
      uses; omitted = dim 0 everywhere.
    """
    def zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    local = tree_map(lambda p: zeros((n_shards,) + tuple(p.shape), p), params)
    if pspecs is None:
        server = tree_map(lambda p: zeros(server_shape(p.shape, n_shards), p), params)
    else:
        server = tree_map(lambda p, s: zeros(
            server_shape(p.shape, n_shards, owner_dim(s, p.dim(), axis)), p), params, pspecs)
    return {"local": local, "server": server}


def _grad_err_specs(pspecs, axis: str):
    """Residual specs: both trees lead with the compression axis (``local``
    on its per-shard stack dim, ``server`` on the owner dim); the other dims
    keep the param's spec without the compression axis."""

    def local_one(spec):
        return (axis, *strip_axis(spec, axis))

    def server_one(spec):
        entries = strip_axis(spec, axis)
        if not entries:  # scalar param: server is (n_shards,)
            return (axis,)
        entries[owner_dim(spec, len(entries), axis)] = axis
        return tuple(entries)

    return {"local": tree_map(local_one, pspecs), "server": tree_map(server_one, pspecs)}


def make_state_specs(params, optimizer: Optimizer, mesh, rules: ShardingRules,
                     grad_compress: Optional[GradCompressConfig] = None) -> dict:
    """Spec tree for a ``TrainState.tree()`` of ``params`` (any tensors,
    ``meta`` ones included).

    Optimizer states keyed like the params (momenta, variances) take their
    param's spec, trimmed or extended by a dim when their rank differs by
    one; any other leaf (a 0-dim count, adafactor's per-leaf ``vr``/``vc``
    dicts) replicates, as the reference's path lookup gives them.
    ``grad_compress`` (with a resolved ``axis``) adds the ``grad_err``
    residual specs."""
    pspecs = param_specs(params, mesh, rules)
    with torch.device("meta"):
        opt_shapes = optimizer.init(tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                                                   device="meta"), params))

    def spec_for(path, leaf):
        if leaf.dim() == 0:
            return ()
        node = pspecs
        for k in (path[1:] if len(path) > 1 else path):
            if not isinstance(node, dict) or k not in node:
                return ()
            node = node[k]
        if not isinstance(node, tuple):
            return ()
        if len(node) == leaf.dim():
            return node
        if len(node) == leaf.dim() + 1:  # a trailing axis reduced
            return node[:-1]
        if len(node) == leaf.dim() - 1:
            return node + (None,)
        return ()

    spec = {"params": pspecs, "opt_state": tree_map_with_path(spec_for, opt_shapes), "step": ()}
    if grad_compress is not None:
        if grad_compress.axis is None:
            raise ValueError("grad_compress.axis must be resolved (resolve_grad_compress)")
        spec["grad_err"] = _grad_err_specs(pspecs, grad_compress.axis)
    return spec


def specs_to_shardings(spec_tree, mesh):
    """A spec tree as a tree of ``dist.sharding.NamedSharding`` on ``mesh``
    (the reference's; each one's ``placements`` are DTensor's)."""
    return tree_map(lambda s: NamedSharding(mesh, tuple(s)), spec_tree)


def shard_state(state: dict, optimizer: Optimizer, mesh, rules: ShardingRules,
                grad_compress: Optional[GradCompressConfig] = None) -> dict:
    """A ``TrainState.tree()`` (global tensors, the same on every rank) placed
    on a mesh bound to a world's ranks by ``make_state_specs``: the params
    by ``param_specs`` (TP on ``model``, FSDP on ``data``), adamw's moments
    and every optimizer leaf keyed like a param by its param's spec, the
    rest (counts, the step, adafactor's factored moments) replicated, and
    ``grad_err`` when the state has one.  Each rank keeps its shards."""
    gc = grad_compress if "grad_err" in state else None
    specs = make_state_specs(state["params"], optimizer, mesh, rules, gc)
    shardings = specs_to_shardings(specs, mesh)
    return {k: tree_map(lambda sh, t: sh.place(t), shardings[k], v) for k, v in state.items()}
