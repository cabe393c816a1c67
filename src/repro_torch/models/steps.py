"""Step builders over ``models.lm``, ported from ``repro.models.steps``:

* ``build_train_step`` — forward + backward of ``lm_loss``, grad clip and
  the optimizer update; on a mesh bound to a world's ranks the step runs
  sharded on DTensors (params and state placed by ``param_specs`` /
  ``make_state_specs``, the batch by ``rt.batch_spec``); with
  ``Runtime(mesh, grad_compress)`` the data-parallel gradients meet through
  the int-quantized wire first (the reference's compressed step): the
  stacked global view of ``compressed_allreduce_tree`` on one device, or
  each rank's own gradient through ``compressed_allreduce_shard`` over the
  data axis's group;
* ``build_prefill_step`` — one forward over a prompt or an utterance,
  returning the last position's logits: the reference's entry point for an
  encoder (hubert), which has no serving engine;
* ``build_serve_step`` — one cached decode step over a contiguous cache
  (placed by ``cache_specs`` on a bound mesh: the KV-sharded decode).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import (
    compressed_allreduce_shard,
    compressed_allreduce_tree,
    owner_dim,
    resolve_grad_compress,
)
from repro_torch.dist.sharding import ShardingRules, constrain, param_specs, sharded_scope
from repro_torch.models.lm import Runtime, apply_lm, lm_loss
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.optim.optimizers import Optimizer, global_norm

__all__ = ["build_train_step", "build_prefill_step", "build_serve_step"]


def build_train_step(
    arch: ArchConfig,
    optimizer: Optimizer,
    rt: Optional[Runtime] = None,
    lr_schedule: Optional[Callable] = None,
    grad_clip: float = 1.0,
    donate: bool = False,
):
    """``train_step(state, batch) -> (new_state, metrics)`` over ``state =
    {"params", "opt_state", "step"}`` (``step`` an int32 0-dim tensor) and a
    batch of ``tokens`` and/or ``frontend_embeds``, and ``targets``, tensors
    on the params' device.  The params are differentiated as detached copies
    that require grad, so the state's tensors never do (and a deploy of them
    reaches the kernels); the update runs under ``no_grad``.  ``metrics``
    (``loss``, ``ce``, ``penalty``, ``mtp_ce`` with an MTP head,
    ``grad_norm``, ``lr``) are 0-dim device tensors: nothing is read back to
    the host.  The fresh gradients are clipped in place.  ``donate=True`` is
    the reference's donated state buffers: the update runs a leaf at a time
    and writes the new params and optimizer state into the given state's
    tensors, so a step holds one copy of them and one leaf's temporaries
    (the same values; the given state must not be read afterwards).

    ``rt.grad_compress`` on a ``rt.mesh`` whose compression axis has more
    than one position (``resolve_grad_compress``) builds the compressed
    step instead (``_build_compressed_train_step``, or on a bound mesh
    ``_build_sharded_compressed_train_step``).

    On a mesh bound to a world's ranks (``rt.mesh.spmd``) every rank calls
    the step with the same global batch; the state's leaves are DTensors
    (``train.state.shard_state``), the batch is split by ``rt.batch_spec``,
    and the gradients and updates keep each leaf's placement (``donate``
    writes into the DTensors in place).  The metrics come back as plain
    tensors, the same on every rank."""
    rt = rt or Runtime()
    lr_schedule = lr_schedule or (lambda step: torch.full((), 3e-4, dtype=torch.float32))
    gc = resolve_grad_compress(rt.grad_compress, rt.mesh)
    spmd = rt.mesh is not None and rt.mesh.spmd
    if gc is not None:
        build = _build_sharded_compressed_train_step if spmd else _build_compressed_train_step
        return build(arch, optimizer, rt, lr_schedule, grad_clip, gc, donate)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        if not spmd:
            grads, metrics = _grads(state["params"], arch, batch, rt)
            return _update(state, grads, metrics, optimizer, lr_schedule, grad_clip, donate)
        batch = {k: constrain(v, rt.mesh, rt.batch_spec(v.dim())) for k, v in batch.items()}
        with sharded_scope(rt.mesh):
            grads, metrics = _grads(state["params"], arch, batch, rt)
            grads = tree_map(_placed_like, grads, state["params"])
            new, metrics = _update(state, grads, metrics, optimizer, lr_schedule, grad_clip,
                                   donate)
            new = {k: tree_map(_placed_like, v, state[k]) for k, v in new.items()}
        return new, {k: _whole(v) for k, v in metrics.items()}

    return train_step


def _placed_like(new, old):
    """``new`` in ``old``'s placement (a DTensor the propagation left
    partial or elsewhere); plain tensors pass."""
    if isinstance(new, DTensor) and isinstance(old, DTensor) and \
            list(new.placements) != list(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _grads(params, arch: ArchConfig, batch: dict, rt: Runtime):
    """``(gradients of lm_loss, detached metrics)`` at ``params``."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = lm_loss(live, arch, batch, rt=rt)
        leaves = []
        tree_map(leaves.append, live)  # in tree_map's order, for the rebuild below
        # a leaf the loss does not reach gets zeros, as jax.grad gives it
        got = iter(torch.autograd.grad(loss, leaves, materialize_grads=True))
    grads = tree_map(lambda _: next(got), live)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _update(state: dict, grads, metrics: dict, optimizer: Optimizer, lr_schedule,
            grad_clip: float, donate: bool, **extra) -> tuple[dict, dict]:
    """Clip ``grads`` in place, run the optimizer, step the count; the new
    state carries ``extra`` leaves beside the params."""
    params, opt_state, step = state["params"], state["opt_state"], state["step"]
    with torch.no_grad():
        # clip_by_global_norm's arithmetic on the fresh gradients, in place
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
        tree_map(lambda g: g.mul_(scale), grads)
        lr = lr_schedule(step)
        if donate:
            new_params, new_opt = _update_in_place(optimizer, grads, opt_state, params, lr)
        else:
            new_params, new_opt = optimizer.update(grads, opt_state, params, lr)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return {"params": new_params, "opt_state": new_opt, "step": step + 1, **extra}, metrics


def _build_compressed_train_step(arch, optimizer, rt, lr_schedule, grad_clip, gc, donate):
    """Train step whose data-parallel gradient reduction is the
    int-quantized two-phase ``compressed_allreduce_tree`` (the reference's
    ``_build_compressed_train_step``).

    The global batch splits into ``n_shards = mesh.shape[gc.axis]`` groups
    of rows along the batch dim, which must divide it.  Each group's
    gradient is that of ``lm_loss`` over its own rows: the quantities an
    uncompressed data-parallel step would all-reduce in fp32.  They are
    stacked ``(n_shards, *shape)``, divided by ``n_shards`` (the global
    mean loss's gradient is the mean of the groups') and meet as
    ``gc.bits``-wide integers in ``compressed_allreduce_tree``, each leaf's
    owner dim read from ``param_specs`` under ``rt.rules`` (dim 0 without
    rules); the clip and the update then run on the reduced gradient, as
    uncompressed.  The error-feedback residual pair is carried in
    ``state["grad_err"]`` (``train.state.init_grad_err``); the metrics are
    the groups' means.  On one device every group runs on it in turn: the
    stacked global view the reference's shards compute together."""
    mesh, axis = rt.mesh, gc.axis
    n_shards = int(mesh.shape[axis])
    inner_rt = Runtime(mla_absorb=rt.mla_absorb)
    specs: dict = {}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        rows = {t.shape[0] for t in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % n_shards:
            raise ValueError(f"grad_compress: global batch {sorted(rows)} must be a multiple "
                             f"of the {axis!r} axis extent {n_shards}")
        per = next(iter(rows)) // n_shards
        if "pspecs" not in specs:
            specs["pspecs"] = None if rt.rules is None else param_specs(params, mesh, rt.rules)
        stacked, group_metrics = None, []
        for i in range(n_shards):
            grads, m = _grads(params, arch, {k: v[i * per:(i + 1) * per]
                                             for k, v in batch.items()}, inner_rt)
            if stacked is None:
                stacked = tree_map(lambda g: torch.empty((n_shards,) + tuple(g.shape),
                                                         dtype=g.dtype, device=g.device), grads)
            with torch.no_grad():  # ÷ n as a tensor: correctly rounded on every device
                tree_map(lambda s, g: s[i].copy_(g / torch.full((), n_shards, dtype=g.dtype,
                                                                device=g.device)), stacked, grads)
            group_metrics.append(m)
            del grads
        with torch.no_grad():
            reduced, new_err = compressed_allreduce_tree(
                stacked, state["grad_err"], mesh=mesh, axis=axis, bits=gc.bits,
                scale_axis=gc.scale_axis, pspec_tree=specs["pspecs"])
        del stacked
        metrics = {k: torch.stack([m[k] for m in group_metrics]).mean(0)
                   for k in group_metrics[0]}
        return _update(state, reduced, metrics, optimizer, lr_schedule, grad_clip, donate,
                       grad_err=new_err)

    return train_step


def _strip_axis_rules(rules: Optional[ShardingRules], axis: str) -> Optional[ShardingRules]:
    """The rules of a model pass inside one group of the compression axis:
    its activations may name only the other mesh axes."""
    if rules is None:
        return None
    return ShardingRules(rules={k: tuple(a for a in v if a != axis) for k, v in rules.rules.items()},
                         unit_counts=dict(rules.unit_counts))


def _build_sharded_compressed_train_step(arch, optimizer, rt, lr_schedule, grad_clip, gc, donate):
    """The compressed step on a mesh bound to a world's ranks: each rank of
    the compression axis (``gc.axis``, of ``n`` positions) is one group.

    Each rank gathers its params over the axis (FSDP's all-gather: it keeps
    their placement on the other axes, its tensor-parallel shards), runs
    ``lm_loss`` on its own ``B / n`` rows on the other axes' submesh (the
    reference's ``_strip_axis_rules``), and divides its gradient by ``n``:
    the data-parallel partial sum an uncompressed step would all-reduce in
    fp32.  Those meet as ``gc.bits``-wide codes in
    ``compressed_allreduce_shard`` over the axis's group, a leaf at a time,
    with this rank's row of ``state["grad_err"]["local"]`` and its owner
    slice of ``["server"]`` (both placed by ``train.state.make_state_specs``);
    the codes are those of the stacked global view on the same gradients.
    The clip and the update then run on the reduced gradient, in the
    params' placement; the metrics are the groups' means."""
    mesh, axis = rt.mesh, gc.axis
    n = int(mesh.shape[axis])
    rank = mesh.coordinate(axis)
    group = mesh.group(axis)
    others = tuple(a for a in mesh.axis_names if a != axis)
    inner_mesh = mesh.submesh(*others) if others else None
    inner_rt = Runtime(mesh=inner_mesh, rules=_strip_axis_rules(rt.rules, axis),
                       mla_absorb=rt.mla_absorb,  # an EP axis of the submesh only
                       ep_axis=rt.ep_axis if isinstance(rt.ep_axis, str) and rt.ep_axis != axis
                       else None)
    at = mesh.axis_names.index(axis)
    specs: dict = {}

    def gathered(p):
        """This rank's params without the axis's split, on the submesh."""
        if not isinstance(p, DTensor):
            return p
        local = p.redistribute(p.device_mesh, [Replicate() if i == at else pl for i, pl in
                                               enumerate(p.placements)]).to_local()
        if inner_mesh is None:
            return local
        keep = [pl for i, pl in enumerate(p.placements) if i != at]
        return DTensor.from_local(local, inner_mesh.device_mesh(), keep, run_check=False)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        rows = {t.shape[0] for t in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"grad_compress: global batch {sorted(rows)} must be a multiple "
                             f"of the {axis!r} axis extent {n}")
        per = next(iter(rows)) // n
        if "pspecs" not in specs:
            specs["pspecs"] = param_specs(params, mesh, rt.rules) if rt.rules is not None \
                else tree_map(lambda p: (), params)
        mine = {k: _group_rows(v, at, rank, per) for k, v in batch.items()}
        mine = {k: constrain(v, inner_mesh, inner_rt.batch_spec(v.dim())) for k, v in mine.items()}
        live = tree_map(gathered, params)
        with sharded_scope(inner_mesh):
            grads, metrics = _grads(live, arch, mine, inner_rt)
            grads = tree_map(_placed_like, grads, live)
        metrics = {k: _whole(v) for k, v in metrics.items()}
        with torch.no_grad():
            err = state["grad_err"]

            def reduce(g, p, spec, el, es):
                g = g.to_local() if isinstance(g, DTensor) else g
                g = g / torch.full((), n, dtype=g.dtype, device=g.device)  # the groups' mean
                scale_groups = [mesh.group(a) for a, pl in zip(mesh.axis_names, p.placements)
                                if a != axis and pl.is_shard() and
                                (gc.scale_axis == "tensor" or pl.dim != g.dim() - 1)] \
                    if isinstance(p, DTensor) else []
                el_l, es_l = (e.to_local() if isinstance(e, DTensor) else e for e in (el, es))
                total, new_l, new_s = compressed_allreduce_shard(
                    g, el_l[0], es_l, group=group, bits=gc.bits, scale_axis=gc.scale_axis,
                    owner=owner_dim(spec, g.dim(), axis), scale_groups=scale_groups)
                el_l[0].copy_(new_l)
                es_l.copy_(new_s)
                if not isinstance(p, DTensor):
                    return total
                whole = [Replicate() if i == at else pl for i, pl in enumerate(p.placements)]
                return DTensor.from_local(total, p.device_mesh, whole,
                                          run_check=False).redistribute(p.device_mesh,
                                                                        p.placements)

            reduced = tree_map(reduce, grads, params, specs["pspecs"], err["local"],
                               err["server"])
        # the groups' means, as the stacked step's (each rank's loss of its rows)
        metrics = {k: _group_mean(v, group, n) for k, v in metrics.items()}
        with sharded_scope(mesh):
            new, metrics = _update(state, reduced, metrics, optimizer, lr_schedule, grad_clip,
                                   donate, grad_err=err)
            new = {k: tree_map(_placed_like, v, state[k]) for k, v in new.items()}
        return new, {k: _whole(v) for k, v in metrics.items()}

    return train_step


def _group_rows(v, at: int, rank: int, per: int) -> torch.Tensor:
    """This rank's group's ``per`` rows of a batch leaf: a slice of a global
    tensor, or of a DTensor batch the rows split over the compression axis
    (mesh dim ``at``) alone."""
    if isinstance(v, DTensor):
        return v.redistribute(v.device_mesh, [Shard(0) if i == at else Replicate()
                                              for i in range(v.device_mesh.ndim)]).to_local()
    return v[rank * per:(rank + 1) * per]


def _group_mean(v: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean over a group's ranks of a 0-dim metric (stacked in rank
    order and averaged, as the stacked step's ``torch.stack(...).mean(0)``)."""
    parts = [torch.empty_like(v) for _ in range(n)]
    dist.all_gather(parts, v.contiguous(), group=group)
    return torch.stack(parts).mean(0)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _single(path, value):
    return value if not path else {path[0]: _single(path[1:], value)}


def _update_in_place(optimizer: Optimizer, grads, opt_state, params, lr):
    """``optimizer.update`` a param leaf at a time (every ported optimizer is
    leafwise but for its shared ``count``), each result copied into the old
    tensors: the state's trees keyed like the params (``m``, ``v``, the
    per-leaf dicts of adafactor's ``v``) are cut to the leaf's path, the
    rest (``count``) passed whole and written once at the end."""
    trees = {k for k, v in opt_state.items() if isinstance(v, dict)}
    new_rest = {}
    for path, p in tree_leaves_with_path(params):
        sub = {k: _single(path, _at(opt_state[k], path)) if k in trees else v
               for k, v in opt_state.items()}
        new_p, new_s = optimizer.update(_single(path, _at(grads, path)), sub,
                                        _single(path, p), lr)
        p.copy_(_placed_like(_at(new_p, path), p))
        for k in trees:
            tree_map(lambda old, new: old.copy_(_placed_like(new, old)), _at(opt_state[k], path),
                     _at(new_s[k], path))
        new_rest = {k: v for k, v in new_s.items() if k not in trees}
    for k, v in new_rest.items():
        opt_state[k].copy_(_placed_like(v, opt_state[k]))
    return params, opt_state


def build_prefill_step(arch: ArchConfig, rt: Optional[Runtime] = None):
    """``prefill_step(params, batch) -> logits[:, -1:, :]`` of one cacheless
    forward over ``batch["tokens"]`` and/or ``batch["frontend_embeds"]``."""
    rt = rt or Runtime()

    def prefill_step(params: dict, batch: dict):
        logits, _ = apply_lm(params, arch, tokens=batch.get("tokens"),
                             frontend_embeds=batch.get("frontend_embeds"), rt=rt)
        return logits[:, -1:, :]

    return prefill_step


def build_serve_step(arch: ArchConfig, rt: Optional[Runtime] = None):
    """``serve_step(params, tokens (B, 1), cache, pos) -> (logits (B, 1, V),
    cache)``: one cached step over a contiguous cache (``models.lm.init_cache``),
    written in place at each row's position ``pos``.  On a bound mesh the
    params and the cache are DTensors (``param_specs``, ``cache_specs``:
    the KV heads over ``model``, the batch over ``data``) and the tokens
    split by ``rt.batch_spec``; the logits come back sharded."""
    rt = rt or Runtime()

    def serve_step(params: dict, tokens: torch.Tensor, cache: dict, pos):
        tokens = constrain(tokens, rt.mesh, rt.batch_spec(tokens.dim()))
        return apply_lm(params, arch, tokens=tokens, cache=cache, start_pos=pos, rt=rt)

    return serve_step
