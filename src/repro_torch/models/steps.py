"""Step builders over ``models.lm``, ported from ``repro.models.steps``:

* ``build_train_step`` — forward + backward of ``lm_loss``, grad clip and
  the optimizer update; with ``Runtime(mesh, grad_compress)`` the
  data-parallel gradients meet through the int-quantized
  ``compressed_allreduce_tree`` first (the reference's compressed step);
* ``build_prefill_step`` — one forward over a prompt or an utterance,
  returning the last position's logits: the reference's entry point for an
  encoder (hubert), which has no serving engine;
* ``build_serve_step`` — one cached decode step over a contiguous cache.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.collectives import compressed_allreduce_tree, resolve_grad_compress
from repro_torch.dist.sharding import param_specs
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
    step instead (``_build_compressed_train_step``)."""
    rt = rt or Runtime()
    lr_schedule = lr_schedule or (lambda step: torch.full((), 3e-4, dtype=torch.float32))
    gc = resolve_grad_compress(rt.grad_compress, rt.mesh)
    if gc is not None:
        return _build_compressed_train_step(arch, optimizer, rt, lr_schedule, grad_clip, gc,
                                            donate)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        grads, metrics = _grads(state["params"], arch, batch, rt)
        return _update(state, grads, metrics, optimizer, lr_schedule, grad_clip, donate)

    return train_step


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
        p.copy_(_at(new_p, path))
        for k in trees:
            tree_map(lambda old, new: old.copy_(new), _at(opt_state[k], path),
                     _at(new_s[k], path))
        new_rest = {k: v for k, v in new_s.items() if k not in trees}
    for k, v in new_rest.items():
        opt_state[k].copy_(v)
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
    written in place at each row's position ``pos``."""
    rt = rt or Runtime()

    def serve_step(params: dict, tokens: torch.Tensor, cache: dict, pos):
        return apply_lm(params, arch, tokens=tokens, cache=cache, start_pos=pos, rt=rt)

    return serve_step
