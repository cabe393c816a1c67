"""Optimizers, from scratch: SGD-M, Adam(W), Adafactor — port of
``repro.optim.optimizers``.

Each optimizer is an ``(init, update)`` pair of pure functions over nested
dicts of tensors (the params tree).  The state trees are the reference's —
``{"m"}`` (SGD-M), ``{"m", "v", "count"}`` (AdamW), ``{"v", "count"}`` with
factored ``{"vr", "vc"}`` or full ``{"v"}`` second moments per leaf
(Adafactor) — so a checkpoint written by either package loads into the
other.  The arithmetic is the reference's fp32 expressions in the same
order; ``count`` is an int32 0-dim tensor on the params' device, so an
update reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.nn.module import tree_leaves_with_path, tree_map, tree_unzip

__all__ = ["Optimizer", "sgdm", "adamw", "adafactor", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state)


def _count_like(params) -> torch.Tensor:
    leaf = tree_leaves_with_path(params)[0][1]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf in fp32, the leaves summed in
    the reference's (sorted-key) order."""
    total = 0
    for _, leaf in tree_leaves_with_path(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = g + weight_decay * p
            m_new = momentum * m + g
            step = (g + momentum * m_new) if nesterov else m_new
            return p - lr * step, m_new

        new_params, new_m = tree_unzip(tree_map(upd, grads, state["m"], params), 2)
        return new_params, {"m": new_m}

    return Optimizer(init, update)


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Bias-corrected Adam with decoupled weight decay added to the step
    inside the lr product (``p - lr * (m̂ / (sqrt(v̂) + eps) + wd * p)``), eps
    outside the square root — the reference's update, which
    ``torch.optim.AdamW`` (decay as ``p * (1 - lr * wd)`` before the step,
    eps after dividing the root by the bias correction) does not compute."""

    def init(params):
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": _count_like(params),
        }

    def update(grads, state, params, lr):
        c = state["count"] + 1
        cf = c.to(torch.float32)
        bc1 = 1 - b1**cf
        bc2 = 1 - b2**cf

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + weight_decay * p
            return (p - lr * step).to(p.dtype), m_new, v_new

        new_p, new_m, new_v = tree_unzip(tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"m": new_m, "v": new_v, "count": c}

    return Optimizer(init, update)


def adafactor(
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    """Factored second moments: O(n+m) state for an (n, m) matrix instead of
    O(nm) — the optimizer-memory lever for the 35B/671B configs."""

    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def one(p):
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"v": tree_map(one, params), "count": _count_like(params)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        rho = torch.clamp(c.to(torch.float32) ** -decay, max=1.0)

        def upd(p, g, v):  # v: this leaf's {"vr", "vc"} or {"v"}
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + eps
            if "vr" in v:
                vr = (1 - rho) * v["vr"] + rho * g2.mean(dim=-1)
                vc = (1 - rho) * v["vc"] + rho * g2.mean(dim=-2)
                denom_r = vr / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
                u = (g32 * torch.rsqrt(denom_r + eps)[..., None]
                     * torch.rsqrt(vc + eps)[..., None, :])
                nv = {"vr": vr, "vc": vc}
            else:
                vv = (1 - rho) * v["v"] + rho * g2
                u = g32 * torch.rsqrt(vv + eps)
                nv = {"v": vv}
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * u).to(p.dtype), nv

        # walked over the params' keys, so each leaf's state dict arrives whole
        new_p, new_v = tree_unzip(tree_map(upd, params, grads, state["v"]), 2)
        return new_p, {"v": new_v, "count": c}

    return Optimizer(init, update)
