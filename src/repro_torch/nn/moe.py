"""Mixture-of-experts FFN: top-k routing, capacity-bounded dispatch, and
shared experts.

Port of ``repro.nn.moe``, with the reference's expert-parallel branches
(``ep_axis``, on a mesh bound to a world's ranks; see ``apply_moe``).  No
``(T, E, C)`` one-hot dispatch tensor is built:

1. the router's fp32 softmax picks each token's top-k experts, whose
   probabilities are renormalised to sum to one;
2. the (token, expert) assignments are sorted by expert with a stable sort,
   so within an expert they keep token order;
3. each expert keeps its first ``capacity = max(int(T * k * cf / E), 1)``
   assignments, packed into one buffer; the rest are dropped (standard
   token-dropping semantics, in the reference's order);
4. the experts' FFN (SiLU-gated, in the compute dtype) runs in a static
   form, the same in prefill and decode, with no value read back to the
   host: ``S = min(E, T * k)`` expert slots, each slot's expert id chosen
   on the device (the routed ids in ascending order, then unrouted ids,
   whose rows are empty), each slot ``capacity`` rows of the packed buffer
   gathered from its expert's offset with the rows past the kept count
   masked out, and one batched product per weight over the slots — the
   reference's ``ragged_dot`` on the same rows;
5. gate-weighted outputs are summed back per token, over its k slots in a
   fixed order (no atomics, so a run on the card repeats itself).

Expert weights are ``(E, d_in, d_out)`` with per-(expert, channel) A2Q
``t``/``d``, so each expert output channel is its own accumulator (float
``mode="none"`` experts too; baseline-QAT experts carry ``w`` and a
per-(expert, channel) ``wq.log2_scale``).  Each slot's quantized (or
deployed ``q8 * s8``) weight view is built on the device from its expert id
(``index_select`` on the stacked leaves), a few slots at a time
(``SLOT_CHUNK_ELEMS``), never for all experts at once: at deepseek-v3's
width one expert leaf is 3.8 G values.  When autograd records the forward
(training), each batch of slots (``TRAIN_SLOT_CHUNK_ELEMS``) runs under
``torch.utils.checkpoint``: the fake-quant views' temporaries are
recomputed one batch at a time in the backward instead of kept for every
expert at once (an A2Q view keeps about five of its size for the backward,
~40 GB over llama4-scout's 48 expert matrices).  The routed experts
have no fused integer path (as in the reference): under ``int_forward`` they
run on the dequantized view and are booked as a ``fallback`` in the chain
report, while the shared experts are plain linears and take the fused W8A8
kernel.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import MoEConfig, QuantConfig
from repro_torch.core.a2q import apply_a2q, init_a2q
from repro_torch.dist.sharding import constrain, sharded_scope
from repro_torch.core.bounds import int_range
from repro_torch.core.quantizers import (
    apply_act_quant,
    clip,
    init_act_quant,
    init_weight_qat,
    ste_round,
)
from repro_torch.nn.linear import (
    _record,
    _warn_fallback_once,
    apply_linear,
    init_linear,
    linear_penalty,
)
from repro_torch.nn.module import kaiming, tree_leaves_with_path, tree_map

__all__ = ["init_moe", "apply_moe", "moe_penalty"]


def _init_expert_weight(gen, e: int, d_in: int, d_out: int, q: QuantConfig) -> dict:
    """``(e, d_in, d_out)`` expert weights drawn one expert at a time (so an
    A2Q init never holds more than one expert's float temporaries).  QAT
    experts add ``wq.log2_scale (e, d_out)``, each (expert, channel)'s
    max-abs calibration ``log2(max(absmax over d_in, 1e-8) / (2^(M-1) - 1))``."""
    dev = gen.device
    if q.mode in ("none", "qat"):
        w = torch.empty((e, d_in, d_out), dtype=torch.float32, device=dev)
        for i in range(e):
            w[i] = kaiming(gen, (d_in, d_out), fan_in=d_in)
        if q.mode == "none":
            return {"w": w}
        scale = torch.empty((e, d_out), dtype=torch.float32, device=dev)
        for i in range(e):
            scale[i] = init_weight_qat(w[i], q.weight_bits)["log2_scale"]
        return {"w": w, "wq": {"log2_scale": scale}}
    v = torch.empty((e, d_in, d_out), dtype=torch.float32, device=dev)
    t = torch.empty((e, d_out), dtype=torch.float32, device=dev)
    d = torch.empty((e, d_out), dtype=torch.float32, device=dev)
    for i in range(e):
        a = init_a2q(kaiming(gen, (d_in, d_out), fan_in=d_in), q.weight_bits, q.acc_bits,
                     q.act_bits, True)
        v[i], t[i], d[i] = a["v"], a["t"], a["d"]
    return {"v": v, "t": t, "d": d}


def _expert_weight_view(p: dict, q: QuantConfig, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Quantized (fake-quant) views ``(s, d_in, d_out)`` of the experts
    ``ids (s,)`` (a device tensor) of an ``(E, d_in, d_out)`` expert weight in
    ``dtype`` — the reference's fp32 whole-leaf view, gathered at ``ids`` and
    cast."""
    if "q8" in p:  # deployed int8 storage
        # one kernel: q8 * s8 in fp32, rounded once into `dtype`, the same
        # values as (q8.float() * s8).to(dtype) without the fp32 round trip
        # through device memory
        q8 = p["q8"].index_select(0, ids)
        s8 = p["s8"].index_select(0, ids)
        return torch.mul(q8, s8[:, None, :], out=q8.new_empty(q8.shape, dtype=dtype))
    if q.mode == "none":
        return p["w"].index_select(0, ids).to(dtype)
    if q.mode == "qat":  # clip(ste_round(w / s), n, p) * s, s per (expert, channel)
        n, pmax = int_range(q.weight_bits, signed=True)
        scale = torch.exp2(p["wq"]["log2_scale"].index_select(0, ids))[:, None, :]
        w = p["w"].index_select(0, ids)
        return (clip(ste_round(w / scale), n, pmax) * scale).to(dtype)
    # A2Q's norms are per (expert, channel): one expert at a time
    v, t, d = (p[k].index_select(0, ids) for k in ("v", "t", "d"))
    return torch.stack([apply_a2q({"v": v[i], "t": t[i], "d": d[i]}, q.weight_bits, q.acc_bits,
                                  q.act_bits, True) for i in range(ids.shape[0])]).to(dtype)


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, q: QuantConfig) -> dict:
    p = {
        "router": kaiming(gen, (d_model, cfg.n_experts), fan_in=d_model),
        "w_in": _init_expert_weight(gen, cfg.n_experts, d_model, cfg.d_ff, q),
        "w_gate": _init_expert_weight(gen, cfg.n_experts, d_model, cfg.d_ff, q),
        "w_out": _init_expert_weight(gen, cfg.n_experts, cfg.d_ff, d_model, q),
    }
    if q.mode != "none":
        p["aq"] = init_act_quant(q.act_bits, True, device=gen.device)
    if cfg.n_shared:
        ff = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        p["shared_in"] = init_linear(gen, d_model, ff, q)
        p["shared_gate"] = init_linear(gen, d_model, ff, q)
        p["shared_out"] = init_linear(gen, ff, d_model, q)
    return p


SLOT_CHUNK_ELEMS = 1 << 28  # weight elements a batch of expert slots dequantizes at once
TRAIN_SLOT_CHUNK_ELEMS = 1 << 26  # the same under autograd, a batch recomputed in the backward


def _local_expert_ffn(x_buf: torch.Tensor, params: dict, group_sizes: torch.Tensor,
                      q: QuantConfig, compute_dtype, n_slots: int) -> torch.Tensor:
    """Packed ragged FFN: rows ``[off_e, off_e + group_sizes[e])`` of
    ``x_buf (L, d)`` go through expert ``e`` (``group_sizes (E,)`` on the
    device, each at most ``capacity = L // E``); rows past the last group
    give zeros, as ``ragged_dot`` leaves them.

    Static shapes only: ``n_slots`` slots, each an expert id chosen on the
    device (the ids with rows first, ascending, then ids without), each
    ``capacity`` rows gathered from its expert's offset with the rows past
    its count masked to zero, one batched product per weight; the slots'
    rows are scattered back to the packed order (a masked row into a spare
    row past ``L``)."""
    cd = compute_dtype
    L, d = x_buf.shape
    E = group_sizes.shape[0]
    C = L // E
    dev = x_buf.device
    offsets = torch.cumsum(group_sizes, 0) - group_sizes
    ar = torch.arange(E, device=dev)
    ids = torch.argsort(torch.where(group_sizes > 0, ar, ar + E))[:n_slots]  # (S,)
    rows = torch.arange(C, device=dev)[None, :]
    valid = rows < group_sizes[ids][:, None]  # (S, C)
    src = offsets[ids][:, None] + rows  # within [0, L): offsets[e] + C <= (e + 1) C
    xs = torch.where(valid[..., None], x_buf[src].to(cd), torch.zeros((), dtype=cd, device=dev))
    leaf = next(iter(params["w_in"].values()))  # q8, w or v: (E, d, d_ff)
    weights = {k: params[k] for k in ("w_in", "w_gate", "w_out")}
    recorded = torch.is_grad_enabled() and (x_buf.requires_grad or any(
        t.requires_grad for _, t in tree_leaves_with_path(weights)))
    budget = TRAIN_SLOT_CHUNK_ELEMS if recorded else SLOT_CHUNK_ELEMS
    step = max(1, budget // (leaf.shape[-2] * leaf.shape[-1]))

    def slots(w, sl, xc):
        h_in = torch.bmm(xc, _expert_weight_view(w["w_in"], q, sl, cd))
        h_gate = torch.bmm(xc, _expert_weight_view(w["w_gate"], q, sl, cd))
        h = F.silu(h_gate.to(torch.float32)).to(cd) * h_in
        return torch.bmm(h, _expert_weight_view(w["w_out"], q, sl, cd))

    ys = []
    for lo in range(0, ids.shape[0], step):
        sl, xc = ids[lo:lo + step], xs[lo:lo + step]
        if recorded:
            ys.append(checkpoint(slots, weights, sl, xc, use_reentrant=False))
        else:
            ys.append(slots(weights, sl, xc))
    y = torch.zeros((L + 1, d), dtype=cd, device=dev)  # w_out maps back to d
    y[torch.where(valid, src, L)] = torch.cat(ys)
    return y[:L]


def _dispatch_compute_combine(x2d: torch.Tensor, probs: torch.Tensor, params: dict,
                              cfg: MoEConfig, q: QuantConfig, compute_dtype,
                              shard_idx: int = 0, n_shards: int = 1) -> torch.Tensor:
    """The routed experts' output for ``x2d (T, d)`` from ``probs (T, E)``,
    as the reference's: with ``n_shards`` expert shards, ``params`` holds
    shard ``shard_idx``'s ``E / n_shards`` experts and only the assignments
    to them run (the rest sort last and are dropped here); ``capacity`` is
    of the ``T`` tokens given."""
    T, d = x2d.shape
    E = cfg.n_experts
    E_loc = E // n_shards
    k = cfg.top_k
    capacity = max(int(T * k * cfg.capacity_factor / E), 1)
    L = E_loc * capacity
    dev = x2d.device

    top_p, top_e = torch.topk(probs, k, dim=-1)  # (T, k), descending
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(T * k, device=dev) // k

    local_e = flat_e - shard_idx * E_loc
    is_local = (local_e >= 0) & (local_e < E_loc)
    sort_key = torch.where(is_local, local_e, torch.full_like(local_e, E_loc))  # others last
    order = torch.argsort(sort_key, stable=True)  # by expert, token order within
    se, st, sp = sort_key[order], flat_tok[order], flat_p[order]

    # each local expert's segment of the sorted ids (no bincount: its CUDA
    # form reads the largest id back to the host)
    seg_start = torch.searchsorted(se, torch.arange(E_loc + 1, device=dev))
    counts = seg_start[1:] - seg_start[:-1]
    capped = torch.clamp_max(counts, capacity)
    offsets = torch.cumsum(capped, 0) - capped
    pos_in_group = torch.arange(se.shape[0], device=dev) - seg_start[se]
    keep = (se < E_loc) & (pos_in_group < capacity)
    dest = torch.where(keep, offsets[torch.clamp_max(se, E_loc - 1)] + pos_in_group,
                       torch.full_like(se, L))

    x_buf = x2d.new_zeros((L + 1, d))
    x_buf[dest] = x2d[st]  # dropped rows all land in row L, which is cut off
    y_buf = _local_expert_ffn(x_buf[:L], params, capped, q, compute_dtype, min(E_loc, T * k))
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, d))])
    contrib = y_buf[dest] * sp[:, None].to(y_buf.dtype)  # dropped rows read zeros
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    # the segment sum over each token's k slots, in a fixed order (no atomics):
    # back from expert order to (token, slot) order, then sum the slots
    by_token = torch.zeros_like(contrib).index_copy_(0, order, contrib)
    return by_token.reshape(T, k, d).sum(1).to(x2d.dtype)


class _SumOverRanks(torch.autograd.Function):
    """``psum`` of the local partial outputs over process groups, in turn.
    Its backward passes the gradient through: the sum is replicated, so
    each rank's partial output gets the sum's own gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _entry(axes):
    return None if not axes else (axes[0] if len(axes) == 1 else tuple(axes))


def _expert_parallel(x2d, probs, params, cfg, q, compute_dtype, mesh, ep_axes, token_axes):
    """The reference's ``shard_map`` EP branch as local code on each rank's
    shards: tokens split over ``token_axes`` (``()``: replicated), experts
    over ``ep_axes`` with the shard index row-major over the *listed* axes;
    each rank builds the views of its own ``E / n`` experts from its local
    leaves and the partial outputs meet in one all-reduce over the EP axes.
    Gradients flow back through DTensor: the tokens' as partial sums over
    the EP axes, each expert leaf's as partial sums over the token axes."""
    dm = mesh.device_mesh()
    names = tuple(mesh.axis_names)
    n_shards = math.prod(mesh.shape[a] for a in ep_axes)
    if cfg.n_experts % n_shards:
        raise ValueError(f"{cfg.n_experts} experts over {n_shards} EP shards")
    E_loc = cfg.n_experts // n_shards
    idx = 0
    for a in ep_axes:  # row-major over the listed axes
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
    # within the block of the first listed axis, the rank's slice
    first = ep_axes[0]
    sub = idx - mesh.coordinate(first) * (n_shards // mesh.shape[first])
    tok_spec = (_entry(token_axes), None)
    x_d, p_d = constrain(x2d, mesh, tok_spec), constrain(probs, mesh, tok_spec)
    grad_in = [Partial() if a in ep_axes else p for a, p in zip(names, x_d.placements)]
    x_l = x_d.to_local(grad_placements=grad_in)
    p_l = p_d.to_local(grad_placements=grad_in)

    def local(leaf):
        if not isinstance(leaf, DTensor):  # a global tensor on every rank
            return leaf[idx * E_loc:(idx + 1) * E_loc]
        want = [Shard(0) if a == first else Replicate() for a in names]
        grads = [Shard(0) if a == first else
                 (Partial() if a in ep_axes or a in token_axes else Replicate()) for a in names]
        block = leaf.redistribute(dm, want).to_local(grad_placements=grads)
        return block[sub * E_loc:(sub + 1) * E_loc]

    experts = {k: tree_map(local, params[k]) for k in ("w_in", "w_gate", "w_out")}
    out_l = _dispatch_compute_combine(x_l, p_l, experts, cfg, q, compute_dtype, idx, n_shards)
    out_l = _SumOverRanks.apply(out_l, [mesh.group(a) for a in ep_axes])
    return DTensor.from_local(out_l, dm, list(x_d.placements), run_check=False)


def apply_moe(
    params: dict,
    x: torch.Tensor,  # (B, T, d)
    cfg: MoEConfig,
    q: QuantConfig,
    *,
    compute_dtype=torch.bfloat16,
    int_forward: bool = False,
    int_chain: bool = False,
    mesh=None,
    ep_axis=None,
) -> torch.Tensor:
    """The MoE FFN of ``x``.  On a mesh bound to a world's ranks
    (``dist.sharding.Mesh.over_ranks``), ``ep_axis`` runs the experts
    expert-parallel, as the reference's ``shard_map`` branches:

    * a mesh axis (``"model"``): experts split over it, tokens over the
      other axes when the token count divides them (replicated otherwise),
      so each shard's capacity is of its own tokens and it may drop tokens
      that one device keeps;
    * a tuple of axes (``("model", "data")``, the serving layout): experts
      split row-major over the listed axes, tokens replicated.

    Without ``ep_axis`` a sharded call runs the local path on the gathered
    tensors, replicated on every rank."""
    with sharded_scope(mesh):
        return _apply_moe(params, x, cfg, q, compute_dtype, int_forward, int_chain, mesh, ep_axis)


def _apply_moe(params, x, cfg, q, compute_dtype, int_forward, int_chain, mesh, ep_axis):
    B, T, d = x.shape
    if int_forward and "q8" in params.get("w_in", {}):
        # routed experts run on the dequantized view: no fused integer path,
        # so the entry act-quant is booked as a fallback, never "standalone"
        _record("fallback", "moe.experts")
        _warn_fallback_once("moe.experts",
                            "ragged expert dispatch keeps the dequantized weight view")
    if q.mode != "none" and "aq" in params:
        x = apply_act_quant({"log2_scale": params["aq"]["log2_scale"]}, x, q.act_bits,
                            signed=True)
    x2d = x.reshape(B * T, d)
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    spmd = mesh is not None and mesh.spmd
    if spmd and ep_axis is not None:
        ep_axes = (ep_axis,) if isinstance(ep_axis, str) else tuple(ep_axis)
        token_axes = ()
        if isinstance(ep_axis, str):  # tokens over the other axes when divisible
            other = tuple(a for a in mesh.axis_names if a != ep_axis)
            if other and (B * T) % math.prod(mesh.shape[a] for a in other) == 0:
                token_axes = other
        out = _expert_parallel(x2d, probs, params, cfg, q, compute_dtype, mesh, ep_axes,
                               token_axes).reshape(B, T, d)
    elif spmd:
        whole = [t.full_tensor() if isinstance(t, DTensor) else t for t in (x2d, probs)]
        experts = {k: tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                               params[k]) for k in ("w_in", "w_gate", "w_out")}
        out = constrain(_dispatch_compute_combine(*whole, experts, cfg, q, compute_dtype),
                        mesh, (None, None)).reshape(B, T, d)
    else:
        out = _dispatch_compute_combine(x2d, probs, params, cfg, q,
                                        compute_dtype).reshape(B, T, d)
    if "shared_in" in params:
        # shared experts are plain 2-D linears; the silu gate makes each a
        # chain break, so under int_chain each quantizes in its prologue
        lin = functools.partial(apply_linear, cfg=q, compute_dtype=compute_dtype,
                                int_forward=int_forward, int_chain=int_chain)
        h = F.silu(lin(params["shared_gate"], x=x, site="moe.shared_gate").to(torch.float32))
        h = h.to(compute_dtype) * lin(params["shared_in"], x=x, site="moe.shared_in")
        out = out + lin(params["shared_out"], x=h, site="moe.shared_out")
    return out


def moe_penalty(params: dict, cfg: MoEConfig, q: QuantConfig) -> torch.Tensor:
    """A2Q regularizer over the routed experts (every (expert, channel)'s
    ``max(t - T, 0)``) and the shared experts; 0 unless ``q.mode == "a2q"``.
    ``cfg`` is unused, as in the reference."""
    total = torch.zeros((), dtype=torch.float32)
    for name in ("w_in", "w_gate", "w_out", "shared_in", "shared_gate", "shared_out"):
        if name in params:
            total = total + linear_penalty(params[name], q, False, True)
    return total
