"""Blocks and layer stacks.

A model is a sequence of *stacks*; each stack is ``count`` identical blocks
whose parameters are stacked along a leading ``count`` axis, as in
``repro.nn.transformer`` (which scans them); here a Python loop applies
them in order.  Ported block kinds: ``attn_mlp`` (pre-norm GQA or MLA + gated
or plain MLP, optionally command-r's parallel attention+FFN), ``moe`` (the
same attention + the mixture-of-experts FFN), ``rwkv6`` (pre-norm RWKV-6
time-mix + channel-mix, attention-free) and ``hymba`` (sliding-window
attention and Mamba-2 SSD heads in parallel on one norm, averaged, then the
MLP); ``conv`` raises.

When autograd records the forward (training), each block runs under
``torch.utils.checkpoint`` unless ``arch.remat == "none"``, as the
reference wraps its scanned block in ``jax.checkpoint``: a block's
activations are recomputed in the backward instead of kept.  The A2Q
fake-quant weights of a stack's linears are then computed once for all
its layers (``apply_a2q`` over the stacked leaves, the same values as layer
by layer) and kept through the backward, outside the recompute: layer by
layer, forward, recompute and backward, they were most of a step's
operators.  A MoE's routed experts are left out: their views are built a
few experts at a time inside ``nn.moe`` (all of them at once would not fit
at llama4-scout's width).  A cacheless forward writes no state in place,
so a recomputed block sees what its first run saw.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, QuantConfig, StackConfig
from repro_torch.core.a2q import apply_a2q
from repro_torch import resolve_device
from repro_torch.nn.attention import apply_attention, init_attention, init_attn_cache
from repro_torch.kernels.ref import gelu_tanh
from repro_torch.nn.linear import IntAct, apply_linear, chain_out_aq, init_linear, linear_penalty
from repro_torch.nn.module import tree_leaves_with_path
from repro_torch.nn.moe import apply_moe, init_moe
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.nn.ssm import (
    apply_mamba_heads,
    apply_rwkv6_channelmix,
    apply_rwkv6_timemix,
    init_mamba_heads,
    init_mamba_state,
    init_rwkv6_channelmix,
    init_rwkv6_timemix,
)

__all__ = ["init_stack", "apply_stack", "init_stack_cache", "tree_a2q_penalty",
           "COMPUTE_DTYPES"]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _init_mlp(gen, d: int, ff: int, q: QuantConfig, gated: bool, use_bias: bool) -> dict:
    p = {
        "w_in": init_linear(gen, d, ff, q, use_bias=use_bias),
        "w_out": init_linear(gen, ff, d, q, use_bias=use_bias),
    }
    if gated:
        p["w_gate"] = init_linear(gen, d, ff, q, use_bias=use_bias)
    return p


def _apply_mlp(p: dict, x: torch.Tensor, q: QuantConfig, compute_dtype,
               int_forward: bool = False, int_chain: bool = False) -> torch.Tensor:
    lin = functools.partial(apply_linear, cfg=q, compute_dtype=compute_dtype,
                            int_forward=int_forward, int_chain=int_chain)
    if "w_gate" in p:
        # the silu(gate) * up product is a chain break: every edge quantizes
        # in its own kernel's prologue
        h = lin(p["w_in"], x=x, site="mlp.w_in")
        gate = lin(p["w_gate"], x=x, site="mlp.w_gate")
        h = F.silu(gate.to(torch.float32)).to(compute_dtype) * h
        return lin(p["w_out"], x=h, site="mlp.w_out")
    # w_in -> gelu -> w_out is a producer/consumer chain: under int_chain w_in
    # requantizes into w_out's quantizer in its epilogue (gelu replayed there)
    # and hands int8 codes across; otherwise the host runs jax.nn.gelu's tanh
    # form, op by op as the epilogue replays it
    out_aq = chain_out_aq(p["w_out"], q, act_fn="gelu") if int_chain else None
    h = lin(p["w_in"], x=x, site="mlp.w_in", out_aq=out_aq)
    if not isinstance(h, IntAct):
        h = gelu_tanh(h.to(torch.float32)).to(compute_dtype)
    return lin(p["w_out"], x=h, site="mlp.w_out")


def _check_kind(s: StackConfig) -> None:
    if s.kind not in ("attn_mlp", "moe", "rwkv6", "hymba"):
        raise NotImplementedError(f"block kind {s.kind!r} is not ported yet")


def _init_block(gen, arch: ArchConfig, s: StackConfig) -> dict:
    _check_kind(s)
    d, q = arch.d_model, arch.quant
    if s.kind == "rwkv6":
        return {"ln1": init_norm(d, arch.norm, device=gen.device),
                "tm": init_rwkv6_timemix(gen, d, s.ssm, q),
                "ln2": init_norm(d, arch.norm, device=gen.device),
                "cm": init_rwkv6_channelmix(gen, d, s.d_ff, q)}
    if s.kind == "hymba":
        return {"ln1": init_norm(d, arch.norm, device=gen.device),
                "attn": init_attention(gen, d, s.attn, q, arch.use_bias),
                "mamba": init_mamba_heads(gen, d, s.ssm, q),
                "ln2": init_norm(d, arch.norm, device=gen.device),
                "mlp": _init_mlp(gen, d, s.d_ff, q, s.mlp_gated, arch.use_bias)}
    p = {"ln1": init_norm(d, arch.norm, device=gen.device),
         "attn": init_attention(gen, d, s.attn, q, arch.use_bias)}
    if not s.parallel_block:
        p["ln2"] = init_norm(d, arch.norm, device=gen.device)
    if s.kind == "attn_mlp":
        p["mlp"] = _init_mlp(gen, d, s.d_ff, q, s.mlp_gated, arch.use_bias)
    else:
        p["moe"] = init_moe(gen, d, s.moe, q)
    return p


def _apply_block(p: dict, x: torch.Tensor, arch: ArchConfig, s: StackConfig,
                 positions: torch.Tensor, cache: Optional[dict], *,
                 mla_absorb: bool = False, view: Optional[dict] = None,
                 decode_kernel: bool = False, int_forward: bool = False,
                 int_chain: bool = False, mesh=None, ep_axis=None):
    q = arch.quant
    cd = COMPUTE_DTYPES[arch.compute_dtype]
    norm = functools.partial(apply_norm, kind=arch.norm, eps=arch.norm_eps)
    kw = dict(compute_dtype=cd, int_forward=int_forward, int_chain=int_chain)

    if s.kind == "rwkv6":  # the recurrent leaves of a cache are updated in place
        y, _ = apply_rwkv6_timemix(p["tm"], norm(p["ln1"], x), s.ssm, q,
                                   (cache or {}).get("tm"), **kw)
        x = x + y
        y, _ = apply_rwkv6_channelmix(p["cm"], norm(p["ln2"], x), q, (cache or {}).get("cm"), **kw)
        return x + y

    h = norm(p["ln1"], x)
    attn_out, _ = apply_attention(  # a paged cache is written in place
        p["attn"], h, s.attn, q, positions, (cache or {}).get("attn"),
        q_chunk=arch.attn_q_chunk, mla_absorb=mla_absorb, view=view,
        decode_kernel=decode_kernel, **kw,
    )
    if s.kind == "hymba":  # attention and mamba heads on one norm, averaged
        m_out, _ = apply_mamba_heads(p["mamba"], h, s.ssm, q, (cache or {}).get("mamba"), **kw)
        x = x + 0.5 * (attn_out + m_out)
        return x + _apply_mlp(p["mlp"], norm(p["ln2"], x), q, cd, int_forward, int_chain)

    def ffn(h):
        if s.kind == "moe":
            return apply_moe(p["moe"], h, s.moe, q, compute_dtype=cd, int_forward=int_forward,
                             int_chain=int_chain, mesh=mesh, ep_axis=ep_axis)
        return _apply_mlp(p["mlp"], h, q, cd, int_forward, int_chain)

    if s.parallel_block:
        return x + attn_out + ffn(h)
    x = x + attn_out
    return x + ffn(norm(p["ln2"], x))


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(count, ...)`` leaves (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def tree_a2q_penalty(p: dict, q: QuantConfig) -> torch.Tensor:
    """Sum of every A2Q layer's regularizer in a params tree (a block's, or
    a stack's with its ``(count, ...)`` leaves: the penalty is elementwise
    over ``t``/``d``, so a stacked leaf sums its layers, and stacked experts'
    ``(count, E, C)`` caps need nothing of their own: ``nn.moe.moe_penalty``'s
    sum).  The channel-mix ``cm.wv``
    (post-relu^2, unsigned input) is the one layer whose cap uses
    ``1_signed = 0``; every other matmul sees signed inputs."""
    total = torch.zeros((), dtype=torch.float32)
    if q.mode != "a2q":
        return total

    def walk(node, path):
        nonlocal total
        if "t" in node and "d" in node and "v" in node:
            signed = path[-2:] != ("cm", "wv")
            total = total + linear_penalty(node, q, False, signed)
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(p, ())
    return total


def _fake_quant_layers(p: dict, q: QuantConfig, compute_dtype) -> dict:
    """A stack's params with each A2Q linear's ``v``/``t``/``d`` replaced by
    ``fq``, its fake-quant weights for every layer ``(count, K, C)`` in
    ``compute_dtype`` (what ``nn.linear._quant_weights`` would compute
    layer by layer); the activation quantizers and biases stay, and so do
    stacked routed experts (``t`` of ``(count, E, C)``)."""
    def walk(node, path):
        if "v" in node and "t" in node and "d" in node and node["t"].ndim == 2:
            out = {k: v for k, v in node.items() if k not in ("v", "t", "d")}
            out["fq"] = apply_a2q(node, q.weight_bits, q.acc_bits, q.act_bits,
                                  path[-2:] != ("cm", "wv"), dtype=compute_dtype)
            return out
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else v for k, v in node.items()}

    return walk(p, ())


def _unbind_layers(tree, count: int) -> list:
    """The per-layer trees of stacked ``(count, ...)`` leaves, each leaf
    unbound once (its backward stacks the layers' gradients in one
    operator, where a per-layer index would scatter each into a zeroed
    stack)."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, count) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(count)]
    return tree.unbind(0)


def init_stack(gen: torch.Generator, arch: ArchConfig, s: StackConfig) -> dict:
    """Stacked (leading ``count`` axis) params for one stack."""
    layers = [_init_block(gen, arch, s) for _ in range(s.count)]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        return torch.stack(leaves)

    return stack(*layers)


def apply_stack(params: dict, x: torch.Tensor, arch: ArchConfig, s: StackConfig,
                positions: torch.Tensor, cache: Optional[dict] = None, *,
                mla_absorb: bool = False, view: Optional[dict] = None,
                decode_kernel: bool = False, int_forward: bool = False,
                int_chain: bool = False, mesh=None, ep_axis=None):
    """Apply ``s.count`` blocks in order and return ``x``; a paged cache's
    pools and recurrent leaves (``(count, ...)``) are updated in place.  A
    cacheless forward that autograd records runs each block under
    ``checkpoint`` unless ``arch.remat == "none"``.  ``mesh`` and
    ``ep_axis`` reach a MoE block's experts (``nn.moe.apply_moe``)."""
    _check_kind(s)
    training = cache is None and torch.is_grad_enabled() and \
        any(leaf.requires_grad for _, leaf in tree_leaves_with_path(params))
    if training:
        if arch.quant.mode == "a2q":
            params = _fake_quant_layers(params, arch.quant, COMPUTE_DTYPES[arch.compute_dtype])
        layers = _unbind_layers(params, s.count)
    for i in range(s.count):
        block = functools.partial(
            _apply_block, arch=arch, s=s, positions=positions,
            cache=_layer(cache, i) if cache is not None else None,
            mla_absorb=mla_absorb, view=view, decode_kernel=decode_kernel,
            int_forward=int_forward, int_chain=int_chain, mesh=mesh, ep_axis=ep_axis,
        )
        if not training:
            x = block(_layer(params, i), x)
        elif arch.remat != "none":
            x = checkpoint(block, layers[i], x, use_reentrant=False)
        else:
            x = block(layers[i], x)
    return x


def init_stack_cache(arch: ArchConfig, s: StackConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device="cuda") -> dict:
    """The contiguous decode cache of one stack on ``device``, every leaf with
    a leading ``count`` axis (the layers' caches, stacked): attention
    layers' ``init_attn_cache`` (a ring for sliding-window / chunk-local
    layers), rwkv6's fp32 state ``tm.S (count, batch, H, Dk, Dk)`` and its
    token-shift carries ``tm.shift``/``cm.shift (count, batch, 1, d)``,
    hymba's ring and its fp32 SSD state ``mamba.S (count, batch, H, Dh,
    N)``.  Each leaf is its own tensor (updated in place), not a broadcast
    view."""
    dev = resolve_device(device)
    if s.kind in ("attn_mlp", "moe", "hymba"):
        one = init_attn_cache(batch, s.attn, max_seq, dtype, device=dev)
        cache = {"attn": {k: torch.stack([v] * s.count) for k, v in one.items()}}
        if s.kind == "hymba":
            cache["mamba"] = init_mamba_state(arch.d_model, s.ssm, s.count, batch, dev)
        return cache
    if s.kind == "rwkv6":
        H, Dk = arch.d_model // s.ssm.head_dim, s.ssm.head_dim

        def shift():
            return torch.zeros((s.count, batch, 1, arch.d_model), dtype=dtype, device=dev)

        return {"tm": {"S": torch.zeros((s.count, batch, H, Dk, Dk), dtype=torch.float32,
                                        device=dev),
                       "shift": shift()},
                "cm": {"shift": shift()}}
    raise NotImplementedError(f"caches for {s.kind!r} stacks are not ported yet (ROADMAP.md "
                              "queue 1)")
