"""Blocks and layer stacks.

A model is a sequence of *stacks*; each stack is ``count`` identical blocks
whose parameters are stacked along a leading ``count`` axis, as in
``repro.nn.transformer`` (which scans them); here a Python loop applies
them in order.  Ported block kinds: ``attn_mlp`` (pre-norm GQA or MLA + gated
or plain MLP, optionally command-r's parallel attention+FFN), ``moe`` (the
same attention + the mixture-of-experts FFN) and ``rwkv6`` (pre-norm RWKV-6
time-mix + channel-mix, attention-free); ``hymba`` and ``conv`` raise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, QuantConfig, StackConfig
from repro_torch.nn.attention import apply_attention, init_attention
from repro_torch.kernels.ref import gelu_tanh
from repro_torch.nn.linear import IntAct, apply_linear, chain_out_aq, init_linear
from repro_torch.nn.moe import apply_moe, init_moe
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.nn.ssm import (
    apply_rwkv6_channelmix,
    apply_rwkv6_timemix,
    init_rwkv6_channelmix,
    init_rwkv6_timemix,
)

__all__ = ["init_stack", "apply_stack", "COMPUTE_DTYPES"]

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
    if s.kind not in ("attn_mlp", "moe", "rwkv6"):
        raise NotImplementedError(f"block kind {s.kind!r} is not ported yet")


def _init_block(gen, arch: ArchConfig, s: StackConfig) -> dict:
    _check_kind(s)
    d, q = arch.d_model, arch.quant
    if s.kind == "rwkv6":
        return {"ln1": init_norm(d, arch.norm, device=gen.device),
                "tm": init_rwkv6_timemix(gen, d, s.ssm, q),
                "ln2": init_norm(d, arch.norm, device=gen.device),
                "cm": init_rwkv6_channelmix(gen, d, s.d_ff, q)}
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
                 int_chain: bool = False):
    q = arch.quant
    cd = COMPUTE_DTYPES[arch.compute_dtype]
    norm = functools.partial(apply_norm, kind=arch.norm, eps=arch.norm_eps)

    if s.kind == "rwkv6":  # the recurrent leaves of a cache are updated in place
        kw = dict(compute_dtype=cd, int_forward=int_forward, int_chain=int_chain)
        y, _ = apply_rwkv6_timemix(p["tm"], norm(p["ln1"], x), s.ssm, q,
                                   (cache or {}).get("tm"), **kw)
        x = x + y
        y, _ = apply_rwkv6_channelmix(p["cm"], norm(p["ln2"], x), q, (cache or {}).get("cm"), **kw)
        return x + y

    def ffn(h):
        if s.kind == "moe":
            return apply_moe(p["moe"], h, s.moe, q, compute_dtype=cd, int_forward=int_forward,
                             int_chain=int_chain)
        return _apply_mlp(p["mlp"], h, q, cd, int_forward, int_chain)

    h = norm(p["ln1"], x)
    attn_out, _ = apply_attention(  # a paged cache is written in place
        p["attn"], h, s.attn, q, positions, (cache or {}).get("attn"),
        q_chunk=arch.attn_q_chunk, compute_dtype=cd, mla_absorb=mla_absorb, view=view,
        decode_kernel=decode_kernel, int_forward=int_forward, int_chain=int_chain,
    )
    if s.parallel_block:
        return x + attn_out + ffn(h)
    x = x + attn_out
    return x + ffn(norm(p["ln2"], x))


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``(count, ...)`` leaves (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


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
                int_chain: bool = False):
    """Apply ``s.count`` blocks in order and return ``x``; a paged cache's
    pools and recurrent leaves (``(count, ...)``) are updated in place."""
    _check_kind(s)
    for i in range(s.count):
        x = _apply_block(
            _layer(params, i), x, arch, s, positions,
            _layer(cache, i) if cache is not None else None,
            mla_absorb=mla_absorb, view=view, decode_kernel=decode_kernel,
            int_forward=int_forward, int_chain=int_chain,
        )
    return x
