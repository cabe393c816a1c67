"""GQA attention with RoPE over paged KV caches.

All projections are quantized linears, so A2Q attaches to q/k/v/o as to any
other matmul.  Ported from ``repro.nn.attention`` for the GQA branch:

* ``_sdpa`` — scaled dot-product with absolute-position masking (causal,
  sliding window, chunked-local), grouped KV heads and query chunking;
* the paged cache view: pools ``(NB, bs, KV, Dh)`` indexed through a
  per-sequence block table ``view["bt"] (B, MB)``; ``_paged_write``
  scatters, ``_paged_gather`` materialises the contiguous view;
* the decode-kernel dispatch: with ``decode_kernel=True`` the paged
  ``T == 1`` read goes through ``kernels/ops.paged_attention`` instead of the
  gathered-view ``_sdpa``.

Writes update the pools in place (the reference returns new arrays); the
returned cache holds the same tensors.  MLA, contiguous and ring caches, and
int8/int4 pools are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import AttnConfig, QuantConfig
from repro_torch.nn.embedding import apply_rope
from repro_torch.nn.linear import apply_linear, init_linear

__all__ = ["init_attention", "apply_attention"]

_NEG = -1e30


def _sdpa(
    q: torch.Tensor,  # (B, T, H, Dh)
    k: torch.Tensor,  # (B, S, KV, Dh)
    v: torch.Tensor,  # (B, S, KV, Dv)
    qpos: torch.Tensor,  # (B, T) absolute positions
    kpos: torch.Tensor,  # (B, S) absolute positions, -1 = empty slot
    *,
    causal: bool,
    window: Optional[int],
    chunk: Optional[int],
    q_chunk: int,
) -> torch.Tensor:
    B, T, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    scale = Dh**-0.5
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    def block(q_c: torch.Tensor, qpos_c: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("btkgd,bskd->btkgs", q_c.to(torch.float32) * scale, kf)
        qp = qpos_c[:, :, None]
        kp = kpos[:, None, :]
        mask = kp >= 0
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        if chunk is not None:
            mask = mask & ((kp // chunk) == (qp // chunk))
        m4 = mask[:, :, None, None, :]
        s = torch.where(m4, s, torch.full_like(s, _NEG))
        s_max = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - s_max)
        p = torch.where(m4, p, torch.zeros_like(p))
        denom = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        return torch.einsum("btkgs,bskd->btkgd", p / denom, vf)

    qg = q.reshape(B, T, KV, G, Dh)
    # query chunks bound the live score buffer; each query row is independent
    out = torch.cat([block(qc, pc) for qc, pc in zip(qg.split(q_chunk, dim=1),
                                                     qpos.split(q_chunk, dim=1))], dim=1)
    return out.reshape(B, T, H, Dv).to(q.dtype)


def _init_gqa(gen, d_model: int, a: AttnConfig, q: QuantConfig, use_bias: bool) -> dict:
    HD, KD = a.heads * a.head_dim, a.kv_heads * a.head_dim
    return {
        "wq": init_linear(gen, d_model, HD, q, use_bias=use_bias),
        "wk": init_linear(gen, d_model, KD, q, use_bias=use_bias),
        "wv": init_linear(gen, d_model, KD, q, use_bias=use_bias),
        "wo": init_linear(gen, HD, d_model, q, use_bias=use_bias),
    }


def init_attention(gen: torch.Generator, d_model: int, a: AttnConfig, q: QuantConfig,
                   use_bias: bool = False) -> dict:
    if a.kind != "gqa":
        raise NotImplementedError(f"attention kind {a.kind!r} is not ported yet")
    return _init_gqa(gen, d_model, a, q, use_bias)


def _paged_write(pool: torch.Tensor, val: torch.Tensor, bt: torch.Tensor,
                 abs_pos: torch.Tensor) -> torch.Tensor:
    """Scatter ``val (B, T, ...)`` into ``pool (NB, bs, ...)`` in place: the
    token at absolute position p lands in ``pool[bt[b, p // bs], p % bs]``.
    A position whose block index falls outside the table is dropped, as the
    reference's ``take_along_axis`` fill + ``mode="drop"`` scatter drops it.
    Rows never share live blocks, so writes collide only in the trash block
    that dead slots point at."""
    bs = pool.shape[1]
    MB = bt.shape[1]
    bidx = abs_pos.long() // bs
    keep = (bidx >= 0) & (bidx < MB)
    blk = torch.gather(bt.long(), 1, bidx.clamp(0, MB - 1))
    pool[blk[keep], (abs_pos.long() % bs)[keep]] = val.to(pool.dtype)[keep]
    return pool


def _paged_gather(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The per-row contiguous view ``(B, MB * bs, ...)`` of a pool through the
    block table (the allocator hands out a sequence's blocks in logical
    order, so row b is the contiguous cache lane)."""
    B, MB = bt.shape
    g = pool[bt.long()]  # (B, MB, bs, ...)
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:])


def _paged_kpos(positions: torch.Tensor, S: int) -> torch.Tensor:
    """Absolute key positions of the gathered view: ``[0, len)`` valid, -1
    beyond, where ``len`` is each row's position after this call's write."""
    new_len = positions[:, -1] + 1
    ar = torch.arange(S, dtype=positions.dtype, device=positions.device)[None, :]
    return torch.where(ar < new_len[:, None], ar, torch.full_like(ar, -1))


def apply_attention(
    params: dict,
    x: torch.Tensor,
    a: AttnConfig,
    q: QuantConfig,
    positions: torch.Tensor,  # (B, T) absolute
    cache: Optional[dict] = None,
    *,
    q_chunk: int = 256,
    compute_dtype=torch.bfloat16,
    view: Optional[dict] = None,
    decode_kernel: bool = False,
    int_forward: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (output, updated cache).  ``cache`` given => a paged step over
    ``T >= 1`` new tokens (decode or chunked prefill) through the block-table
    ``view``; ``decode_kernel=True`` routes the ``T == 1`` read through the
    paged-attention kernel.  ``int_forward`` routes deployed projections
    through the fused W8A8 path."""
    if a.kind != "gqa":
        raise NotImplementedError(f"attention kind {a.kind!r} is not ported yet")
    B, T, D = x.shape
    H, KV, Dh = a.heads, a.kv_heads, a.head_dim
    lin = functools.partial(apply_linear, cfg=q, compute_dtype=compute_dtype,
                            int_forward=int_forward)
    qh = lin(params["wq"], x=x, site="attn.wq").reshape(B, T, H, Dh)
    kh = lin(params["wk"], x=x, site="attn.wk").reshape(B, T, KV, Dh)
    vh = lin(params["wv"], x=x, site="attn.wv").reshape(B, T, KV, Dh)
    if a.rope_theta is not None:
        qh = apply_rope(qh, positions, a.rope_theta)
        kh = apply_rope(kh, positions, a.rope_theta)

    if cache is None:
        out = _sdpa(qh, kh, vh, positions, positions,
                    causal=a.causal, window=a.window, chunk=a.chunk, q_chunk=q_chunk)
        new_cache = None
    elif "kp" in cache:
        if view is None:
            raise ValueError("paged attention cache needs a block-table view")
        if "kps" in cache:
            raise NotImplementedError("int8/int4 KV pools are not ported yet")
        bt = view["bt"]
        new_cache = {
            "kp": _paged_write(cache["kp"], kh, bt, positions),
            "vp": _paged_write(cache["vp"], vh, bt, positions),
        }
        if decode_kernel and T == 1 and a.causal and a.chunk is None:
            from repro_torch.kernels import ops

            out = ops.paged_attention(
                qh[:, 0], new_cache["kp"], new_cache["vp"], bt, positions[:, 0] + 1,
                window=a.window,
            )[:, None]
        else:
            k_all = _paged_gather(new_cache["kp"], bt)
            v_all = _paged_gather(new_cache["vp"], bt)
            kpos = _paged_kpos(positions, k_all.shape[1])
            out = _sdpa(qh, k_all, v_all, positions, kpos,
                        causal=a.causal, window=a.window, chunk=a.chunk, q_chunk=q_chunk)
    else:
        raise NotImplementedError("contiguous and ring KV caches are not ported yet")
    out = out.reshape(B, T, H * Dh)
    return lin(params["wo"], x=out, site="attn.wo"), new_cache

