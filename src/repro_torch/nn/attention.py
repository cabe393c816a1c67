"""Attention layers: GQA (+RoPE, sliding window) and MLA, over contiguous,
ring or paged KV caches.

All projections are quantized linears, so A2Q attaches to q/k/v/o (and the
MLA down/up projections) as to any other matmul.  Ported from
``repro.nn.attention``:

* ``_sdpa`` — scaled dot-product with absolute-position masking (causal,
  sliding window, chunked-local), grouped KV heads and query chunking;
* the contiguous cache (``init_attn_cache``): per layer ``k``/``v`` ``(B,
  S, KV, Dh)`` and the keys' absolute positions ``kpos (B, S)`` (-1 = empty
  slot); ``S = max_seq``, or for a sliding-window / chunk-local layer a
  ring of ``min(window or chunk, max_seq)`` slots written at ``pos % S``
  (what keeps h2o-danube's window-4096 decode at 4096 slots however long
  the context); MLA caches the latent ``ckv (B, S, R)`` and rope key ``kpe
  (B, S, P)``.  ``_write_cache`` writes a ``T``-token update at each row's
  start position in place;
* the paged cache view: pools ``(NB, bs, KV, Dh)`` indexed through a
  per-sequence block table ``view["bt"] (B, MB)``; ``_paged_write``
  scatters (a position past the table into the trash block, where the
  reference drops it), ``_paged_gather`` materialises the contiguous view;
* the decode-kernel dispatch: with ``decode_kernel=True`` the paged
  ``T == 1`` read goes through ``kernels/ops.paged_attention`` instead of the
  gathered-view ``_sdpa``;
* the cacheless GQA step (a whole utterance through hubert's bidirectional
  encoder, a prompt scored without a cache, llava's patches and text)
  goes through ``kernels/ops.flash_attention`` (the reference computes it
  with ``_sdpa``) — unless autograd records the forward (training
  differentiates ``_sdpa``, as the reference's training does: its layers
  never call the Pallas flash kernel, and the flash kernel has no
  backward), or the layer is chunk-local (llama4's local layers): the
  flash kernel's mask is causal and windowed only, as its reference's is
  (``repro.kernels.flash_attention`` leaves chunk-local masks to the layer
  above), so those layers take ``_sdpa`` with the chunk mask.  These
  routes follow the reference's semantics; none is a fallback on a
  failure;
* MLA (deepseek-v3): low-rank compressed q and kv with a shared rope key,
  cached as the latent ``ckvp (NB, bs, kv_lora_rank)`` and rope-key ``kpep
  (NB, bs, qk_rope_dim)`` pools, or in the contiguous ``ckv``/``kpe``
  lanes (never a ring).  The materialized path up-projects the
  latent through ``wkv_b`` and runs ``_sdpa``; the absorbed path
  (``mla_absorb=True``, every cached step) folds ``wkv_b`` into the query and
  the output and attends in latent space, through
  ``kernels/ops.paged_mla_attention`` for a ``T == 1`` decode read with
  ``decode_kernel=True``.

Integer KV pools (GQA ``kp``/``vp`` with per-slot scale pools ``kps``/``vps``
``(NB, bs, KV)``; MLA ``ckvp``/``kpep`` with per-token ``ckvs``/``kpes``
``(NB, bs)``): each written token is quantized on write (``_kv_quantize``,
absmax over the feature dim) to int8 codes, or to int4 codes packed two a
byte into uint8 pools of half the width (``_pack_nibbles``); reads go through
the kernels, which dequantize in registers, or through the dequantized
gathered view (``_paged_gather_deq``).

Every layout shares one ``_sdpa``: keys carry absolute positions, so the
masks (causal, window, chunk, empty slot) read the same for all of them.  A
chunked prefill over a ring attends the ring as it was before the chunk's
writes plus the chunk's own K/V, since a chunk's later tokens overwrite
slots its earlier queries still see.  Ring-layer attention takes ``_sdpa``
in every step, as in the reference (its decode kernel reads paged pools
only).

Writes update the caches in place (the reference returns new arrays); the
returned cache holds the same tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import resolve_device
from repro_torch.configs.base import AttnConfig, QuantConfig
from repro_torch.core.quantizers import apply_act_quant
from repro_torch.dist.sharding import (even_shards, local_as, local_shape_and_offset,
                                       merge_last, split_last)
from repro_torch.kernels.ref import _unpack_nibbles
from repro_torch.nn.embedding import apply_rope
from repro_torch.nn.linear import _quant_weights, apply_linear, init_linear
from repro_torch.nn.norms import apply_norm, init_norm

__all__ = ["init_attention", "apply_attention", "init_attn_cache"]

_NEG = -1e30
TRASH_BLOCK = 0  # the pools' reserved block: dead rows write there, nothing reads it as valid


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
    if isinstance(q, DTensor):  # a sharded forward: each rank's rows and heads
        return _attend_sharded(q, k, v, lambda q_l, k_l, v_l, local_pos: _sdpa(
            q_l, k_l, v_l, local_pos(qpos), local_pos(kpos), causal=causal, window=window,
            chunk=chunk, q_chunk=q_chunk))
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
        s_max = s.amax(dim=-1, keepdim=True).detach()  # the reference's stop_gradient
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


def _init_mla(gen, d_model: int, a: AttnConfig, q: QuantConfig) -> dict:
    qh = a.qk_nope_dim + a.qk_rope_dim
    return {
        "wq_a": init_linear(gen, d_model, a.q_lora_rank, q),
        "q_norm": init_norm(a.q_lora_rank, "rmsnorm", device=gen.device),
        "wq_b": init_linear(gen, a.q_lora_rank, a.heads * qh, q),
        "wkv_a": init_linear(gen, d_model, a.kv_lora_rank + a.qk_rope_dim, q),
        "kv_norm": init_norm(a.kv_lora_rank, "rmsnorm", device=gen.device),
        "wkv_b": init_linear(gen, a.kv_lora_rank, a.heads * (a.qk_nope_dim + a.v_head_dim), q),
        "wo": init_linear(gen, a.heads * a.v_head_dim, d_model, q),
    }


def init_attention(gen: torch.Generator, d_model: int, a: AttnConfig, q: QuantConfig,
                   use_bias: bool = False) -> dict:
    if a.kind == "mla":
        return _init_mla(gen, d_model, a, q)
    return _init_gqa(gen, d_model, a, q, use_bias)


def init_attn_cache(batch: int, a: AttnConfig, max_seq: int, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """The contiguous decode cache of one attention layer on ``device``:
    ``k``/``v`` ``(batch, slots, KV, Dh)`` with ``slots = max_seq``, or a ring
    of ``min(window or chunk, max_seq)`` slots for a sliding-window or
    chunk-local layer; MLA's latent ``ckv (batch, max_seq, R)`` and rope key
    ``kpe (batch, max_seq, P)``; and ``kpos (batch, slots)`` int32, every
    slot -1 (empty)."""
    dev = resolve_device(device)
    if a.kind == "mla":
        lanes = {"ckv": (batch, max_seq, a.kv_lora_rank), "kpe": (batch, max_seq, a.qk_rope_dim)}
        slots = max_seq
    else:
        ring = a.window or a.chunk
        slots = max_seq if ring is None else min(ring, max_seq)
        lanes = {"k": (batch, slots, a.kv_heads, a.head_dim),
                 "v": (batch, slots, a.kv_heads, a.head_dim)}
    cache = {k: torch.zeros(shape, dtype=dtype, device=dev) for k, shape in lanes.items()}
    cache["kpos"] = torch.full((batch, slots), -1, dtype=torch.int32, device=dev)
    return cache


def _write_cache(cache: dict, updates: dict, pos: torch.Tensor, ring: bool) -> dict:
    """Write a ``T``-token update (``updates[name] (B, T, ...)``; decode at
    ``T == 1``, a prefill chunk above) into a contiguous cache in place, at
    each row's start position ``pos`` (``(B,)``, or one for every row), and
    the tokens' absolute positions into ``kpos``.

    A non-ring cache takes the span ``[pos, pos + T)``, its start clamped to
    ``[0, S - T]`` as ``jax.lax.dynamic_update_slice`` clamps it (the
    contiguous engine's per-token prefill feeds every row at its current
    position, freed rows included): no index falls out of range and nothing
    raises.  A ring takes slot ``(pos + t) % S``; a chunk longer than the
    ring (``T > S``) would map tokens ``t`` and ``t + S`` to one slot, so the
    writes a later token of the chunk supersedes are dropped before the
    scatter (duplicate indices of ``index_put_`` land in no defined order)
    and the last ``S`` tokens are written.  The tensors are never rebound:
    a captured CUDA graph reads them at fixed addresses.  A cache of
    DTensors (``dist.sharding.cache_specs``) takes ``_write_cache_sharded``."""
    if isinstance(cache["kpos"], DTensor):
        return _write_cache_sharded(cache, updates, pos, ring)
    B, S = cache["kpos"].shape
    T = next(iter(updates.values())).shape[1]
    dev = cache["kpos"].device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    steps = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    abs_pos = pos[:, None] + steps  # (B, T)
    if ring:
        keep = slice(max(T - S, 0), T)  # the tokens no later one of the chunk supersedes
        abs_pos = abs_pos[:, keep]
        updates = {k: v[:, keep] for k, v in updates.items()}
        idx = abs_pos % S
    else:
        idx = pos.clamp(0, max(S - T, 0))[:, None] + steps
    rows = torch.arange(B, device=dev)[:, None].expand_as(idx)
    idx = idx.long()
    for name, val in updates.items():
        cache[name].index_put_((rows, idx), val.to(cache[name].dtype))
    cache["kpos"].index_put_((rows, idx), abs_pos)
    return cache


def _write_cache_sharded(cache: dict, updates: dict, pos, ring: bool) -> dict:
    """``_write_cache`` into a cache of DTensors (the batch split over
    ``data``, the KV heads over ``model``): each rank writes its own rows and
    heads in place, the update placed as its cache leaf and the positions
    cut to the rank's rows (an index scatter into a sharded dim has no
    DTensor strategy that keeps the placement)."""
    kp = cache["kpos"]
    B = kp.shape[0]
    _, (row0, _) = local_shape_and_offset(kp.shape, kp.device_mesh, kp.placements)
    rows = kp.to_local().shape[0]
    pos = pos.full_tensor() if isinstance(pos, DTensor) else pos
    pos = torch.as_tensor(pos, dtype=torch.int32, device=kp.device).reshape(-1).expand(B)
    local = {k: v.to_local() for k, v in cache.items()}
    ups = {k: v.redistribute(cache[k].device_mesh, cache[k].placements).to_local()
           for k, v in updates.items()}
    _write_cache(local, ups, pos[row0:row0 + rows], ring)
    return cache


def _flash(qh, kh, vh, a: AttnConfig, q_chunk: int):
    """``ops.flash_attention`` over ``(B, T, H, Dh)`` projections; on
    DTensors (a sharded forward) over each rank's local shards."""
    from repro_torch.kernels import ops

    def flash(q, k, v, _):
        return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=a.causal, window=a.window,
                                   q_chunk=q_chunk).transpose(1, 2)

    if isinstance(qh, DTensor):
        return _attend_sharded(qh, kh, vh, flash)
    return flash(qh, kh, vh, None)


def _attend_sharded(qh: DTensor, kh, vh, attend) -> DTensor:
    """Attention of ``(B, T, H, Dh)`` DTensors on each rank's local shards.

    Attention is local to a row and a head: the query keeps its even split
    of the batch (dim 0) and of the heads (dim 2), anything else gathered; K and V
    keep the batch's split, and the heads' where theirs divide as the
    query's do, else each rank cuts the KV heads its query heads read (GQA:
    query head ``h`` reads KV head ``h // (H // KV)``).  A head split that
    does not fall on whole groups is gathered instead.  ``attend(q, k, v,
    local_pos)`` runs on the local tensors (``local_pos`` cuts a ``(B, ...)``
    position tensor to the rank's rows); the output takes the query's
    placement.  Differentiable: the gradients come back through DTensor."""
    mesh = qh.device_mesh
    H, KV = qh.shape[2], kh.shape[2]
    group = H // KV
    qp = even_shards(qh, (0, 2))
    while True:
        kp = []
        for i, p in enumerate(qp):
            split = math.prod(mesh.size(j) for j, o in enumerate(qp[:i + 1]) if o == Shard(2))
            kp.append(p if p == Shard(0) or (p == Shard(2) and KV % split == 0) else Replicate())
        qshape, (row0, _, h0, _) = local_shape_and_offset(qh.shape, mesh, qp)
        _, (_, _, k0, _) = local_shape_and_offset(kh.shape, mesh, kp)
        hl, first = qshape[2], h0 // group
        last = (h0 + hl - 1) // group
        whole_groups = hl <= group and first == last or h0 % group == 0 and hl % group == 0
        if whole_groups or Shard(2) not in qp:
            break
        qp[qp.index(Shard(2))] = Replicate()  # gather the heads that split a group
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in qp]

    def local_pos(pos):
        if isinstance(pos, DTensor):
            return pos.redistribute(mesh, rows).to_local()
        return pos[row0:row0 + qshape[0]]

    # where the query's heads split and K/V's do not, each rank's K/V
    # gradient holds its own heads' part: partial sums over that mesh dim
    kgrad = [Partial() if p == Replicate() and o == Shard(2) else p for p, o in zip(kp, qp)]
    q_l = local_as(qh, mesh, qp)
    k_l, v_l = (local_as(t, mesh, kp, kgrad)[:, :, first - k0:last + 1 - k0] for t in (kh, vh))
    return DTensor.from_local(attend(q_l, k_l, v_l, local_pos), mesh, qp, run_check=False)


def _paged_write(pool: torch.Tensor, val: torch.Tensor, bt: torch.Tensor,
                 abs_pos: torch.Tensor) -> torch.Tensor:
    """Scatter ``val (B, T, ...)`` into ``pool (NB, bs, ...)`` in place: the
    token at absolute position p lands in ``pool[bt[b, p // bs], p % bs]``.
    A position whose block index falls outside the table goes to slot 0 of
    the trash block instead, so every other block ends as the reference's
    ``take_along_axis`` fill + ``mode="drop"`` scatter leaves it, with no
    mask read back to the host (the write is one plain ``index_put_``,
    capturable in a CUDA graph).  No row writes a block another row reads
    (a shared block is copied before any write into it, ``PagedKVCache.
    ensure_writable``), so writes collide only in the trash block, which is
    never read as valid."""
    bs = pool.shape[1]
    MB = bt.shape[1]
    pos = abs_pos.long()
    bidx = pos // bs
    keep = (bidx >= 0) & (bidx < MB)
    blk = torch.gather(bt.long(), 1, bidx.clamp(0, MB - 1))
    blk = torch.where(keep, blk, torch.full_like(blk, TRASH_BLOCK))
    off = torch.where(keep, pos % bs, torch.zeros_like(pos))
    pool.index_put_((blk, off), val.to(pool.dtype))
    return pool


def _kv_quantize(val: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric ``bits``-bit quantization of a K/V update along its feature
    dim: ``val (B, T, ..., D)`` -> (int8 codes in ``[-qmax, qmax]``, fp32
    scales ``(B, T, ...)``), one absmax-calibrated scale per written token
    (per KV head for GQA, per latent row for MLA); dividing, rounding half to
    even, as the reference does."""
    qmax = (1 << (bits - 1)) - 1  # 127 (int8) or 7 (int4)
    vf = val.to(torch.float32)
    amax = vf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, torch.finfo(torch.float32).tiny) / qmax
    codes = torch.clamp(torch.round(vf / scale[..., None]), -qmax, qmax).to(torch.int8)
    return codes, scale


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes ``(..., D)`` (int8 values in [-7, 7]) -> packed uint8
    ``(..., D // 2)``: element 2i in the low nibble, 2i+1 in the high.  The
    nibble is taken through int16 (``& 0xF``), never by casting a negative
    int8 to uint8."""
    u = (codes.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _paged_write_q8(pool: torch.Tensor, scales: torch.Tensor, val: torch.Tensor,
                    bt: torch.Tensor, abs_pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-write into an integer pool and its per-slot scale pool, in
    place.  An int8 pool stores the codes; a uint8 pool is the packed int4
    layout (two codes a byte, half the feature width)."""
    if pool.dtype == torch.uint8:
        codes, s = _kv_quantize(val, bits=4)
        codes = _pack_nibbles(codes)
    else:
        codes, s = _kv_quantize(val, bits=8)
    return _paged_write(pool, codes, bt, abs_pos), _paged_write(scales, s, bt, abs_pos)


def _paged_gather_deq(pool: torch.Tensor, scales: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The gathered contiguous view of an integer pool, dequantized against
    its per-slot scales (fp32); uint8 pools are unpacked first."""
    g = _paged_gather(pool, bt)
    if pool.dtype == torch.uint8:
        g = _unpack_nibbles(g)
    return g.to(torch.float32) * _paged_gather(scales, bt)[..., None]


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
    mla_absorb: bool = False,
    view: Optional[dict] = None,
    decode_kernel: bool = False,
    int_forward: bool = False,
    int_chain: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (output, updated cache).  ``cache`` given => a cached step
    over ``T >= 1`` new tokens (decode or chunked prefill): a contiguous or
    ring cache (``k``/``v``/``kpos``, MLA ``ckv``/``kpe``/``kpos``), or paged
    pools (``kp``/``vp``, or ``ckvp``/``kpep`` for MLA, with scale pools when
    integer) through the block-table ``view``; ``decode_kernel=True`` routes
    a paged ``T == 1`` read through the paged attention kernel (for MLA only
    on the absorbed path, ``mla_absorb``).  ``int_forward`` routes deployed projections through the
    fused W8A8 path; every attention projection is a chain break, so
    ``int_chain`` folds each act-quant into the kernel's prologue."""
    if a.kind == "mla":
        return _apply_mla(params, x, a, q, positions, cache, q_chunk=q_chunk,
                          compute_dtype=compute_dtype, absorb=mla_absorb, view=view,
                          decode_kernel=decode_kernel, int_forward=int_forward,
                          int_chain=int_chain)
    B, T, D = x.shape
    H, KV, Dh = a.heads, a.kv_heads, a.head_dim
    lin = functools.partial(apply_linear, cfg=q, compute_dtype=compute_dtype,
                            int_forward=int_forward, int_chain=int_chain)
    qh = split_last(lin(params["wq"], x=x, site="attn.wq"), H, Dh)
    kh = split_last(lin(params["wk"], x=x, site="attn.wk"), KV, Dh)
    vh = split_last(lin(params["wv"], x=x, site="attn.wv"), KV, Dh)
    if a.rope_theta is not None:
        qh = apply_rope(qh, positions, a.rope_theta)
        kh = apply_rope(kh, positions, a.rope_theta)

    if cache is None and (a.chunk is not None or torch.is_grad_enabled() and
                          (qh.requires_grad or kh.requires_grad or vh.requires_grad)):
        # training: the reference differentiates its own _sdpa, and flash has
        # no backward; a chunk-local layer: flash masks no chunks
        out = _sdpa(qh, kh, vh, positions, positions, causal=a.causal, window=a.window,
                    chunk=a.chunk, q_chunk=q_chunk)
        new_cache = None
    elif cache is None:
        out = _flash(qh, kh, vh, a, q_chunk)
        new_cache = None
    elif "kp" in cache:
        if view is None:
            raise ValueError("paged attention cache needs a block-table view")
        bt = view["bt"]
        quant = "kps" in cache  # integer pools carry per-slot scale pools
        if quant:
            kp_new, kps_new = _paged_write_q8(cache["kp"], cache["kps"], kh, bt, positions)
            vp_new, vps_new = _paged_write_q8(cache["vp"], cache["vps"], vh, bt, positions)
            new_cache = {"kp": kp_new, "kps": kps_new, "vp": vp_new, "vps": vps_new}
        else:
            new_cache = {
                "kp": _paged_write(cache["kp"], kh, bt, positions),
                "vp": _paged_write(cache["vp"], vh, bt, positions),
            }
        if decode_kernel and T == 1 and a.causal and a.chunk is None:
            from repro_torch.kernels import ops

            out = ops.paged_attention(
                qh[:, 0], new_cache["kp"], new_cache["vp"], bt, positions[:, 0] + 1,
                kps=new_cache.get("kps"), vps=new_cache.get("vps"), window=a.window,
            )[:, None]
        else:
            if quant:
                k_all = _paged_gather_deq(new_cache["kp"], new_cache["kps"], bt)
                v_all = _paged_gather_deq(new_cache["vp"], new_cache["vps"], bt)
            else:
                k_all = _paged_gather(new_cache["kp"], bt)
                v_all = _paged_gather(new_cache["vp"], bt)
            kpos = _paged_kpos(positions, k_all.shape[1])
            out = _sdpa(qh, k_all, v_all, positions, kpos,
                        causal=a.causal, window=a.window, chunk=a.chunk, q_chunk=q_chunk)
    else:
        ring = (a.window or a.chunk) is not None
        snapshot = ring and T > 1
        if snapshot:
            # a chunked prefill over a ring: the chunk's writes overwrite
            # slots its early queries still need, so attend the ring as it
            # was before them (copied before the in-place write) plus the
            # chunk's fresh K/V; the absolute positions mask stale and
            # out-of-window entries, and the ring's positions, all below the
            # chunk's, never collide with them
            k_all = torch.cat([cache["k"], kh.to(cache["k"].dtype)], dim=1)
            v_all = torch.cat([cache["v"], vh.to(cache["v"].dtype)], dim=1)
            kpos = torch.cat([cache["kpos"], positions], dim=1)
        new_cache = _write_cache(cache, {"k": kh, "v": vh}, positions[:, 0], ring)
        if not snapshot:
            k_all, v_all, kpos = new_cache["k"], new_cache["v"], new_cache["kpos"]
        out = _sdpa(qh, k_all, v_all, positions, kpos,
                    causal=a.causal, window=a.window, chunk=a.chunk, q_chunk=q_chunk)
    out = merge_last(out, H * Dh)
    return lin(params["wo"], x=out, site="attn.wo"), new_cache


def _apply_mla(
    params: dict,
    x: torch.Tensor,
    a: AttnConfig,
    q: QuantConfig,
    positions: torch.Tensor,
    cache: Optional[dict],
    *,
    q_chunk: int,
    compute_dtype,
    absorb: bool,
    view: Optional[dict] = None,
    decode_kernel: bool = False,
    int_forward: bool = False,
    int_chain: bool = False,
) -> tuple[torch.Tensor, Optional[dict]]:
    B, T, D = x.shape
    H = a.heads
    nope, rope, vd = a.qk_nope_dim, a.qk_rope_dim, a.v_head_dim
    theta = a.rope_theta or 10000.0
    # every MLA projection is a chain break (norms, rope, reshapes and the
    # attention core sit between each producer and consumer)
    lin = functools.partial(apply_linear, cfg=q, compute_dtype=compute_dtype,
                            int_forward=int_forward, int_chain=int_chain)

    cq = apply_norm(params["q_norm"], lin(params["wq_a"], x=x, site="mla.wq_a"))
    qh = split_last(lin(params["wq_b"], x=cq, site="mla.wq_b"), H, nope + rope)
    q_nope, q_pe = qh[..., :nope], apply_rope(qh[..., nope:], positions, theta)

    kv_a = lin(params["wkv_a"], x=x, site="mla.wkv_a")
    ckv = apply_norm(params["kv_norm"], kv_a[..., : a.kv_lora_rank])
    kpe = apply_rope(kv_a[..., a.kv_lora_rank:].reshape(B, T, 1, rope), positions,
                     theta).reshape(B, T, rope)

    # the absorbed single-token decode over a paged latent cache reads the
    # pools through the kernel: the gathered (B, S, R) view is never built
    use_kernel = decode_kernel and absorb and T == 1 and a.causal and \
        cache is not None and "ckvp" in cache
    if cache is None:
        ckv_all, kpe_all, kpos = ckv, kpe, positions
    elif "ckvp" in cache:
        if view is None:
            raise ValueError("paged MLA cache needs a block-table view")
        bt = view["bt"]
        if "ckvs" in cache:  # integer latent pools, per-token fp32 scales
            ckvp_new, ckvs_new = _paged_write_q8(cache["ckvp"], cache["ckvs"], ckv, bt, positions)
            kpep_new, kpes_new = _paged_write_q8(cache["kpep"], cache["kpes"], kpe, bt, positions)
            cache = {"ckvp": ckvp_new, "ckvs": ckvs_new, "kpep": kpep_new, "kpes": kpes_new}
            if not use_kernel:
                ckv_all = _paged_gather_deq(cache["ckvp"], cache["ckvs"], bt)
                kpe_all = _paged_gather_deq(cache["kpep"], cache["kpes"], bt)
        else:
            cache = {"ckvp": _paged_write(cache["ckvp"], ckv, bt, positions),
                     "kpep": _paged_write(cache["kpep"], kpe, bt, positions)}
            if not use_kernel:
                ckv_all = _paged_gather(cache["ckvp"], bt)
                kpe_all = _paged_gather(cache["kpep"], bt)
        if not use_kernel:
            kpos = _paged_kpos(positions, ckv_all.shape[1])
    else:
        cache = _write_cache(cache, {"ckv": ckv, "kpe": kpe}, positions[:, 0], ring=False)
        ckv_all, kpe_all, kpos = cache["ckv"], cache["kpe"], cache["kpos"]

    wkv_b = params["wkv_b"]
    if absorb and cache is not None:
        # fold wkv_b into the query and the output: scores are taken against
        # the latent itself, with the up-projection's activation quantizer
        # replayed on the latent as lin(wkv_b, .) would apply it
        w_full = _mla_up_matrix(wkv_b, a, q)  # (kv_lora, H, nope + vd)
        has_aq = q.mode != "none" and "aq" in wkv_b
        w_k, w_v = w_full[..., :nope], w_full[..., nope:]
        q_lat = torch.einsum("bthn,lhn->bthl", q_nope.to(torch.float32),
                             w_k.to(torch.float32))
        scale = (nope + rope) ** -0.5
        if use_kernel:
            from repro_torch.kernels import ops

            aq_scale = None
            if has_aq:
                aq_scale = torch.exp2(wkv_b["aq"]["log2_scale"].to(torch.float32))
            o_lat = ops.paged_mla_attention(
                q_lat[:, 0], q_pe[:, 0].to(torch.float32), cache["ckvp"], cache["kpep"],
                view["bt"], positions[:, 0] + 1, ckvs=cache.get("ckvs"),
                kpes=cache.get("kpes"), scale=scale, aq_scale=aq_scale,
                act_bits=q.act_bits if aq_scale is not None else None,
            )[:, None]
        else:
            if has_aq:
                ckv_all = apply_act_quant({"log2_scale": wkv_b["aq"]["log2_scale"]}, ckv_all,
                                          q.act_bits, signed=True)
            ckv_f = ckv_all.to(torch.float32)
            s = torch.einsum("bthl,bsl->bths", q_lat, ckv_f)
            s = s + torch.einsum("bthr,bsr->bths", q_pe.to(torch.float32),
                                 kpe_all.to(torch.float32))
            s = s * scale
            kp = kpos[:, None, :]
            mask = ((kp >= 0) & (kp <= positions[:, :, None]))[:, :, None, :]
            s = torch.where(mask, s, torch.full_like(s, _NEG))
            o_lat = torch.einsum("bths,bsl->bthl", torch.softmax(s, dim=-1), ckv_f)
        out = torch.einsum("bthl,lhv->bthv", o_lat, w_v.to(torch.float32))
        out = merge_last(out.to(compute_dtype), H * vd)
        return lin(params["wo"], x=out, site="mla.wo"), cache

    # materialized path: expand per-head K/V from the latent
    S = ckv_all.shape[1]
    kv = split_last(lin(wkv_b, x=ckv_all, site="mla.wkv_b"), H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, kpe_all[:, :, None, :].expand(B, S, H, rope).to(k_nope.dtype)],
                  dim=-1)
    qfull = torch.cat([q_nope, q_pe], dim=-1)
    out = _sdpa(qfull, k, v, positions, kpos, causal=a.causal, window=None, chunk=None,
                q_chunk=q_chunk)
    out = merge_last(out, H * vd)
    return lin(params["wo"], x=out, site="mla.wo"), cache


def _mla_up_matrix(wkv_b_params: dict, a: AttnConfig, q: QuantConfig) -> torch.Tensor:
    """The quantized view of the up-projection, ``(kv_lora, H, nope + vd)``."""
    w = _quant_weights(wkv_b_params, q, boundary=False, input_signed=True)
    return w.reshape(w.shape[0], a.heads, a.qk_nope_dim + a.v_head_dim)
