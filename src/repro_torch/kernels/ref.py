"""Plain PyTorch oracles for the port's kernels, twins of ``repro.kernels.ref``.

Each ``ref_*`` function defines the semantics its CUDA kernel must match: bit
for bit for the integer kernel, to float tolerance for attention.  They run on
any device.  Integer products are taken in float64, which is exact here
(``|x @ w| <= K * 2**14 < 2**53`` for any K below 2**39), because PyTorch has
no general integer matmul on CUDA; the accumulator arithmetic then runs in
int64.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.core.bounds import int_range

__all__ = [
    "exact_product",
    "wrap_bits",
    "saturate_bits",
    "ref_int_matmul",
    "ref_int_matmul_fused",
    "ref_int_matmul_prologue",
    "ref_int_matmul_requant",
    "gelu_tanh",
    "ref_a2q_quantize",
    "flash_keep_mask",
    "ref_flash_attention",
    "ref_paged_attention",
    "ref_paged_attention_q8",
    "ref_paged_attention_q4",
    "ref_paged_mla_attention",
    "ref_rwkv6",
]


def wrap_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of integer values into a ``bits``-wide register."""
    if bits >= 64:
        return v
    half = 1 << (bits - 1)
    return torch.remainder(v.to(torch.int64) + half, 1 << bits) - half


def saturate_bits(v: torch.Tensor, bits: int) -> torch.Tensor:
    if bits >= 32:
        return v
    return torch.clamp(v, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def exact_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int64)


def ref_int_matmul(x: torch.Tensor, w: torch.Tensor, acc_bits: int = 32, mode: str = "exact",
                   block_k: Optional[int] = None) -> torch.Tensor:
    """Integer matmul ``(M, K) @ (K, N) -> int32`` with accumulator emulation:
    ``exact`` (int32), ``wrap`` (P-bit two's complement; associative, so one
    wrap of the exact result) or ``saturate`` (P-bit clip after each K-tile
    of ``block_k``, in tile order)."""
    if mode == "exact":
        return wrap_bits(exact_product(x, w), 32).to(torch.int32)
    if mode == "wrap":
        return wrap_bits(exact_product(x, w), min(acc_bits, 32)).to(torch.int32)
    if mode == "saturate":
        K = x.shape[-1]
        bk = block_k or K
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64, device=x.device)
        for lo in range(0, K, bk):
            hi = min(lo + bk, K)
            acc = saturate_bits(acc + exact_product(x[:, lo:hi], w[lo:hi]), acc_bits)
        return wrap_bits(acc, 32).to(torch.int32)
    raise ValueError(f"unknown mode {mode!r}")


def ref_int_matmul_fused(x, w, scale, bias=None, acc_bits: int = 32, mode: str = "exact",
                         block_k: Optional[int] = None, offset=None) -> torch.Tensor:
    """The integer matmul, then ``(acc + offset) * scale (+ bias)`` in fp32:
    one multiply and one add, each rounded, in that order."""
    acc = ref_int_matmul(x, w, acc_bits=acc_bits, mode=mode, block_k=block_k)
    if offset is not None:
        acc = acc + torch.as_tensor(offset, dtype=torch.int32, device=acc.device).reshape(1, -1)
    out = acc.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32, device=acc.device).reshape(1, -1)
    if bias is not None:
        out = out + torch.as_tensor(bias, dtype=torch.float32, device=acc.device).reshape(1, -1)
    return out


def ref_int_matmul_prologue(x, w, aq_scale, scale, bias=None, acc_bits: int = 32,
                            mode: str = "exact", block_k: Optional[int] = None,
                            in_bits: int = 8, in_signed: bool = True) -> torch.Tensor:
    """The quantizing prologue's semantics, spelled out as the unchained path
    computes them on their own: the host act-quant of the fp32 ``x``
    (``clip(round(x / aq_scale))`` to ``in_bits``/``in_signed``, dividing,
    rounding half to even), unsigned 8-bit codes symmetrized to ``q - 128``
    with ``128 * colsum(w)`` added back at flush, then
    ``ref_int_matmul_fused``."""
    lo, hi = int_range(in_bits, in_signed)
    s_aq = torch.as_tensor(aq_scale, dtype=torch.float32, device=x.device)
    codes = torch.clamp(torch.round(x.to(torch.float32) / s_aq), lo, hi)
    offset = None
    if not in_signed and in_bits == 8:
        codes = codes - 128.0
        offset = 128 * w.to(torch.int32).sum(0, dtype=torch.int32)
    return ref_int_matmul_fused(codes.to(torch.int8), w, scale, bias, acc_bits=acc_bits,
                                mode=mode, block_k=block_k, offset=offset)


def ref_int_matmul_requant(x, w, scale, out_scale, bias=None, offset=None, out_bits: int = 8,
                           out_signed: bool = True, act_fn: Optional[str] = None,
                           cast_dtype=torch.float32, acc_bits: int = 32) -> torch.Tensor:
    """The requantizing epilogue's semantics (int8-out chaining): the integer
    matmul, ``(acc + offset) * scale (+ bias)``, the activation replay in
    ``cast_dtype`` (``act_fn`` ``None`` is the bare cast round-trip,
    ``'relu2'`` squares relu in ``cast_dtype``, ``'gelu'`` runs
    :func:`gelu_tanh` in fp32 and casts back), then the consumer's
    act-quant ``clip(round(y / out_scale))`` to ``out_bits``/``out_signed``,
    as int8 codes; unsigned 8-bit codes come out symmetrized (``q - 128``)."""
    y = ref_int_matmul_fused(x, w, scale, bias, acc_bits=acc_bits, offset=offset).to(cast_dtype)
    if act_fn == "relu2":
        y = torch.square(torch.relu(y))
    elif act_fn == "gelu":
        y = gelu_tanh(y.to(torch.float32)).to(cast_dtype)
    elif act_fn is not None:
        raise ValueError(f"unknown chained activation {act_fn!r}")
    lo, hi = int_range(out_bits, out_signed)
    s = torch.as_tensor(out_scale, dtype=torch.float32, device=y.device).reshape(1, -1)
    q = torch.clamp(torch.round(y.to(torch.float32) / s), lo, hi)
    if not out_signed and out_bits == 8:
        q = q - 128.0
    return q.to(torch.int8)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)  # rounded to fp32 where it meets an fp32 tensor


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form, written out op by op in the
    order the reference computes it, each op rounded once in ``x``'s dtype:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))``.  The
    non-gated MLP's host gelu, the requant epilogue's plain replay and the
    CUDA kernel's (``__fmul_rn``/``__fadd_rn`` and ``tanhf``) all follow it,
    so the chained and unchained paths agree wherever ``tanhf`` equals
    ``torch.tanh``.  (``F.gelu(approximate="tanh")`` fuses the ops.)"""
    inner = _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def ref_a2q_quantize(v, t, d, weight_bits: int, acc_bits: int, input_bits: int,
                     input_signed: bool):
    """Fused A2Q weight quantizer on a ``(K, C)`` matrix with per-column
    ``t``/``d`` ``(C,)``: ``q = clip(trunc(2^(min(t, T) - d) * v / ||v||_1),
    n, p)`` with ``T = 1_signed + log2(2^(P-1) - 1) + d - N`` (Eq. 23), and
    the dequantized ``q * 2^d``.  Returns (dequantized fp32, integer weights
    as int32), as ``a2q_int_weights`` computes them."""
    n, p = int_range(weight_bits, True)
    log2_amax = torch.log2(torch.tensor(2.0 ** (acc_bits - 1) - 1.0, dtype=v.dtype,
                                        device=v.device))
    T = int(input_signed) + log2_amax + d - input_bits
    g_over_s = torch.exp2(torch.minimum(t, T) - d)
    s = torch.exp2(d)
    l1 = torch.clamp_min(v.abs().sum(0), 1e-12)
    q = torch.clamp(torch.trunc(g_over_s[None, :] * v / l1[None, :]), n, p)
    return (q * s[None, :]).to(torch.float32), q.to(torch.int32)


def flash_keep_mask(Tq: int, Tk: int, causal: bool, window: Optional[int],
                    device=None) -> torch.Tensor:
    """``(Tq, Tk)`` bool: the keys each query keeps, queries end-aligned to
    the keys (``qpos = i + Tk - Tq``): ``kpos <= qpos`` when ``causal``,
    ``kpos > qpos - window`` with a ``window``."""
    qpos = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def ref_flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax attention oracle over ``(B, H, Tq, Dh)`` queries and
    ``(B, H, Tk, Dh)`` keys/values (KV heads already repeated), fp32 softmax:
    query positions end-aligned (``qpos = i + Tk - Tq``), a key kept iff
    ``kpos <= qpos`` when ``causal`` and ``kpos > qpos - window`` with a
    ``window``.  Out in ``q``'s dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.to(torch.float32) * scale
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, k.to(torch.float32))
    mask = flash_keep_mask(q.shape[-2], k.shape[-2], causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(torch.float32)).to(q.dtype)


def ref_paged_attention(q, kp, vp, bt, lengths, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """Paged-attention decode oracle: gather each row's contiguous K/V view
    through the block table, then dense fp32 softmax over the valid prefix.

    ``q (B, H, Dh)``, pools ``(NB, bs, KV, Dh)``, ``bt (B, MB)``, ``lengths
    (B,)`` counting this step's token.  Rows of length 0 give zeros; a
    ``window`` keeps keys at ``kpos >= length - window``."""
    B, H, Dh = q.shape
    NB, bs, KV, _ = kp.shape
    MB = bt.shape[1]
    G = H // KV
    if scale is None:
        scale = Dh**-0.5
    btl = bt.long()
    k = kp[btl].reshape(B, MB * bs, KV, Dh).to(torch.float32)
    v = vp[btl].reshape(B, MB * bs, KV, Dh).to(torch.float32)
    qg = q.reshape(B, KV, G, Dh).to(torch.float32) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k)
    kpos = torch.arange(MB * bs, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(-1, keepdim=True)
    p = torch.where(denom > 0.0, p / torch.clamp_min(denom, 1e-30), torch.zeros_like(p))
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, H, Dh).to(q.dtype)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 ``(..., D // 2)`` -> sign-extended int32 ``(..., D)``:
    element 2i from the low nibble, 2i+1 from the high, ``(x ^ 8) - 8``."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    out = torch.stack([(lo ^ 8) - 8, (hi ^ 8) - 8], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def ref_paged_attention_q8(q, kp, vp, kps, vps, bt, lengths, scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """int8-pool oracle: dequantize the code pools against their per-slot fp32
    scales ``(NB, bs, KV)`` (``k = k8 * s_k`` in fp32), then the fp32
    gathered-view softmax of ``ref_paged_attention``."""
    kd = kp.to(torch.float32) * kps.to(torch.float32)[..., None]
    vd = vp.to(torch.float32) * vps.to(torch.float32)[..., None]
    return ref_paged_attention(q, kd, vd, bt, lengths, scale=scale, window=window)


def ref_paged_attention_q4(q, kp, vp, kps, vps, bt, lengths, scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Packed-int4-pool oracle: unpack the nibble pairs of the uint8 pools
    ``(NB, bs, KV, Dh // 2)``, sign-extend, rescale against the per-slot
    fp32 scales, then the fp32 gathered-view softmax."""
    kd = _unpack_nibbles(kp).to(torch.float32) * kps.to(torch.float32)[..., None]
    vd = _unpack_nibbles(vp).to(torch.float32) * vps.to(torch.float32)[..., None]
    return ref_paged_attention(q, kd, vd, bt, lengths, scale=scale, window=window)


def ref_paged_mla_attention(q_lat, q_pe, ckvp, kpep, bt, lengths, ckvs=None, kpes=None, *,
                            scale: float, aq_scale=None,
                            act_bits: Optional[int] = None) -> torch.Tensor:
    """MLA absorbed-decode oracle: gather the latent / rope-key pools through
    the block table (dequantizing int8 or packed-int4 codes against their
    per-token scales), optionally replay the activation fake-quant on the
    latent (``clip(round(ckv / aq_scale)) * aq_scale``, dividing, rounding
    half to even), then latent-space scores and PV in fp32:

        s = (q_lat @ ckv^T + q_pe @ kpe^T) * scale
        o_lat = softmax(s) @ ckv                         (B, H, R)

    ``q_lat (B, H, R)``, ``q_pe (B, H, P)``, pools ``(NB, bs, R)`` and
    ``(NB, bs, P)``, ``bt (B, MB)``, ``lengths (B,)`` counting this step's
    token.  Keys are valid iff ``kpos < length``; rows of length 0 give
    zeros."""
    B, H, R = q_lat.shape
    bs = ckvp.shape[1]
    MB = bt.shape[1]
    btl = bt.long()
    ckv = ckvp[btl].reshape(B, MB * bs, ckvp.shape[-1])
    kpe = kpep[btl].reshape(B, MB * bs, kpep.shape[-1])
    if ckvp.dtype == torch.uint8:
        ckv = _unpack_nibbles(ckv)
        kpe = _unpack_nibbles(kpe)
    ckv = ckv.to(torch.float32)
    kpe = kpe.to(torch.float32)
    if ckvs is not None:
        ckv = ckv * ckvs[btl].reshape(B, MB * bs).to(torch.float32)[..., None]
        kpe = kpe * kpes[btl].reshape(B, MB * bs).to(torch.float32)[..., None]
    if act_bits is not None:
        n, p_max = -(1 << (act_bits - 1)), (1 << (act_bits - 1)) - 1
        s_aq = torch.as_tensor(aq_scale, dtype=torch.float32, device=ckv.device)
        ckv = torch.clamp(torch.round(ckv / s_aq), n, p_max) * s_aq
    s = torch.einsum("bhr,bsr->bhs", q_lat.to(torch.float32), ckv)
    s = s + torch.einsum("bhp,bsp->bhs", q_pe.to(torch.float32), kpe)
    s = s * scale
    kpos = torch.arange(MB * bs, device=q_lat.device)[None, :]
    vm = (kpos < lengths.to(torch.int64)[:, None])[:, None, :]
    s = torch.where(vm, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), torch.zeros_like(s))
    denom = p.sum(-1, keepdim=True)
    p = torch.where(denom > 0.0, p / torch.clamp_min(denom, 1e-30), torch.zeros_like(p))
    return torch.einsum("bhs,bsr->bhr", p, ckv)


def ref_rwkv6(r, k, v, w, u, initial_state=None):
    """RWKV-6 (Finch) recurrence, naive scan: r/k/w ``(B, T, Dk)``, v
    ``(B, T, Dv)``, u ``(Dk,)``, state ``(B, Dk, Dv)`` (one head folded into
    the batch).  Per step, in fp32:

        y_t = r_t @ (S + (u * k_t) v_t^T)
        S   = diag(w_t) S + k_t v_t^T

    Returns (y ``(B, T, Dv)`` in ``r``'s dtype, the final fp32 state)."""
    B, T, Dk = r.shape
    Dv = v.shape[-1]
    S = (torch.zeros((B, Dk, Dv), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.to(torch.float32))
    u = u.to(torch.float32)
    ys = []
    for t in range(T):
        r_t, k_t, v_t, w_t = (a[:, t].to(torch.float32) for a in (r, k, v, w))
        kv = k_t[:, :, None] * v_t[:, None, :]
        ys.append(torch.einsum("bk,bkv->bv", r_t, S + u[None, :, None] * kv))
        S = w_t[:, :, None] * S + kv
    y = torch.stack(ys, 1) if ys else torch.zeros((B, 0, Dv), device=r.device)
    return y.to(r.dtype), S
