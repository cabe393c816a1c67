"""Public wrappers around the port's kernels.

Each op checks its arguments, derives the reference tile schedule, and runs
the CUDA kernel for CUDA tensors or the plain PyTorch version for CPU
tensors.  There is no fallback: a CUDA call launches its kernel or raises.
Layers call these, never a kernel module directly; each op has an oracle in
``ref.py`` that the tests hold it against.

On fake tensors (``FakeTensorMode``: the dry-run's allocation-free trace of
a step) an op launches nothing: it returns empty outputs of the kernel's
shapes and dtypes and records the kernel's operations and bytes with the
active cost trace (``roofline.cost.record_kernel``), the counts
``chip_smoke.py``'s ``bound_ms`` uses for that kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.a2q import _effective_gs
from repro_torch.core.bounds import int_range
from repro_torch.kernels.a2q_quantize import a2q_quantize_cuda, a2q_quantize_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
from repro_torch.kernels.paged_mla_attention import (
    paged_mla_attention_cuda,
    paged_mla_attention_plain,
)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda, rwkv6_scan_plain

__all__ = ["int_matmul", "a2q_quantize", "flash_attention", "paged_attention",
           "paged_mla_attention", "rwkv6_scan", "int_matmul_block_k", "symmetrization_offset",
           "launch_counts", "set_launch_counts"]

# the CUDA wrappers, each counting its launches in ``<wrapper>.*launches``
_WRAPPERS = {fn.__name__: fn for fn in (int_matmul_cuda, paged_attention_cuda,
                                        paged_mla_attention_cuda, rwkv6_scan_cuda,
                                        a2q_quantize_cuda, flash_attention_cuda)}


def launch_counts() -> dict:
    """Every launch counter of the CUDA wrappers, ``{"int_matmul_cuda.launches":
    n, "int_matmul_cuda.tc_launches": n, ...}``.  A wrapper counts when its
    Python code runs, so a launch captured into a CUDA graph counts at
    capture and never at a replay: whoever replays a graph adds the
    capture's increase itself (``set_launch_counts``)."""
    return {f"{name}.{k}": v for name, fn in _WRAPPERS.items() for k, v in vars(fn).items()
            if k.endswith("launches")}


def set_launch_counts(counts: dict) -> None:
    """Set the counters named in ``counts`` (keys as ``launch_counts``)."""
    for key, n in counts.items():
        name, attr = key.split(".")
        setattr(_WRAPPERS[name], attr, n)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int_matmul_block_k(K: int, block_k: int = 512) -> int:
    """The reference's K-tile for a ``K``-deep product (``repro.kernels.ops``
    pads K to ``min(block_k, round_up(K, 128))`` multiples): the boundaries
    at which ``saturate`` clips and the int16 carry is stored."""
    return min(block_k, _round_up(max(K, 1), 128))


_COLSUMS = WeakIdKeyDictionary()  # base weight -> {(offset, shape, stride): (_version, sums)}


def symmetrization_offset(w: torch.Tensor) -> torch.Tensor:
    """``128 * colsum(w)`` as int32 ``(N,)``: what the flush adds back for
    symmetrized unsigned 8-bit codes.  Computed once per weight and kept
    beside it, held weakly on the tensor that owns the weight's storage (a
    layer's weight is a new view of its stack on every call, the stack is
    not), so no leaf joins the parameter tree; computed again when the
    weight was changed in place (``_version``, which a view shares with its
    base, moved).  An inference tensor keeps no version, so its sum is not
    kept."""
    if w.is_inference():
        return 128 * w.sum(0, dtype=torch.int32)
    base = w if w._base is None else w._base
    kept = _COLSUMS.setdefault(base, {})
    key = (w.storage_offset(), tuple(w.shape), w.stride())
    hit = kept.get(key)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    sym = 128 * w.sum(0, dtype=torch.int32)
    kept[key] = (w._version, sym)
    return sym


def _vec(v, n: int, dtype, device) -> torch.Tensor:
    """A scalar or ``(n,)`` epilogue operand as a contiguous ``(n,)`` tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).broadcast_to((n,)).contiguous()


def _fake(t) -> bool:
    return isinstance(t, FakeTensor)


def _fake_cost(name: str, ops: float, tensors: tuple, outs: tuple, pool_bytes: int = 0) -> None:
    """A kernel's cost on fake tensors: its operations, and each input read
    and each output written once (a paged kernel's pools: ``pool_bytes``,
    the rows it reads)."""
    from repro_torch.roofline.cost import record_kernel

    n_bytes = sum(t.numel() * t.element_size() for t in tensors + outs
                  if isinstance(t, torch.Tensor))
    record_kernel(name, float(ops), float(n_bytes + pool_bytes))


def _causal_pairs(tq: int, tk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs a flash call keeps: queries end-aligned to the
    keys, the causal and sliding-window masks."""
    if not causal and window is None:
        return tq * tk
    last = np.arange(tq) + (tk - tq)  # each query's own key position
    hi = np.minimum(last + 1, tk) if causal else np.full(tq, tk)
    lo = np.maximum(last + 1 - window, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def _refuse_operands(op: str, *tensors) -> None:
    """The kernels have no backward: a CUDA launch returns a tensor with no
    ``grad_fn``, so a layer reached through one would silently drop its
    gradient (and the plain version, which autograd could differentiate,
    would hide that on the CPU).  So every op refuses, on every device, an
    input that autograd is recording.  Nor does a kernel know a DTensor: it
    would read one rank's shard as the whole operand, so every op refuses a
    DTensor too (gather it with ``full_tensor()`` first)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{op}: an operand is a DTensor, and the kernel reads one rank's "
                        "shard as the whole tensor; pass full_tensor() or to_local()")
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{op}: the kernel has no backward, and an input requires grad; "
                           "run it under torch.no_grad() or on detached tensors (the "
                           "training forward takes the differentiable route instead)")


def int_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    acc_bits: int = 32,
    mode: str = "exact",
    scale=None,
    bias=None,
    offset=None,
    out_scale=None,
    aq_scale=None,
    in_bits: int = 8,
    in_signed: bool = True,
    out_bits: int = 8,
    out_signed: bool = True,
    act_fn: Optional[str] = None,
    cast_dtype=torch.float32,
    block_k: int = 512,
    spill_int16: bool = False,
) -> torch.Tensor:
    """int8 x int8 -> int32 matmul ``(M, K) @ (K, N)`` with P-bit accumulator
    emulation (``exact`` / ``wrap`` / ``saturate`` per K-tile of
    ``min(block_k, round_up(K, 128))``, as ``repro.kernels.ops.int_matmul``
    tiles it; zero padding to those tiles changes no result, so none is
    materialised).

    ``scale`` (scalar or ``(N,)`` fp32) engages the fused epilogue and the op
    returns fp32 ``acc * scale (+ bias)``; without it the raw int32
    accumulator.  ``in_signed=False, in_bits=8`` declares symmetrized
    unsigned codes (``true_code - 128``): the flush adds ``128 * colsum(w)``.
    ``spill_int16`` stores the carry as int16 between K-tiles, sound only
    for ``acc_bits <= 16`` (the A2Q bound).

    ``aq_scale`` (one fp32 value) engages the quantizing prologue: ``x``
    arrives fp32 or bf16 (widened to fp32 exactly) and is quantized to
    ``in_bits``/``in_signed`` codes (``clip(round(x / aq_scale))``, unsigned
    8-bit symmetrized) on the card, bit for bit the standalone
    ``act_quant_int``'s codes of the fp32 values.

    ``out_scale`` (scalar or ``(N,)`` fp32, the next layer's activation
    scale; needs ``scale`` and ``mode="exact"``) engages the requantizing
    epilogue: the rescaled accumulator is cast to ``cast_dtype`` (fp32 or
    bf16), ``act_fn`` (``None``, ``"relu2"`` or ``"gelu"``) is replayed as
    the layer code computes it, and the result is quantized to
    ``out_bits``/``out_signed`` codes (``clip(round(y / out_scale))``) in the
    same flush; the op returns int8, unsigned 8-bit targets symmetrized
    (``q - 128``).  Oracle: ``ref.ref_int_matmul_requant``."""
    _refuse_operands("int_matmul", x, w, scale, bias, offset, out_scale, aq_scale)
    if mode not in ("exact", "wrap", "saturate"):
        raise ValueError(f"unknown mode {mode!r}")
    if spill_int16 and acc_bits > 16:
        raise ValueError("int16 partial-sum spill is only sound when acc_bits <= 16 (A2Q bound)")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} do not chain")
    x_dtypes = (torch.int8,) if aq_scale is None else (torch.float32, torch.bfloat16)
    if x.dtype not in x_dtypes or w.dtype != torch.int8:
        raise ValueError(f"int_matmul: {' or '.join(map(str, x_dtypes))} x and int8 w expected, "
                         f"got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"int_matmul: x on {x.device}, w on {w.device}")
    if bias is not None and scale is None:
        raise ValueError("int_matmul: bias requires an epilogue scale")
    if aq_scale is not None and scale is None:
        raise ValueError("int_matmul: aq_scale requires an epilogue scale")
    if out_scale is not None:
        if scale is None:
            raise ValueError("int_matmul: out_scale requires an epilogue scale")
        if mode != "exact":
            raise ValueError("int_matmul: the requant epilogue needs mode='exact'")
        if act_fn not in (None, "relu2", "gelu"):
            raise ValueError(f"unknown chained activation {act_fn!r}")
        if cast_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"int_matmul: the requant replay runs in fp32 or bf16, not "
                             f"{cast_dtype}")
    K, N = w.shape
    dev = x.device
    if not in_signed and in_bits == 8:
        # symmetrized unsigned operand: acc_true = acc_sym + 128 * colsum(w)
        sym = symmetrization_offset(w)
        offset = sym if offset is None else _vec(offset, N, torch.int32, dev) + sym
    if offset is not None and scale is None:
        raise ValueError("int_matmul: offset requires an epilogue scale")
    if scale is not None:
        scale = _vec(scale, N, torch.float32, dev)
    if bias is not None:
        bias = _vec(bias, N, torch.float32, dev)
    if offset is not None:
        offset = _vec(offset, N, torch.int32, dev)
    kw = dict(acc_bits=acc_bits, mode=mode, block_k=int_matmul_block_k(K, block_k),
              spill_int16=spill_int16)
    if aq_scale is not None:
        aq_scale = torch.as_tensor(aq_scale, dtype=torch.float32, device=dev)
        if aq_scale.numel() != 1:
            raise ValueError("int_matmul: aq_scale must be one fp32 value")
        lo, hi = int_range(in_bits, in_signed)
        shift = 128 if not in_signed and in_bits == 8 else 0
        if not -128 <= lo - shift <= hi - shift <= 127:
            raise ValueError(f"int_matmul: {in_bits}-bit {'signed' if in_signed else 'unsigned'} "
                             "prologue codes do not fit the int8 operand")
        kw.update(aq_scale=aq_scale.reshape(1).contiguous(), q_lo=lo, q_hi=hi, q_shift=shift)
    if out_scale is not None:
        lo, hi = int_range(out_bits, out_signed)
        shift = 128 if not out_signed and out_bits == 8 else 0
        if not -128 <= lo - shift <= hi - shift <= 127:
            raise ValueError(f"int_matmul: {out_bits}-bit {'signed' if out_signed else 'unsigned'} "
                             "requant codes do not fit int8")
        kw.update(out_scale=_vec(out_scale, N, torch.float32, dev), r_lo=lo, r_hi=hi,
                  r_shift=shift, act_fn=act_fn, cast_dtype=cast_dtype)
    if _fake(x):
        M = x.shape[0]
        dtype = torch.int8 if out_scale is not None else \
            torch.float32 if scale is not None else torch.int32
        y = x.new_empty((M, N), dtype=dtype)  # on x: a fake tensor, not an allocation
        _fake_cost("int_matmul", 2 * M * K * N, (x, w, scale, bias, offset), (y,))
        return y
    if dev.type == "cpu":
        return int_matmul_plain(x, w, scale, bias, offset, **kw)
    return int_matmul_cuda(x.contiguous(), w.contiguous(), scale, bias, offset, **kw)


def a2q_quantize(
    v: torch.Tensor,
    t: torch.Tensor,
    d: torch.Tensor,
    *,
    weight_bits: int,
    acc_bits: int,
    input_bits: int,
    input_signed: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused A2Q quantizer for a ``(K, C)`` weight matrix with per-column
    ``t``/``d`` of shape ``(C,)``: ``q = clip(trunc(g/s * v / ||v||_1))`` at
    ``weight_bits`` with the Eq. 23 norm cap for a ``acc_bits`` accumulator
    and ``input_bits``/``input_signed`` inputs.  Returns (int8 ``q``, fp32
    ``s = 2^d`` ``(C,)``); the reference's dequantized weights are ``q * s``
    (exact in fp32: ``s`` is a power of two), which the kernel does not
    write here.  ``g/s`` and ``s`` are computed here, per column,
    with ``core.a2q``'s own expression, so the kernel and the plain version
    (``a2q_int_weights``' arithmetic) differ at most in the l1 sum's order.
    Oracle: ``ref.ref_a2q_quantize``."""
    _refuse_operands("a2q_quantize", v, t, d)
    if v.ndim != 2 or tuple(t.shape) != (v.shape[1],) or tuple(d.shape) != (v.shape[1],):
        raise ValueError(f"a2q_quantize: v {tuple(v.shape)} with t {tuple(t.shape)}, d "
                         f"{tuple(d.shape)}: (K, C) and (C,) expected")
    if weight_bits > 8:
        raise ValueError(f"a2q_quantize: {weight_bits}-bit codes do not fit int8")
    n, p = int_range(weight_bits, True)
    gs, s = _effective_gs({"t": t.to(torch.float32), "d": d.to(torch.float32)}, acc_bits,
                          input_bits, input_signed)
    v = v.to(torch.float32)
    if _fake(v):
        K, C = v.shape
        q = v.new_empty((K, C), dtype=torch.int8)
        _fake_cost("a2q_quantize", 4 * K * C, (v, gs, s), (q, s))
        return q, s
    if v.device.type == "cpu":
        _, q, _ = a2q_quantize_plain(v, gs, s, n=n, p=p, dequantize=False)
    else:
        _, q, _ = a2q_quantize_cuda(v.contiguous(), gs.contiguous(), s.contiguous(), n=n, p=p,
                                    dequantize=False)
    return q, s


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention of ``q (B, H, Tq, D)`` over ``k, v (B, KV, Tk, D)``
    (query head ``h`` reads KV head ``h // (H // KV)``; ``KV == H`` is the
    reference wrapper's contract): queries end-aligned to the keys, causal
    and sliding-window masks, fp32 softmax, a query with no kept key gives
    0; out ``(B, H, Tq, D)`` in ``q``'s dtype.  The head views of ``(B, T,
    H * D)`` projections go in without a copy.  ``q_chunk`` bounds the
    plain version's scores to ``(B, H, q_chunk, Tk)``; the kernel tiles the
    queries itself.  Oracle: ``ref.ref_flash_attention``."""
    _refuse_operands("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or q.shape[0] != k.shape[0] or \
            q.shape[3] != k.shape[3] or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit")
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if _fake(q):
        out = torch.empty_like(q)
        b, h, tq, d = q.shape
        _fake_cost("flash_attention", 4 * b * h * d * _causal_pairs(tq, k.shape[2], causal, window),
                   (q, k, v), (out,))
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                     q_chunk=q_chunk)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


def paged_attention(
    q: torch.Tensor,
    kp: torch.Tensor,
    vp: torch.Tensor,
    bt: torch.Tensor,
    lengths: torch.Tensor,
    *,
    kps: Optional[torch.Tensor] = None,
    vps: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Paged-attention decode: one query token per row against block-table
    K/V pools.  ``q (B, H, Dh)``, pools ``(NB, bs, KV, Dh)``, table
    ``bt (B, MB)``, ``lengths (B,)`` counting valid tokens (including this
    step's write).  Returns ``(B, H, Dh)`` in ``q``'s dtype.  Oracle:
    ``ref.ref_paged_attention``.  ``window`` keeps keys at
    ``kpos >= length - window``.

    ``kps``/``vps`` (``(NB, bs, KV)`` fp32) declare integer pools,
    dequantized in registers: int8 codes (oracle
    ``ref.ref_paged_attention_q8``) or, when the pools are uint8, packed
    int4 at width ``Dh // 2`` (oracle ``ref.ref_paged_attention_q4``)."""
    _refuse_operands("paged_attention", q, kp, vp, kps, vps)
    if (kps is None) != (vps is None):
        raise ValueError("paged_attention: kps and vps must be given together")
    if kp.dtype == torch.uint8 and kps is None:
        raise ValueError("paged_attention: packed int4 pools need kps/vps")
    if window is not None and window < 1:
        raise ValueError("paged_attention: window must be >= 1")
    if q.ndim != 3 or kp.ndim != 4 or q.shape[1] % kp.shape[2]:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not fit pools {tuple(kp.shape)}")
    if _fake(q):
        # the table's capacity stands for the valid keys (a fake length has no value)
        out = torch.empty_like(q)
        B, H, Dh = q.shape
        toks = bt.shape[0] * bt.shape[1] * kp.shape[1]
        row = kp.shape[2] * kp.shape[3] * kp.element_size() + \
            (kp.shape[2] * kps.element_size() if kps is not None else 0)
        _fake_cost("paged_attention", 4 * toks * H * Dh, (q, bt, lengths), (out,), 2 * toks * row)
        return out
    if q.device.type == "cpu":
        return paged_attention_plain(q, kp, vp, bt, lengths, kps, vps, scale=scale,
                                     window=window)
    return paged_attention_cuda(
        q.contiguous(), kp, vp, bt.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), kps, vps, scale=scale, window=window,
    )


def paged_mla_attention(
    q_lat: torch.Tensor,
    q_pe: torch.Tensor,
    ckvp: torch.Tensor,
    kpep: torch.Tensor,
    bt: torch.Tensor,
    lengths: torch.Tensor,
    *,
    ckvs: Optional[torch.Tensor] = None,
    kpes: Optional[torch.Tensor] = None,
    scale: float,
    aq_scale=None,
    act_bits: Optional[int] = None,
) -> torch.Tensor:
    """MLA absorbed-decode latent attention over paged compressed pools.

    ``q_lat (B, H, R)`` is the query absorbed through the up-projection's key
    half, ``q_pe (B, H, P)`` the rope half; pools ``ckvp (NB, bs, R)`` /
    ``kpep (NB, bs, P)`` hold the shared latent and rope key per token, table
    ``bt (B, MB)``, ``lengths (B,)`` counting valid tokens including this
    step's write.  Returns the latent output ``o_lat (B, H, R)`` fp32; the
    caller up-projects it through ``w_v``.  ``scale`` is the absorbed score
    scale ``(qk_nope_dim + qk_rope_dim) ** -0.5``.  ``aq_scale``/``act_bits``
    replay the absorb path's activation fake-quant on the latent.  Oracle:
    ``ref.ref_paged_mla_attention``.

    ``ckvs``/``kpes`` (``(NB, bs)`` fp32 per-token scales) declare integer
    pools: int8 codes, or packed int4 at half width when uint8, dequantized
    (code times scale) before the replay and the products."""
    _refuse_operands("paged_mla_attention", q_lat, q_pe, ckvp, kpep, ckvs, kpes, aq_scale)
    if (ckvs is None) != (kpes is None):
        raise ValueError("paged_mla_attention: ckvs and kpes must be given together")
    if ckvp.dtype == torch.uint8 and ckvs is None:
        raise ValueError("packed int4 latent pools need ckvs/kpes scale pools")
    if (act_bits is None) != (aq_scale is None):
        raise ValueError("aq_scale and act_bits must be given together")
    if q_lat.ndim != 3 or q_pe.ndim != 3 or ckvp.ndim != 3 or kpep.ndim != 3 or \
            q_lat.shape[:2] != q_pe.shape[:2] or ckvp.shape[:2] != kpep.shape[:2]:
        raise ValueError(f"paged_mla_attention: q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)} do not fit pools {tuple(ckvp.shape)}, "
                         f"{tuple(kpep.shape)}")
    if _fake(q_lat):
        B, H, R = q_lat.shape
        P = q_pe.shape[-1]
        out = q_lat.new_empty((B, H, R), dtype=torch.float32)
        toks = bt.shape[0] * bt.shape[1] * ckvp.shape[1]  # the table's capacity
        row = ckvp.shape[2] * ckvp.element_size() + kpep.shape[2] * kpep.element_size() + \
            (ckvs.element_size() + kpes.element_size() if ckvs is not None else 0)
        _fake_cost("paged_mla_attention", 2 * H * toks * (R + P + R), (q_lat, q_pe, bt, lengths),
                   (out,), toks * row)
        return out
    if q_lat.device.type == "cpu":
        return paged_mla_attention_plain(q_lat, q_pe, ckvp, kpep, bt, lengths, ckvs, kpes,
                                         scale=scale, aq_scale=aq_scale, act_bits=act_bits)
    if aq_scale is not None:
        aq_scale = torch.as_tensor(aq_scale, dtype=torch.float32,
                                   device=q_lat.device).reshape(1).contiguous()
    return paged_mla_attention_cuda(
        q_lat.to(torch.float32).contiguous(), q_pe.to(torch.float32).contiguous(),
        ckvp.contiguous(), kpep.contiguous(), bt.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), ckvs, kpes, scale=scale, aq_scale=aq_scale,
        act_bits=act_bits,
    )


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
    *,
    out_dtype=None,
    min_w: Optional[float] = None,
    state_out: Optional[torch.Tensor] = None,
):
    """RWKV-6 scan over ``(B, H, T, Dk/Dv)`` tensors with the per-head bonus
    ``u (H, Dk)`` shared by the batch (the reference's ``ops.rwkv6_scan``
    contract).  Returns ``(y (B, H, T, Dv), S_T (B, H, Dk, Dv) fp32)``, y in
    ``out_dtype`` (default ``r``'s dtype; the decode step asks for fp32).
    ``min_w`` floors the decay (``exp(-8)`` replays the chunked form's
    log-decay clamp); ``state_out`` receives S_T and may be
    ``initial_state`` itself (the slot's state updated in place).  Oracle:
    ``ref.ref_rwkv6`` per head."""
    _refuse_operands("rwkv6_scan", r, k, v, w, u, initial_state)
    if r.ndim != 4 or k.shape != r.shape or w.shape != r.shape or v.ndim != 4 or \
            v.shape[:3] != r.shape[:3] or tuple(u.shape) != (r.shape[1], r.shape[3]):
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)} do not fit")
    out_dtype = r.dtype if out_dtype is None else out_dtype
    if _fake(r):
        B, H, T, D = r.shape
        y = r.new_empty((B, H, T, v.shape[3]), dtype=out_dtype)
        S = state_out if state_out is not None else \
            r.new_empty((B, H, D, v.shape[3]), dtype=torch.float32)
        _fake_cost("rwkv6_scan", 7 * B * H * T * D * v.shape[3], (r, k, v, w, u, initial_state),
                   (y, S))
        return y, S
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, initial_state, out_dtype=out_dtype, min_w=min_w,
                                state_out=state_out)
    return rwkv6_scan_cuda(r, k, v, w, u, initial_state, out_dtype=out_dtype, min_w=min_w,
                           state_out=state_out)
