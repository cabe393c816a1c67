"""A2Q: accumulator-aware quantization (paper Section 4, Eq. 16-23).

The weight quantizer is reparameterized with l1 weight normalization::

    w_i = g_i * v_i / ||v_i||_1        (per output channel i, Eq. 17)

with exponential parameterizations ``s = 2**d`` (scale) and ``g = 2**min(T, t)``
(norm), where ``d`` and ``t`` are learned log-scale parameters and

    T = 1_signed(x) + log2(2**(P-1) - 1) + d - N                      (Eq. 23)

caps the learned norm so the *integer* weights provably satisfy the per-channel
l1 budget (Eq. 15)::

    ||w_int||_1 <= (2**(P-1) - 1) * 2**(1_signed(x) - N)

Rounding is toward zero, so rounding never pushes the integer l1 norm past the
budget and every partial sum against N-bit inputs fits a P-bit accumulator.

Weights are stored ``(K, C_out)``: each output channel (each accumulator) is a
column, as in ``repro.core.a2q``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.bounds import int_range
from repro_torch.core.quantizers import clip, ste_round_to_zero

__all__ = [
    "a2q_norm_cap",
    "init_a2q",
    "apply_a2q",
    "a2q_int_weights",
    "a2q_penalty",
    "a2q_channel_l1",
]

_EPS = 1e-12


def a2q_norm_cap(d: torch.Tensor, acc_bits: int, input_bits: int, input_signed: bool) -> torch.Tensor:
    """Eq. 23: ``T = 1_signed(x) + log2(2**(P-1) - 1) + d - N`` (per channel)."""
    # filled on the device: no host-to-device copy in a forward
    log2_amax = torch.log2(d.new_full((), 2.0 ** (acc_bits - 1) - 1.0))
    return int(input_signed) + log2_amax + d - input_bits


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum of ``a (..., R, C)`` over its rows in one fixed order: a perfect
    binary tree over the rows zero-padded to a power of two (``((r0 + r1) +
    (r2 + r3)) + ...``), one rounded fp32 add a node; leading axes are
    batch axes.  Every device and the ``a2q_quantize`` kernel compute it bit
    for bit alike, so the deployed codes on the card equal the plain
    quantizer's (``torch.sum``'s order is its own on each device).  A DTensor
    takes ``_sharded_pairwise_sum``."""
    if isinstance(a, DTensor):
        return _sharded_pairwise_sum(a)
    while a.shape[-2] > 1:
        if a.shape[-2] % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1, :])], dim=-2)
        a = a[..., 0::2, :] + a[..., 1::2, :]
    return a.sum(-2)  # one row (or none): the row itself


def _sharded_pairwise_sum(a: DTensor) -> DTensor:
    """``pairwise_sum`` of a DTensor, exact and in one fixed order when its
    row dim is sharded (an FSDP ``v``, its K split over ``data``): each rank
    sums its own rows pairwise, the ``n`` partials are all-gathered (in the
    rows' order) and summed pairwise.  Where ``n`` and every shard's row
    count are powers of two this is the whole tree's order, bit for bit;
    elsewhere the two trees pad at other places.  A replicated row dim sums
    locally.  The result keeps ``a``'s other placements (dims past the rows
    move down by one)."""
    rows = a.dim() - 2
    mesh = a.device_mesh
    part = pairwise_sum(a.to_local())  # (..., C) of this rank's rows
    sharded = [i for i, p in enumerate(a.placements) if isinstance(p, Shard) and p.dim == rows]

    def keep(p):
        if isinstance(p, Shard) and p.dim > rows:
            return Shard(p.dim - 1)
        return Replicate() if isinstance(p, Shard) and p.dim == rows else p

    out = [keep(p) for p in a.placements]
    if sharded:
        # the partials stacked on the row dim, gathered over its mesh dims
        # (DTensor's all-gather: differentiable, and in the shards' order)
        stacked = DTensor.from_local(part.unsqueeze(rows), mesh, a.placements, run_check=False)
        gathered = stacked.redistribute(mesh, [Replicate() if i in sharded else p
                                               for i, p in enumerate(a.placements)])
        part = pairwise_sum(gathered.to_local())
    return DTensor.from_local(part, mesh, out, run_check=False)


def _channel_sum(w: torch.Tensor) -> torch.Tensor:
    return pairwise_sum(w.reshape(-1, w.shape[-1]))


def init_a2q(w: torch.Tensor, bits: int, acc_bits: int, input_bits: int, input_signed: bool) -> dict:
    """Initialize (v, t, d) from a float weight tensor (last axis = output
    channel): ``v`` starts at the weights, ``d`` at the max-abs scale,
    ``t = log2 ||w||_1`` clamped to the cap ``T``.  When the Eq. 15 budget
    ``B`` is below the fan-in, only the top-``floor(B)`` magnitudes of each
    channel are kept (they are all an integer channel can hold), so the
    layer is not born with every weight truncated to zero."""
    pmax = float(2 ** (bits - 1) - 1)
    K = w[..., 0].numel()
    budget = (2.0 ** (acc_bits - 1) - 1.0) * 2.0 ** (int(input_signed) - input_bits)
    m = int(budget)
    if 0 < m < K:
        flat = w.reshape(K, w.shape[-1]).abs()
        kth = torch.topk(flat, m, dim=0).values[m - 1]  # m-th largest |w| per channel
        keep = flat >= torch.clamp_min(kth, 1e-12)[None, :]
        w = (w.reshape(K, -1) * keep).reshape(w.shape)
    absmax = torch.clamp_min(w.reshape(-1, w.shape[-1]).abs().amax(0), 1e-8)
    l1 = torch.clamp_min(_channel_sum(w.abs()), 1e-8)
    d = torch.log2(absmax / pmax).to(torch.float32)
    T = a2q_norm_cap(d, acc_bits, input_bits, input_signed)
    t = torch.minimum(torch.log2(l1).to(torch.float32), T)
    return {"v": w.to(torch.float32), "t": t, "d": d}


def _abs(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` with ``jnp.abs``'s gradient: +1 at ``v == 0`` (``torch.abs``
    gives 0 there).  The initializer zeroes every weight past a column's
    budget, so the l1 norm's gradient reaches those entries in the
    reference and must in the port."""
    return torch.where(v >= 0, v, -v)


def _effective_gs(params: dict, acc_bits: int, input_bits: int, input_signed: bool):
    """(g/s ratio, s) with the norm cap applied — shared by train + int paths."""
    d, t = params["d"], params["t"]
    T = a2q_norm_cap(d, acc_bits, input_bits, input_signed)
    t_eff = torch.minimum(t, T)  # g = 2**min(t, T)   (Eq. 22)
    return torch.exp2(t_eff - d), torch.exp2(d)


def apply_a2q(params: dict, bits: int, acc_bits: int, input_bits: int, input_signed: bool,
              dtype=torch.float32) -> torch.Tensor:
    """Eq. 20: ``q(w; s) = clip(rtz(g/s * v/||v||_1); n, p) * s`` (fake-quant).
    STE through rtz, clipped-STE through clip; gradients reach v, t and d.
    Leading axes that ``t``/``d`` share with ``v`` (a stack's layers) are
    batch axes: each layer's weights are, bit for bit, those of its own
    call, in one set of operators for the whole stack."""
    v = params["v"]
    n, p = int_range(bits, signed=True)
    g_over_s, s = _effective_gs(params, acc_bits, input_bits, input_signed)
    lead = params["t"].ndim - 1
    l1_v = torch.clamp_min(pairwise_sum(_abs(v).reshape(*v.shape[:lead], -1, v.shape[-1])), _EPS)
    # per-column values broadcast over each layer's rows
    g_over_s, l1_v, s = (x.reshape(*x.shape[:lead], *[1] * (v.ndim - lead - 1), x.shape[-1])
                         for x in (g_over_s, l1_v, s))
    q = clip(ste_round_to_zero(g_over_s * v / l1_v), n, p)
    return (q * s).to(dtype)


def a2q_int_weights(params: dict, bits: int, acc_bits: int, input_bits: int, input_signed: bool):
    """(integer weights as floats, per-channel scale) — the deployable
    artifacts; ``||w_int||_1 <= g/s <= (2**(P-1)-1) * 2**(1_signed - N)``."""
    n, p = int_range(bits, signed=True)
    g_over_s, s = _effective_gs(params, acc_bits, input_bits, input_signed)
    return a2q_codes(params["v"], g_over_s, n, p)[0], s


def a2q_codes(v: torch.Tensor, g_over_s: torch.Tensor, n: int, p: int):
    """(integer weights as floats, per-channel l1 of ``v``): ``clip(trunc(g/s
    * v / ||v||_1), n, p)``, the arithmetic of ``a2q_int_weights`` and of the
    fused quantizer's plain version."""
    l1_v = torch.clamp_min(_channel_sum(v.abs()), _EPS)
    return clip(torch.trunc(g_over_s * v / l1_v), n, p), l1_v


def a2q_penalty(params: dict, acc_bits: int, input_bits: int, input_signed: bool) -> torch.Tensor:
    """Per-layer regularizer ``R_l = sum_i max(t_i - T_i, 0)`` (Sec. 4.1).
    ``torch.maximum`` splits the gradient at a tie ``t == T`` (0.5 to ``t``),
    as ``jnp.maximum`` does; ``init_a2q`` starts every capped column there."""
    T = a2q_norm_cap(params["d"], acc_bits, input_bits, input_signed)
    return torch.maximum(params["t"] - T, T.new_zeros(())).sum()


def a2q_channel_l1(params: dict, bits: int, acc_bits: int, input_bits: int, input_signed: bool):
    """Per-channel l1 norm of the *integer* weights."""
    q, _ = a2q_int_weights(params, bits, acc_bits, input_bits, input_signed)
    return _channel_sum(q.abs())
