"""Baseline quantization-aware-training (QAT) operators — paper Section 2.1.

The standard uniform quantize/dequantize pipeline of the paper's *baseline*
QAT algorithm, plus the shared primitives A2Q builds on:

* straight-through-estimator rounding (half-way and round-toward-zero),
* per-channel / per-tensor scales, exponentially parameterized ``s = 2**d``
  with ``d`` learned by SGD (paper Sec. 4.1),
* weight quantizers with ``z = 0`` (paper convention), activation quantizers
  signed or unsigned depending on the preceding nonlinearity.

Pure functions over dicts of tensors, with the same parameter names and
arithmetic order as ``repro.core.quantizers``.  Scales are ``torch.exp2`` of
the learned log2 value, which can differ from ``jnp.exp2`` in the last bits;
integer codes agree, floats agree to tolerance.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.bounds import int_range

RoundMode = Literal["nearest", "to_zero"]

__all__ = [
    "clip",
    "ste_round",
    "ste_round_to_zero",
    "fake_quant",
    "init_weight_qat",
    "apply_weight_qat",
    "weight_qat_int",
    "init_act_quant",
    "apply_act_quant",
    "act_quant_int",
]


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` as max-then-min, so a value sitting exactly on a bound
    splits its gradient the way JAX does (half to each side).  The bounds
    are filled on the device (no host-to-device copy in the forward)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Half-to-even rounding with a straight-through gradient (grad == 1)."""
    return x + (torch.round(x) - x).detach()


def ste_round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """Round toward zero (truncate) with a straight-through gradient — A2Q's
    rounding mode: truncation only shrinks magnitudes, so the integer l1 norm
    can never round past the accumulator budget (paper Sec. 4.1)."""
    return x + (torch.trunc(x) - x).detach()


_ROUND = {"nearest": ste_round, "to_zero": ste_round_to_zero}


def fake_quant(x, scale, bits: int, signed: bool, round_mode: RoundMode = "nearest"):
    """quantize (Eq. 1, z=0) then dequantize (Eq. 2): clip(round(x/s)) * s."""
    n, p = int_range(bits, signed)
    q = clip(_ROUND[round_mode](x / scale), n, p)
    return q * scale


def _channel_reduce(w: torch.Tensor, op) -> torch.Tensor:
    """Reduce every axis except the last (output-channel) axis."""
    return op(w.reshape(-1, w.shape[-1]), 0) if w.ndim > 1 else w


def init_weight_qat(w: torch.Tensor, bits: int, per_channel: bool = True) -> dict:
    """Calibrate the learned log2-scale from the float weights (max-abs init)."""
    _, p = int_range(bits, signed=True)
    if per_channel:
        absmax = _channel_reduce(w.abs(), lambda a, d: a.amax(d))
    else:
        absmax = w.abs().amax()
    absmax = torch.clamp_min(absmax, 1e-8)
    return {"log2_scale": torch.log2(absmax / p).to(torch.float32)}


def apply_weight_qat(params: dict, w: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake-quantized weights (float domain). Weights are always signed, z=0."""
    scale = torch.exp2(params["log2_scale"].to(w.dtype))
    return fake_quant(w, scale, bits, signed=True, round_mode="nearest")


def weight_qat_int(params: dict, w: torch.Tensor, bits: int):
    """(integer weights, per-channel scale) — the inference-time artifacts."""
    scale = torch.exp2(params["log2_scale"].to(w.dtype))
    n, p = int_range(bits, signed=True)
    q = clip(torch.round(w / scale), n, p)
    return q, scale


def init_act_quant(bits: int, signed: bool, init_absmax: float = 6.0, device="cpu") -> dict:
    """Per-tensor learned log2 scale. ``init_absmax`` approximates the dynamic
    range after the preceding nonlinearity (6.0 suits ReLU-family nets)."""
    _, p = int_range(bits, signed)
    v = torch.tensor(init_absmax / p, dtype=torch.float32, device=device)
    return {"log2_scale": torch.log2(v)}


def apply_act_quant(params: dict, x: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    scale = torch.exp2(params["log2_scale"].to(x.dtype))
    return fake_quant(x, scale, bits, signed=signed, round_mode="nearest")


def act_quant_int(params: dict, x: torch.Tensor, bits: int, signed: bool):
    """(integer activations as floats, scale) for integer-exact inference.
    Divides by the scale (never multiplies by its reciprocal), as the
    reference does, so the codes agree bit for bit."""
    scale = torch.exp2(params["log2_scale"].to(x.dtype))
    n, p = int_range(bits, signed)
    q = clip(torch.round(x / scale), n, p)
    return q, scale
