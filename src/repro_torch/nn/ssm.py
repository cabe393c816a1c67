"""RWKV-6 (Finch) blocks: the time-mix recurrence and the channel-mix.

Port of the rwkv6 half of ``repro.nn.ssm`` (the Mamba-2 SSD heads that
hymba needs are not ported yet).  The recurrence is "diagonal decay + rank-1
update", O(1) state in sequence length::

    y_t = r_t @ (S + (u * k_t) v_t^T)
    S   = diag(w_t) S + k_t v_t^T

``rwkv6_sequential`` (the step-by-step oracle), ``rwkv6_chunked`` (the
parallel form: per-chunk cumulative log-decays, two matmuls and a masked
score matmul a chunk, the log-decay clamped at ``_MIN_LOGW`` so
``exp(+|logA|)`` stays inside fp32) and ``rwkv6_decode_step`` are the
reference's three forms in plain PyTorch; the time-mix runs them on the CPU.
On CUDA tensors every form goes through ``ops.rwkv6_scan``, the
hand-written scan kernel, with the decay floored at ``exp(_MIN_LOGW)`` where
the reference takes the chunked form and y kept in fp32 for the decode step,
as the reference's forms return it.

A2Q attaches to every projection (r/k/v/g/o and the channel-mix's k/v); the
recurrence has no frozen weight vector to bound.  With a cache the layers
update the slot's recurrent leaves (``tm.S``, ``tm.shift``, ``cm.shift``) in
place, as the attention layers write their pools: the reference returns new
leaves instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import QuantConfig, SSMConfig
from repro_torch.nn.linear import IntAct, apply_linear, chain_out_aq, init_linear
from repro_torch.nn.module import normal_init

__all__ = [
    "rwkv6_sequential",
    "rwkv6_chunked",
    "rwkv6_decode_step",
    "init_rwkv6_timemix",
    "apply_rwkv6_timemix",
    "init_rwkv6_channelmix",
    "apply_rwkv6_channelmix",
]

_MIN_LOGW = -8.0
f32 = torch.float32  # the recurrence's and the groupnorm's dtype


# ---------------------------------------------------------------------------
# RWKV-6 recurrence (the CPU forms)
# ---------------------------------------------------------------------------


def rwkv6_decode_step(r, k, v, w, u, S):
    """One token: r/k/w ``(B, H, Dk)``, v ``(B, H, Dv)``, u ``(H, Dk)``, S
    ``(B, H, Dk, Dv)``.  Returns (y ``(B, H, Dv)`` fp32, the new S)."""
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    return y, w[..., :, None] * S + kv


def rwkv6_sequential(r, k, v, w, u, S0):
    """Oracle: step-by-step scan.  Shapes ``(B, H, T, Dk/Dv)``, u ``(H, Dk)``,
    S0 ``(B, H, Dk, Dv)``.  Returns (y ``(B, H, T, Dv)`` in ``r``'s dtype,
    S_T)."""
    S = S0.to(f32)
    ys = []
    for t in range(r.shape[2]):
        y, S = rwkv6_decode_step(r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t], u, S)
        ys.append(y)
    return torch.stack(ys, 2).to(r.dtype), S


def rwkv6_chunked(r, k, v, w, u, S0, chunk: int = 32):
    """Chunked parallel form, the same signature and semantics as the oracle
    up to the log-decay clamp at ``_MIN_LOGW``."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    if T % chunk:
        raise ValueError(f"rwkv6_chunked: T={T} is not a multiple of the chunk {chunk}")
    nc = T // chunk

    def to_chunks(x):
        return x.reshape(B, H, nc, chunk, x.shape[-1]).to(f32)

    logw = torch.clamp_min(torch.log(torch.clamp_min(w.to(f32), 1e-30)), _MIN_LOGW)
    rc, kc, vc, lc = (to_chunks(t) for t in (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device), diagonal=-1)
    S = S0.to(f32)
    ys = []
    for c in range(nc):
        r_c, k_c, v_c, lw = rc[:, :, c], kc[:, :, c], vc[:, :, c], lc[:, :, c]
        logA = torch.cumsum(lw, dim=2)  # inclusive within-chunk products
        r_in = r_c * torch.exp(logA - lw)  # exclusive
        k_in = k_c * torch.exp(-logA)
        y = torch.einsum("bhld,bhdv->bhlv", r_in, S)  # inter-chunk
        att = torch.einsum("bhld,bhmd->bhlm", r_in, k_in)
        y = y + torch.einsum("bhlm,bhmv->bhlv", att * tri, v_c)
        diag = torch.einsum("bhld,bhld->bhl", r_c, u[None, :, None, :] * k_c)
        y = y + diag[..., None] * v_c
        k_out = k_c * torch.exp(logA[:, :, -1:, :] - logA)  # (A_L / A_i) <= 1
        S = torch.exp(logA[:, :, -1, :])[..., None] * S + torch.einsum(
            "bhld,bhlv->bhdv", k_out, v_c)
        ys.append(y)
    y = torch.stack(ys, 2).reshape(B, H, T, Dv)
    return y.to(r.dtype), S


# ---------------------------------------------------------------------------
# RWKV-6 block sublayers (time-mix + channel-mix)
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """The x_{t-1} stream: (shifted x, the new carry x_T)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def init_rwkv6_timemix(gen: torch.Generator, d_model: int, ssm: SSMConfig, q: QuantConfig) -> dict:
    H = d_model // ssm.head_dim
    dev = gen.device
    return {
        "mix": torch.full((5, d_model), 0.5, device=dev),
        "wr": init_linear(gen, d_model, d_model, q),
        "wk": init_linear(gen, d_model, d_model, q),
        "wv": init_linear(gen, d_model, d_model, q),
        "wg": init_linear(gen, d_model, d_model, q),
        "wo": init_linear(gen, d_model, d_model, q),
        # data-dependent decay LoRA: d_model -> rank -> d_model
        "w_lora_a": normal_init(gen, (d_model, ssm.lora_rank), 0.02),
        "w_lora_b": normal_init(gen, (ssm.lora_rank, d_model), 0.02),
        "w0": torch.full((d_model,), -0.6, device=dev),
        "u": normal_init(gen, (H, ssm.head_dim), 0.02),
        "ln_scale": torch.ones((d_model,), device=dev),
    }


def _recurrence(r, k, v, w, u, ssm: SSMConfig, state: Optional[dict]):
    """The reference's dispatch on T: no state -> chunked (``T % chunk``
    must hold), ``T == 1`` -> the decode step (fp32 y), ``T % chunk == 0``
    -> chunked, else sequential.  On CUDA every branch is the scan kernel
    (the chunked branches with the decay floored at ``exp(_MIN_LOGW)``), the
    state written over ``state["S"]`` in place; on the CPU the branch's own
    form, copied into ``state["S"]``.  Returns y ``(B, H, T, Dv)``."""
    T = r.shape[2]
    if state is None:
        if T % ssm.chunk:
            raise ValueError(f"a cacheless rwkv6 forward takes the chunked form: T={T} is not "
                             f"a multiple of the chunk {ssm.chunk}")
        form = "chunked"
    else:
        form = "decode" if T == 1 else "chunked" if T % ssm.chunk == 0 else "sequential"
    if r.device.type == "cuda":
        from repro_torch.kernels import ops

        y, _ = ops.rwkv6_scan(
            r, k, v, w, u, None if state is None else state["S"],
            out_dtype=f32 if form == "decode" else r.dtype,
            min_w=math.exp(_MIN_LOGW) if form == "chunked" else None,
            state_out=None if state is None else state["S"])
        return y
    if form == "decode":
        y, S = rwkv6_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u, state["S"])
        y = y[:, :, None]
    elif form == "chunked":
        S0 = state["S"] if state is not None else r.new_zeros(
            (r.shape[0], r.shape[1], r.shape[3], v.shape[3]), dtype=f32)
        y, S = rwkv6_chunked(r, k, v, w, u, S0, chunk=ssm.chunk)
    else:
        y, S = rwkv6_sequential(r, k, v, w, u, state["S"])
    if state is not None:
        state["S"].copy_(S)
    return y


def apply_rwkv6_timemix(params: dict, x: torch.Tensor, ssm: SSMConfig, q: QuantConfig,
                        state: Optional[dict] = None, *, compute_dtype=torch.bfloat16,
                        int_forward: bool = False, int_chain: bool = False):
    """``state = {"S": (B, H, Dk, Dv) fp32, "shift": (B, 1, d)}`` for a cached
    step (updated in place and returned), ``None`` for a cacheless forward.

    With a state T may exceed 1 (chunked prefill): the recurrence starts from
    the carried S, so a prompt fed in chunks equals the prompt fed token by
    token.  Every time-mix projection is a chain break (wr/wk/wv/wg read
    distinct token-shift mixes, wo sits behind the groupnorm and the silu
    gate), so under ``int_chain`` each folds its act-quant into the kernel's
    prologue."""
    B, T, D = x.shape
    Dk = ssm.head_dim
    H = D // Dk

    def lin(name, xi):
        return apply_linear(params[name], xi, q, compute_dtype=compute_dtype,
                            int_forward=int_forward, int_chain=int_chain, site=f"tm.{name}")

    xs, new_shift = _token_shift(x, state["shift"] if state is not None else None)
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + mix[i] * (xs - x) for i in range(5))

    def to_heads(t):
        return t.reshape(B, T, H, Dk).transpose(1, 2)

    r = to_heads(lin("wr", xr))
    k = to_heads(lin("wk", xk))
    v = to_heads(lin("wv", xv))
    g = lin("wg", xg)
    lora = torch.tanh(xw.to(f32) @ params["w_lora_a"].to(f32))
    dd = lora @ params["w_lora_b"].to(f32)
    w = to_heads(torch.exp(-torch.exp(params["w0"].to(f32) + dd)))  # (0, 1)
    y = _recurrence(r, k, v, w, params["u"].to(f32), ssm, state)
    # per-head groupnorm, then the silu(g) gate
    yf = y.transpose(1, 2).to(f32)  # (B, T, H, Dk)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = (yf - yf.mean(-1, keepdim=True)) * (var + 1e-5) ** -0.5
    y = (yf.reshape(B, T, D) * params["ln_scale"].to(f32)).to(compute_dtype)
    y = y * F.silu(g.to(f32)).to(compute_dtype)
    out = apply_linear(params["wo"], y, q, compute_dtype=compute_dtype, int_forward=int_forward,
                       int_chain=int_chain, site="tm.wo")
    if state is not None:
        state["shift"].copy_(new_shift)
    return out, state


def init_rwkv6_channelmix(gen: torch.Generator, d_model: int, d_ff: int, q: QuantConfig) -> dict:
    return {
        "mix": torch.full((d_model,), 0.5, device=gen.device),
        "wk": init_linear(gen, d_model, d_ff, q),
        "wv": init_linear(gen, d_ff, d_model, q, input_signed=False),
    }


def apply_rwkv6_channelmix(params: dict, x: torch.Tensor, q: QuantConfig,
                           state: Optional[dict] = None, *, compute_dtype=torch.bfloat16,
                           int_forward: bool = False, int_chain: bool = False):
    """``wk -> relu^2 -> wv`` is the archetypal int8 chain: under
    ``int_chain`` wk squares-relus the rescaled accumulator in its own
    epilogue and requantizes straight into wv's unsigned quantizer, so the
    codes cross as an :class:`IntAct` and no fp32 activation exists between
    them.  ``state = {"shift": (B, 1, d)}`` is updated in place."""
    xs, new_shift = _token_shift(x, state["shift"] if state is not None else None)
    xk = x + params["mix"].to(x.dtype) * (xs - x)
    out_aq = (chain_out_aq(params["wv"], q, input_signed=False, act_fn="relu2")
              if int_chain else None)
    h = apply_linear(params["wk"], xk, q, compute_dtype=compute_dtype, int_forward=int_forward,
                     int_chain=int_chain, out_aq=out_aq, site="cm.wk")
    if not isinstance(h, IntAct):
        h = torch.square(torch.relu(h))  # squared relu: non-negative, so unsigned codes
    out = apply_linear(params["wv"], h, q, input_signed=False, compute_dtype=compute_dtype,
                       int_forward=int_forward, int_chain=int_chain, site="cm.wv")
    if state is not None:
        state["shift"].copy_(new_shift)
    return out, state
