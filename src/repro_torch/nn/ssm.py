"""Attention-free sequence mixers: RWKV-6 (Finch) blocks and hymba's
Mamba-2 SSD heads.

Port of ``repro.nn.ssm``.  The RWKV-6 recurrence is "diagonal decay +
rank-1 update", O(1) state in sequence length::

    y_t = r_t @ (S + (u * k_t) v_t^T)
    S   = diag(w_t) S + k_t v_t^T

``rwkv6_sequential`` (the step-by-step oracle), ``rwkv6_chunked`` (the
parallel form: per-chunk cumulative log-decays, two matmuls and a masked
score matmul a chunk, the log-decay clamped at ``_MIN_LOGW`` so
``exp(+|logA|)`` stays inside fp32) and ``rwkv6_decode_step`` are the
reference's three forms in plain PyTorch; the time-mix runs them on the CPU
(on fake tensors they raise outside autograd: ``kernels._guard``).
On CUDA tensors every form goes through ``ops.rwkv6_scan``, the
hand-written scan kernel, with the decay floored at ``exp(_MIN_LOGW)`` where
the reference takes the chunked form and y kept in fp32 for the decode step,
as the reference's forms return it; but a forward that autograd records
(training) takes ``rwkv6_chunked`` on every device, the form the
reference's layers train through (the kernel has no backward, as its
Pallas counterpart has none).

hymba's mamba heads run the Mamba-2 SSD, a scalar decay per head::

    S_t = a_t S_{t-1} + x_t B_t^T,    y_t = S_t C_t

in the reference's three forms (``ssd_sequential``, ``ssd_chunked`` with
the log-decay clamped at ``_MIN_LOGW``, ``ssd_decode_step``), fp32 state
``(B, H, Dh, N)``, in plain PyTorch on every device: the reference computes
them in jnp (it has no Pallas SSD), and so does the port.

A2Q attaches to every projection (r/k/v/g/o, the channel-mix's k/v, the
mamba heads' in/bc/dt/out projections); the recurrences have no frozen
weight vector to bound.  With a cache the layers update the slot's
recurrent leaves (``tm.S``, ``tm.shift``, ``cm.shift``, ``mamba.S``) in
place, as the attention layers write their pools: the reference returns
new leaves instead.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import QuantConfig, SSMConfig
from repro_torch.dist.sharding import even_shards, local_as, merge_last, split_last
from repro_torch.kernels._guard import plain_version
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
    "ssd_sequential",
    "ssd_chunked",
    "ssd_decode_step",
    "init_mamba_heads",
    "init_mamba_state",
    "apply_mamba_heads",
]

_MIN_LOGW = -8.0
f32 = torch.float32  # the recurrence's and the groupnorm's dtype


# ---------------------------------------------------------------------------
# RWKV-6 recurrence (the CPU forms)
# ---------------------------------------------------------------------------


@plain_version(under_autograd=True)
def rwkv6_decode_step(r, k, v, w, u, S):
    """One token: r/k/w ``(B, H, Dk)``, v ``(B, H, Dv)``, u ``(H, Dk)``, S
    ``(B, H, Dk, Dv)``.  Returns (y ``(B, H, Dv)`` fp32, the new S)."""
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, S + u[None, :, :, None] * kv)
    return y, w[..., :, None] * S + kv


@plain_version(under_autograd=True)
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


@plain_version(under_autograd=True)
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
    -> chunked, else sequential.  On CUDA (and on fake tensors: the
    dry-run's trace) every branch is the scan kernel (the chunked branches
    with the decay floored at ``exp(_MIN_LOGW)``; on DTensors over each
    rank's shards, ``_recurrence_sharded``), the state written over
    ``state["S"]`` in place; on the CPU, and on any
    device when autograd records an input (training), the branch's own
    form, copied into ``state["S"]``.  Returns y ``(B, H, T, Dv)``."""
    T = r.shape[2]
    if state is None:
        if T % ssm.chunk:
            raise ValueError(f"a cacheless rwkv6 forward takes the chunked form: T={T} is not "
                             f"a multiple of the chunk {ssm.chunk}")
        form = "chunked"
    else:
        form = "decode" if T == 1 else "chunked" if T % ssm.chunk == 0 else "sequential"
    if isinstance(r, DTensor):
        return _recurrence_sharded(r, k, v, w, u, ssm, state)
    recorded = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u))
    # the kernel's route on the card, and on fake tensors (a dry-run trace of
    # the card's path, whatever device the fake tensors name)
    if (r.device.type == "cuda" or isinstance(r, FakeTensor)) and not recorded:
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


def _recurrence_sharded(r: DTensor, k, v, w, u, ssm: SSMConfig,
                        state: Optional[dict]) -> DTensor:
    """``_recurrence`` on each rank's local shards (a sharded forward): the
    recurrence is local to a row and a head, so the batch (dim 0) and the
    heads (dim 1) keep their even split and anything else is gathered; ``u`` and
    the carried ``S`` follow the heads' split (``S`` written in place when
    its placement is already that one, else through its redistribution).
    Differentiable: the gradients come back through DTensor."""
    mesh = r.device_mesh
    pl = even_shards(r, (0, 1))
    r_l, k_l, v_l, w_l = (local_as(t, mesh, pl) for t in (r, k, v, w))
    # u is shared by the batch: where the rows split, each rank's gradient
    # of u is its rows' part, a partial sum over that mesh dim
    u_pl = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
    u_l = local_as(u, mesh, u_pl, [Partial() if p == Shard(0) else q for p, q in zip(pl, u_pl)])
    S = None if state is None else state["S"]
    S_l = None if S is None else local_as(S, mesh, pl)  # S's own local tensor when so placed
    y = _recurrence(r_l, k_l, v_l, w_l, u_l, ssm, None if S is None else {"S": S_l})
    if isinstance(S, DTensor) and list(S.placements) != pl:
        S.copy_(DTensor.from_local(S_l, mesh, pl, run_check=False).redistribute(
            mesh, S.placements))
    return DTensor.from_local(y, mesh, pl, run_check=False)


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
        return split_last(t, H, Dk).transpose(1, 2)

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
    y = (merge_last(yf, D) * params["ln_scale"].to(f32)).to(compute_dtype)
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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (scalar per-head decay) for hymba's mamba heads
# ---------------------------------------------------------------------------


def ssd_decode_step(x, a, Bm, Cm, S):
    """One token: x ``(B, H, Dh)`` (the step size folded in), a ``(B, H)``,
    Bm/Cm ``(B, H, N)``, S ``(B, H, Dh, N)``.  Returns (y ``(B, H, Dh)``
    fp32, the new S)."""
    x, a, Bm, Cm = (t.to(f32) for t in (x, a, Bm, Cm))
    S = a[..., None, None] * S + x[..., :, None] * Bm[..., None, :]
    return torch.einsum("bhdn,bhn->bhd", S, Cm), S


def ssd_sequential(x, a, Bm, Cm, S0):
    """Oracle: step-by-step scan.  x ``(B, H, T, Dh)``, a ``(B, H, T)`` decays
    in (0, 1], Bm/Cm ``(B, H, T, N)``, S0 ``(B, H, Dh, N)``.  Returns (y
    ``(B, H, T, Dh)`` in ``x``'s dtype, S_T)."""
    S = S0.to(f32)
    ys = []
    for t in range(x.shape[2]):
        y, S = ssd_decode_step(x[:, :, t], a[:, :, t], Bm[:, :, t], Cm[:, :, t], S)
        ys.append(y)
    return torch.stack(ys, 2).to(x.dtype), S


def ssd_chunked(x, a, Bm, Cm, S0, chunk: int = 32):
    """Chunked parallel form (Mamba-2): the scalar decay factorizes the
    intra-chunk term into ``(C B^T) * decay``, two matmuls and one masked
    matmul a chunk; the oracle's semantics up to the log-decay clamp at
    ``_MIN_LOGW``."""
    B, H, T, Dh = x.shape
    N = Bm.shape[-1]
    if T % chunk:
        raise ValueError(f"ssd_chunked: T={T} is not a multiple of the chunk {chunk}")
    nc = T // chunk
    loga = torch.clamp_min(torch.log(torch.clamp_min(a.to(f32), 1e-30)), _MIN_LOGW)
    xc = x.reshape(B, H, nc, chunk, Dh).to(f32)
    lc = loga.reshape(B, H, nc, chunk)
    bc = Bm.reshape(B, H, nc, chunk, N).to(f32)
    cc = Cm.reshape(B, H, nc, chunk, N).to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=x.device))  # with the diagonal
    S = S0.to(f32)
    ys = []
    for c in range(nc):
        x_c, la, b_c, c_c = xc[:, :, c], lc[:, :, c], bc[:, :, c], cc[:, :, c]
        logA = torch.cumsum(la, dim=2)  # inclusive: S_t includes the t-th update
        c_in = c_c * torch.exp(logA)[..., None]
        b_in = b_c * torch.exp(-logA)[..., None]
        y = torch.einsum("bhln,bhdn->bhld", c_in, S)  # inter-chunk
        att = torch.einsum("bhln,bhmn->bhlm", c_in, b_in)
        y = y + torch.einsum("bhlm,bhmd->bhld", att * tri, x_c)
        b_out = b_c * torch.exp(logA[:, :, -1:] - logA)[..., None]
        S = torch.exp(logA[:, :, -1])[..., None, None] * S + torch.einsum(
            "bhld,bhln->bhdn", x_c, b_out)
        ys.append(y)
    y = torch.stack(ys, 2).reshape(B, H, T, Dh)
    return y.to(x.dtype), S


def init_mamba_heads(gen: torch.Generator, d_model: int, ssm: SSMConfig, q: QuantConfig) -> dict:
    H = d_model // ssm.head_dim
    N = ssm.state_dim
    dev = gen.device
    return {
        "in_proj": init_linear(gen, d_model, 2 * d_model, q),
        "bc_proj": init_linear(gen, d_model, 2 * H * N, q),
        "dt_proj": init_linear(gen, d_model, H, q),
        "A_log": torch.zeros((H,), device=dev),
        "D": torch.ones((H, ssm.head_dim), device=dev),
        "out_proj": init_linear(gen, d_model, d_model, q),
        "dt_bias": torch.full((H,), -4.6, device=dev),  # softplus ~ 0.01
    }


def init_mamba_state(d_model: int, ssm: SSMConfig, count: int, rows: int, device) -> dict:
    """The mamba heads' cache leaf of ``count`` stacked layers: the fp32 SSD
    state ``S (count, rows, H, Dh, N)``, zeros (rows are batch rows or serving
    slots)."""
    H = d_model // ssm.head_dim
    return {"S": torch.zeros((count, rows, H, ssm.head_dim, ssm.state_dim), dtype=f32,
                             device=device)}


def _ssd(x, a, Bm, Cm, ssm: SSMConfig, state: Optional[dict]):
    """The reference's dispatch on T: no state -> chunked (``T % chunk``
    must hold), ``T == 1`` -> the decode step, ``T % chunk == 0`` ->
    chunked, else sequential; the new state copied into ``state["S"]``.
    Returns y ``(B, H, T, Dh)`` fp32."""
    T = x.shape[2]
    if state is None:
        if T % ssm.chunk:
            raise ValueError(f"a cacheless mamba forward takes the chunked form: T={T} is not a "
                             f"multiple of the chunk {ssm.chunk}")
        S0 = x.new_zeros((x.shape[0], x.shape[1], x.shape[3], Bm.shape[3]), dtype=f32)
        return ssd_chunked(x, a, Bm, Cm, S0, chunk=ssm.chunk)[0]
    if T == 1:
        y, S = ssd_decode_step(x[:, :, 0], a[:, :, 0], Bm[:, :, 0], Cm[:, :, 0], state["S"])
        y = y[:, :, None]
    elif T % ssm.chunk == 0:
        y, S = ssd_chunked(x, a, Bm, Cm, state["S"], chunk=ssm.chunk)
    else:
        y, S = ssd_sequential(x, a, Bm, Cm, state["S"])
    state["S"].copy_(S)
    return y


def apply_mamba_heads(params: dict, x: torch.Tensor, ssm: SSMConfig, q: QuantConfig,
                      state: Optional[dict] = None, *, compute_dtype=torch.bfloat16,
                      int_forward: bool = False, int_chain: bool = False):
    """``state = {"S": (B, H, Dh, N) fp32}`` for a cached step (updated in
    place and returned), ``None`` for a cacheless forward.  All four
    projections are chain breaks (the SSD core and the silu gate need float
    values), so under ``int_chain`` each folds its act-quant into the
    kernel's prologue."""
    D = x.shape[-1]

    def lin(name, xi):
        return apply_linear(params[name], xi, q, compute_dtype=compute_dtype,
                            int_forward=int_forward, int_chain=int_chain, site=f"mamba.{name}")

    xz = lin("in_proj", x)
    xin, z = xz[..., :D], xz[..., D:]
    bc = lin("bc_proj", x).to(f32)  # (B, T, H * 2N)
    dt = F.softplus(lin("dt_proj", x).to(f32) + params["dt_bias"].to(f32))  # (B, T, H)
    heads = _heads_sharded if isinstance(dt, DTensor) else _heads
    y = heads(xin.to(f32), bc, dt, params["A_log"], params["D"], ssm, state).to(compute_dtype)
    y = y * F.silu(z.to(f32)).to(compute_dtype)
    return lin("out_proj", y), state


def _heads(xin, bc, dt, A_log, D, ssm: SSMConfig, state: Optional[dict]):
    """The mixer's per-head part: xin ``(B, T, H * Dh)``, bc ``(B, T, H *
    2N)``, dt ``(B, T, H)`` fp32, A_log ``(H,)``, D ``(H, Dh)``; the SSD and
    the skip.  Returns y ``(B, T, H * Dh)`` fp32."""
    B, T, H = dt.shape
    Dh, N = ssm.head_dim, ssm.state_dim
    bc = bc.reshape(B, T, H, 2 * N)
    Bm, Cm = bc[..., :N].transpose(1, 2), bc[..., N:].transpose(1, 2)
    A = -torch.exp(A_log.to(f32))  # (H,), negative
    a = torch.exp(dt * A).transpose(1, 2)  # (B, H, T) decays in (0, 1)
    xh = xin.reshape(B, T, H, Dh).transpose(1, 2)
    xh = xh * dt.transpose(1, 2)[..., None]  # the step size folded into the input
    y = _ssd(xh, a, Bm, Cm, ssm, state)
    y = y + D.to(f32)[None, :, None, :] * xh
    return y.transpose(1, 2).reshape(B, T, H * Dh)


def _heads_sharded(xin, bc, dt: DTensor, A_log, D, ssm: SSMConfig,
                   state: Optional[dict]) -> DTensor:
    """``_heads`` on each rank's local shards (a sharded forward), as
    ``_recurrence_sharded``: the SSD is local to a row and a head, so the
    rows (dim 0) and the heads (dt's dim 2, whole heads of xin and bc) keep
    their even split and anything else is gathered; A_log and D follow the
    heads (their gradient a partial sum where the rows split), the carried
    ``S (B, H, Dh, N)`` the rows and the heads.  (DTensor's own ops on the
    transposed head views hand back gradients whose local strides differ
    from the global ones they claim, which a later view refuses.)"""
    mesh = dt.device_mesh
    pl = even_shards(dt, (0, 2))
    x_l, bc_l, dt_l = (local_as(t, mesh, pl) for t in (xin, bc, dt))
    h_pl = [Shard(0) if p == Shard(2) else Replicate() for p in pl]
    grads = [Partial() if p == Shard(0) else q for p, q in zip(pl, h_pl)]
    A_l, D_l = (local_as(t, mesh, h_pl, grads) for t in (A_log, D))
    S = None if state is None else state["S"]
    s_pl = [Shard(1) if p == Shard(2) else p for p in pl]
    S_l = None if S is None else local_as(S, mesh, s_pl)
    y = _heads(x_l, bc_l, dt_l, A_l, D_l, ssm, None if S is None else {"S": S_l})
    if isinstance(S, DTensor) and list(S.placements) != s_pl:
        S.copy_(DTensor.from_local(S_l, mesh, s_pl, run_check=False).redistribute(
            mesh, S.placements))
    return DTensor.from_local(y, mesh, pl, run_check=False)
