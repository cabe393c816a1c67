"""RWKV-6 (Finch) recurrence: the CUDA kernels (``csrc/rwkv6_scan.cu``) and
their plain PyTorch versions.

Port of the Pallas kernel ``repro.kernels.rwkv6_scan`` (``rwkv6_scan_kernel``
/ ``rwkv6_scan_pallas``).  Per (batch, head), step by step in fp32::

    y_t = r_t @ (S + (u * k_t) v_t^T)
    S   = diag(w_t) S + k_t v_t^T

over ``(B, H, T, D)`` tensors with the head bonus ``u (H, Dk)`` shared by
the batch.  The TPU kernel walks T in chunks on a sequential grid axis with
the state in VMEM scratch.  On the card, T below ``CHUNK_MIN_T`` (decode)
goes to the step kernel, one block per (batch, head) walking every step
with the state in registers; longer T to the chunked kernel, Finch's matrix
form 16 tokens (``CHUNK_L``) at a time on the bf16 tensor cores, T cut into
up to 8 segments a head (``chunk_split``) joined in a thread-block cluster.
``rwkv6_scan_subchunk_plain`` is that kernel's algorithm in plain PyTorch.
``min_w`` floors the decay (the chunked form clamps its log at -8);
``out_dtype`` picks y's dtype (the decode step keeps fp32); ``state_out``
receives S_T and may be the initial state itself (updated in place).
``kernels/ops.rwkv6_scan`` picks a version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._guard import plain_version

__all__ = ["MAX_HEAD_DIM", "CHUNK_L", "CHUNK_MIN_T", "chunk_split", "rwkv6_scan_plain",
           "rwkv6_scan_subchunk_plain", "rwkv6_scan_cuda"]

MAX_HEAD_DIM = 64  # the kernels' Dk, Dv limit: one state column per thread of a row group
CHUNK_L = 16  # the chunked kernel's sub-chunk: the m16 of mma.sync
# T from which the chunked kernel runs; below it the step kernel (decode):
# on an H100 at B=1, H=64, D=64 the step kernel takes 0.00681 ms at T=9 and
# the chunked one 0.00704; at T=10 0.00735 against 0.00707.
CHUNK_MIN_T = 10
MAX_SEGMENTS = 8  # a head's segments are one thread-block cluster (the portable size)
NUM_SMS = 132  # the H100's streaming multiprocessors


def chunk_split(B: int, H: int, T: int) -> tuple[int, int]:
    """``(segments, tokens a segment)`` of the chunked kernel for ``(B, H,
    T)``: T cut into whole sub-chunks, as many segments a head as keep every
    block on an SM of its own (a block fills its SM's issue slots), at most
    ``MAX_SEGMENTS``, each at least 32 tokens; none is empty.  On an H100 at
    B=1, H=64 two segments beat one from T=64 to T=1024 (0.0165 against
    0.0189 ms at T=64, 0.088 against 0.115 at T=512), and 4 or 8 (two or
    more blocks an SM) lose there; at T=4096 8 segments take 0.630 ms and 2
    take 0.654."""
    return _runs(T, max(1, min(MAX_SEGMENTS, NUM_SMS // max(B * H, 1), T // 32)))


def _runs(T: int, n: int) -> tuple[int, int]:
    """T in at most ``n`` runs of whole sub-chunks, none empty: ``(runs,
    tokens a run)``."""
    seg = -(-max(T, 1) // n)
    seg = -(-seg // CHUNK_L) * CHUNK_L
    return -(-max(T, 1) // seg), seg


@plain_version
def rwkv6_scan_plain(r, k, v, w, u, s0=None, *, out_dtype, min_w: Optional[float] = None,
                     state_out: Optional[torch.Tensor] = None):
    """The recurrence step by step in fp32, on any device: ``r, k, w (B, H,
    T, Dk)``, ``v (B, H, T, Dv)``, ``u (H, Dk)``, ``s0 (B, H, Dk, Dv)`` or
    ``None`` (zeros).  Returns ``(y (B, H, T, Dv) in out_dtype, S_T)``, S_T
    written into ``state_out`` when given."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    S = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    w = w.to(f32) if min_w is None else w.to(f32).clamp_min(min_w)
    u = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(T):
        r_t, k_t, v_t = (a[:, :, t].to(f32) for a in (r, k, v))
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, S + u * kv))
        S = w[:, :, t, :, None] * S + kv
    y = (torch.stack(ys, 2) if ys else torch.zeros((B, H, 0, Dv), device=r.device)).to(out_dtype)
    if state_out is not None:
        S = state_out.copy_(S)
    return y, S


def _bf16_terms_mm(a, b):
    """``a @ b`` as the kernel's tensor cores take it: ``a`` (the computed
    operand: r 2^c-, the pair scores, k 2^(c_L - c)) in bf16 hi + mid + lo,
    ``b`` (the state, v) in hi + lo, the five products above 2^-24 of the
    whole summed in fp32."""
    def split(x, n):
        parts = []
        for _ in range(n):
            parts.append(x.to(torch.bfloat16).to(torch.float32))
            x = x - parts[-1]
        return parts

    (ah, am, al), (bh, bl) = split(a, 3), split(b, 2)
    return ah @ bh + ah @ bl + am @ bh + am @ bl + al @ bh


def _two_sum_cumsum(x):
    """The inclusive cumsum of ``x (..., n, D)`` along n in fp32 as hi + lo
    (Knuth's two-sum a step): a difference of two such sums keeps fp32's
    precision after a term of -99.7 (w = 0), where plain fp32 sums lose ~7
    bits to the cancellation."""
    hi = torch.zeros_like(x[..., 0, :])
    lo = torch.zeros_like(hi)
    his, los = [], []
    for i in range(x.shape[-2]):
        t = x[..., i, :]
        s = hi + t
        bb = s - hi
        lo = lo + ((hi - (s - bb)) + (t - bb))
        hi = s
        his.append(hi)
        los.append(lo)
    return torch.stack(his, -2), torch.stack(los, -2)


@plain_version
def rwkv6_scan_subchunk_plain(r, k, v, w, u, s0=None, *, out_dtype,
                              min_w: Optional[float] = None,
                              state_out: Optional[torch.Tensor] = None,
                              segments: Optional[int] = None, bf16_terms: bool = False):
    """The chunked kernel's algorithm in plain PyTorch, on any device (the
    arguments and result of ``rwkv6_scan_plain``).  Per sub-chunk of
    ``CHUNK_L`` tokens and channel, ``lw = log2(max(max(w, min_w), 1e-30))``,
    its inclusive cumsum ``c`` and the exclusive one ``c-`` (the running sum
    before each term, each as an fp32 hi + lo pair, differences taken part
    by part), then::

        y_i = (r_i 2^c-_i) S + sum_{j<i} (sum_d r_i k_j 2^(c-_i - c_j)) v_j
              + (r_i . (u k_i)) v_i
        S   = diag(2^c_L) S + (k 2^(c_L - c))^T v

    T is cut into ``segments`` runs of whole sub-chunks (default
    ``chunk_split``): every run but the last is scanned from a zero state
    for its state alone and its decay product ``2^sum(c_L)``, each run's
    start state is the earlier runs' combined in order from ``s0``, and each
    run is scanned again from it with the outputs.  The products are fp32,
    or with ``bf16_terms`` the kernel's three bf16 products."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    mm = _bf16_terms_mm if bf16_terms else torch.matmul
    n_seg, seg_len = chunk_split(B, H, T) if segments is None else _runs(T, segments)
    w = w.to(f32) if min_w is None else w.to(f32).clamp_min(min_w)
    lw = torch.log2(w.clamp_min(1e-30))
    r, k, v = (t.to(f32) for t in (r, k, v))
    ub = u.to(f32)[None, :, None, :]
    tri = torch.tril(torch.ones((CHUNK_L, CHUNK_L), dtype=torch.bool, device=r.device), -1)

    def scan(S, lo, hi, out):
        ys, ctot = [], torch.zeros((B, H, Dk), dtype=f32, device=r.device)
        for t0 in range(lo, hi, CHUNK_L):
            t1 = min(t0 + CHUNK_L, hi)
            n = t1 - t0
            r_c, k_c, v_c = r[:, :, t0:t1], k[:, :, t0:t1], v[:, :, t0:t1]
            c_hi, c_lo = _two_sum_cumsum(lw[:, :, t0:t1])
            z = torch.zeros_like(c_hi[:, :, :1])
            x_hi, x_lo = torch.cat([z, c_hi[:, :, :-1]], 2), torch.cat([z, c_lo[:, :, :-1]], 2)
            l_hi, l_lo = c_hi[:, :, -1:], c_lo[:, :, -1:]
            ctot = ctot + (l_hi + l_lo)[:, :, 0]
            if out:
                y = mm(r_c * torch.exp2(x_hi + x_lo), S)
                expo = (x_hi[:, :, :, None] - c_hi[:, :, None]) + \
                    (x_lo[:, :, :, None] - c_lo[:, :, None])  # (B, H, i, j, Dk)
                expo = torch.where(tri[:n, :n, None], expo, float("-inf"))  # every kept one <= 0
                score = torch.einsum("bhid,bhjd,bhijd->bhij", r_c, k_c, torch.exp2(expo))
                score = score + torch.diag_embed((r_c * ub * k_c).sum(-1))
                ys.append(y + mm(score, v_c))
            kd = k_c * torch.exp2((l_hi - c_hi) + (l_lo - c_lo))
            S = torch.exp2(l_hi + l_lo)[:, :, 0, :, None] * S + mm(kd.transpose(-1, -2), v_c)
        return S, ys, ctot

    S0 = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=r.device) if s0 is None
          else s0.to(f32))
    bounds = [(i * seg_len, min((i + 1) * seg_len, T)) for i in range(n_seg)]
    starts, S = [S0], S0
    for lo, hi in bounds[:-1]:  # pass 1 and the in-order combine
        S_loc, _, ctot = scan(torch.zeros_like(S0), lo, hi, False)
        S = torch.exp2(ctot)[..., None] * S + S_loc
        starts.append(S)
    ys = []
    for (lo, hi), S in zip(bounds, starts):  # pass 2
        S, y, _ = scan(S, lo, hi, True)
        ys += y
    y = (torch.cat(ys, 2) if ys else torch.zeros((B, H, 0, Dv), device=r.device)).to(out_dtype)
    if state_out is not None:
        S = state_out.copy_(S)
    return y, S


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    lib = load("rwkv6_scan")
    head = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_int]
    step, chunked = lib.rwkv6_scan_launch, lib.rwkv6_chunk_launch
    step.argtypes = head + [ctypes.c_void_p]
    chunked.argtypes = head + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    step.restype = chunked.restype = ctypes.c_int
    return step, chunked


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _rows16(*tensors) -> bool:
    """Whether every row of the tensors starts 16-byte aligned and is a
    multiple of 16 bytes wide: the chunked kernel then copies them
    asynchronously (else element by element)."""
    return all(t.data_ptr() % 16 == 0 and (t.shape[-1] * t.element_size()) % 16 == 0
               and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
               for t in tensors)


def rwkv6_scan_cuda(r, k, v, w, u, s0=None, *, out_dtype, min_w: Optional[float] = None,
                    state_out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream.  ``r, k, v`` are fp32 or
    bf16 (one dtype), ``w`` and ``u`` fp32, on one CUDA device; ``r, k, v,
    w`` may be strided views with a contiguous last axis (the head views of
    ``(B, T, D)`` projections); ``u (H, Dk)`` and the fp32 states ``(B, H,
    Dk, Dv)`` are contiguous; ``Dk, Dv <= 64``; decays in [0, 1].  y is
    allocated ``(B, T, H, Dv)`` and returned as its ``(B, H, T, Dv)`` view,
    so the caller's merge of the heads is free.  T below ``CHUNK_MIN_T``
    runs the step kernel, longer T the chunked one, split by
    ``chunk_split``.  Every launch adds one to ``rwkv6_scan_cuda.launches``,
    and each of the chunked kernel to ``rwkv6_scan_cuda.chunked_launches``
    too.  A failed launch raises; nothing falls back."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan_cuda needs CUDA tensors, got {dev}")
    if r.dtype not in (torch.float32, torch.bfloat16) or k.dtype != r.dtype or \
            v.dtype != r.dtype or w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan_cuda: r, k, v fp32 or bf16 (one dtype) and fp32 w, u "
                         f"expected, got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}, {u.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rwkv6_scan_cuda: y is fp32 or bf16, not {out_dtype}")
    if Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan_cuda: head dims Dk={Dk}, Dv={Dv} above {MAX_HEAD_DIM}")
    for name, t, shape in (("r", r, (B, H, T, Dk)), ("k", k, (B, H, T, Dk)),
                           ("v", v, (B, H, T, Dv)), ("w", w, (B, H, T, Dk))):
        if tuple(t.shape) != shape or t.device != dev or (t.numel() and t.stride(-1) != 1):
            raise ValueError(f"rwkv6_scan_cuda: {name} must be {shape} on {dev} with a "
                             f"contiguous last axis, got {tuple(t.shape)} strides {t.stride()} "
                             f"on {t.device}")
    for name, t, shape in (("u", u, (H, Dk)), ("initial_state", s0, (B, H, Dk, Dv)),
                           ("state_out", state_out, (B, H, Dk, Dv))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"rwkv6_scan_cuda: {name} must be a contiguous fp32 {shape} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    y = torch.empty((B, T, H, Dv), dtype=out_dtype, device=dev).permute(0, 2, 1, 3)
    sT = state_out if state_out is not None else torch.empty((B, H, Dk, Dv), device=dev)
    if B * H == 0:
        return y, sT
    strides = (ctypes.c_longlong * 15)(*(s for t in (r, k, v, w, y) for s in t.stride()[:3]))
    step, chunked = _bind()
    chunk = T >= CHUNK_MIN_T
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        args = (_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s0), _ptr(sT), _ptr(y),
                B, H, T, Dk, Dv, strides, float("-inf") if min_w is None else float(min_w),
                int(r.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
        err = chunked(*args, *chunk_split(B, H, T), int(_rows16(r, k, v, w)), stream) if chunk \
            else step(*args, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan {'chunked' if chunk else 'step'} kernel launch failed: "
                           f"cudaError {err}")
    rwkv6_scan_cuda.launches += 1
    rwkv6_scan_cuda.chunked_launches += chunk
    return y, sT


rwkv6_scan_cuda.launches = 0
rwkv6_scan_cuda.chunked_launches = 0
