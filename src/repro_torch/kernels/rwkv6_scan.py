"""RWKV-6 (Finch) recurrence: the CUDA kernel (``csrc/rwkv6_scan.cu``) and its
plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.rwkv6_scan`` (``rwkv6_scan_kernel``
/ ``rwkv6_scan_pallas``).  Per (batch, head), step by step in fp32::

    y_t = r_t @ (S + (u * k_t) v_t^T)
    S   = diag(w_t) S + k_t v_t^T

over ``(B, H, T, D)`` tensors with the head bonus ``u (H, Dk)`` shared by
the batch.  The TPU kernel walks T in chunks on a sequential grid axis with
the state in VMEM scratch; the CUDA kernel walks all T steps in one block
per (batch, head) with the state in registers.  ``min_w`` floors the decay
(the chunked form clamps its log at -8); ``out_dtype`` picks y's dtype (the
decode step keeps fp32); ``state_out`` receives S_T and may be the initial
state itself (updated in place).  ``kernels/ops.rwkv6_scan`` picks a version
by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["MAX_HEAD_DIM", "rwkv6_scan_plain", "rwkv6_scan_cuda"]

MAX_HEAD_DIM = 64  # the kernel's Dk, Dv limit: one state column per thread of a row group


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


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("rwkv6_scan").rwkv6_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def rwkv6_scan_cuda(r, k, v, w, u, s0=None, *, out_dtype, min_w: Optional[float] = None,
                    state_out: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream.  ``r, k, v`` are fp32 or
    bf16 (one dtype), ``w`` and ``u`` fp32, on one CUDA device; ``r, k, v,
    w`` may be strided views with a contiguous last axis (the head views of
    ``(B, T, D)`` projections); ``u (H, Dk)`` and the fp32 states ``(B, H,
    Dk, Dv)`` are contiguous; ``Dk, Dv <= 64``.  y is allocated ``(B, T, H,
    Dv)`` and returned as its ``(B, H, T, Dv)`` view, so the caller's merge of
    the heads is free.  Every launch adds one to ``rwkv6_scan_cuda.launches``."""
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
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s0), _ptr(sT), _ptr(y),
            B, H, T, Dk, Dv, strides, float("-inf") if min_w is None else float(min_w),
            int(r.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err}")
    rwkv6_scan_cuda.launches += 1
    return y, sT


rwkv6_scan_cuda.launches = 0
