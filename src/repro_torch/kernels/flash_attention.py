"""Blocked online-softmax attention: the CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.flash_attention``
(``flash_attention_kernel`` / ``flash_attention_pallas``): softmax attention
of ``(B, H, Tq, D)`` queries over ``(B, KV, Tk, D)`` keys and values with an
fp32 softmax, queries aligned to the end of the keys (``qpos = i + Tk -
Tq``), an optional causal mask (``kpos <= qpos``) and sliding window
(``kpos > qpos - window``); a query with no kept key gives 0, as the TPU
kernel's flush does.  Query head ``h`` reads KV head ``h // (H // KV)``
(grouped-query attention by index: the reference's wrapper takes KV heads
already repeated).  The output is in ``q``'s dtype.  The CUDA kernel takes
strided head views and writes ``(B, Tq, H, D)``, returned as its ``(B, H,
Tq, D)`` view.  ``kernels/ops.flash_attention`` picks a version by the
tensors' device.  On the card, bf16 views whose pointers and strides are
multiples of 16 bytes run on the bf16 tensor cores; fp32 (and unaligned
bf16 views) on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels._guard import plain_version
from repro_torch.kernels.ref import flash_keep_mask

__all__ = ["HEAD_DIMS", "flash_attention_plain", "flash_attention_cuda"]

HEAD_DIMS = (16, 32, 64, 80, 128)  # the kernel's instantiated head sizes


@plain_version
def flash_attention_plain(q, k, v, *, causal: bool, window: Optional[int], scale: float,
                          q_chunk: Optional[int] = None):
    """``ref_flash_attention``'s dense fp32 softmax on the KV heads indexed,
    with 0 for a query that keeps no key (the oracle's softmax gives NaN
    there), on any device; ``q_chunk`` queries at a time when given, so the
    scores take ``(B, H, q_chunk, Tk)``."""
    Tq, Tk = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(group, 1)
    vf = v.to(torch.float32).repeat_interleave(group, 1)
    keep = flash_keep_mask(Tq, Tk, causal, window, q.device)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    step = q_chunk or max(Tq, 1)
    for lo in range(0, Tq, step):
        m = keep[lo:lo + step]
        scores = torch.einsum("bhqd,bhkd->bhqk", q[:, :, lo:lo + step].to(torch.float32) * scale,
                              kf)
        probs = torch.softmax(torch.where(m, scores, torch.full_like(scores, -math.inf)), dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
        out[:, :, lo:lo + step] = torch.where(m.any(-1)[:, None], o, 0.0)
    return out.to(q.dtype)


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool, window: Optional[int], scale: float):
    """Launch the CUDA kernel on the current stream.  ``q (B, H, Tq, D)`` and
    ``k, v (B, KV, Tk, D)`` are fp32 or bf16 (one dtype) on one CUDA device,
    strided views with a contiguous last axis (the head views of ``(B, T,
    H * D)`` projections); ``H`` a multiple of ``KV``, ``D`` in
    ``HEAD_DIMS``.  The output is allocated ``(B, Tq, H, D)`` and returned as
    its ``(B, H, Tq, D)`` view.  bf16 views whose pointers and (batch,
    time, head) strides are multiples of 16 bytes run the tensor-core
    kernel, everything else the CUDA-core one.  Every launch adds one to
    ``flash_attention_cuda.launches``, one on the tensor cores also to
    ``flash_attention_cuda.tc_launches``."""
    B, H, Tq, D = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: q, k, v fp32 or bf16 (one dtype) expected, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention_cuda: {H} query heads do not group over {KV} KV heads")
    for name, t, shape in (("q", q, (B, H, Tq, D)), ("k", k, (B, KV, Tk, D)),
                           ("v", v, (B, KV, Tk, D))):
        if tuple(t.shape) != shape or t.device != dev or (t.numel() and t.stride(-1) != 1):
            raise ValueError(f"flash_attention_cuda: {name} must be {shape} on {dev} with a "
                             f"contiguous last axis, got {tuple(t.shape)} strides {t.stride()} "
                             f"on {t.device}")
    if window is not None and window < 1:
        raise ValueError("flash_attention_cuda: window must be >= 1")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out.permute(0, 2, 1, 3)
    # (batch, time, head) strides of each (B, heads, T, D) view
    strides = (ctypes.c_longlong * 9)(*(s for t in (q, k, v)
                                        for s in (t.stride(0), t.stride(2), t.stride(1))))
    bf16 = q.dtype == torch.bfloat16
    tc = bf16 and all(t.data_ptr() % 16 == 0 for t in (q, k, v)) and all(s % 8 == 0 for s in strides)
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H, KV, Tq, Tk, D, strides, float(scale), int(causal),
            0 if window is None else int(window), int(bf16), int(tc), ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.tc_launches += tc
    return out.permute(0, 2, 1, 3)


flash_attention_cuda.launches = 0
flash_attention_cuda.tc_launches = 0
