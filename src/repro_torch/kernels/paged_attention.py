"""Paged-attention decode: the CUDA kernel (``csrc/paged_attention.cu``) and
its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.paged_attention``
(``paged_attention_kernel`` / ``paged_attention_pallas``) for fp32 and bf16
pools: one query token per row against ``(NB, bs, KV, Dh)`` K/V pools read
through the block table, fp32 online softmax, keys valid iff ``kpos <
length`` (and ``kpos >= length - window`` with a window), zero rows for
length 0.  The int8 and packed-int4 pools (``kps``/``vps``) are not ported
yet.  ``kernels/ops.paged_attention`` picks a version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import ref_paged_attention

__all__ = ["paged_attention_plain", "paged_attention_cuda"]

# The plain version is the oracle itself: the gathered contiguous view and a
# dense fp32 softmax over it.
paged_attention_plain = ref_paged_attention

_FLOATS = (torch.float32, torch.bfloat16)


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def paged_attention_cuda(q, kp, vp, bt, lengths, scale: Optional[float] = None,
                         window: Optional[int] = None):
    """Launch the CUDA kernel on the current stream.  ``q (B, H, Dh)`` fp32 or
    bf16; pools ``(NB, bs, KV, Dh)`` of one fp32 or bf16 dtype; ``bt (B, MB)``
    and ``lengths (B,)`` int32; all contiguous on one CUDA device, with
    ``H % KV == 0``.  Returns ``(B, H, Dh)`` in ``q``'s dtype.  Every launch
    adds one to ``paged_attention_cuda.launches``."""
    B, H, Dh = q.shape
    NB, bs, KV, Dhp = kp.shape
    MB = bt.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _FLOATS or kp.dtype not in _FLOATS or vp.dtype != kp.dtype:
        raise ValueError(f"paged_attention_cuda: q and pools must be fp32 or bf16 "
                         f"(pools alike), got {q.dtype}, {kp.dtype}, {vp.dtype}")
    if Dhp != Dh or tuple(vp.shape) != tuple(kp.shape) or H % KV:
        raise ValueError(f"paged_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)} do not match")
    if tuple(bt.shape) != (B, MB) or tuple(lengths.shape) != (B,) or \
            bt.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_cuda: bt (B, MB) and lengths (B,) must be int32")
    for name, t in (("q", q), ("kp", kp), ("vp", vp), ("bt", bt), ("lengths", lengths)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"paged_attention_cuda: {name} must be contiguous on {dev}")
    if scale is None:
        scale = Dh**-0.5
    out = torch.empty_like(q)
    if B == 0:
        return out
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(kp.data_ptr()),
            ctypes.c_void_p(vp.data_ptr()), ctypes.c_void_p(bt.data_ptr()),
            ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H, KV, Dh, bs, MB, float(scale), window or 0,
            int(q.dtype == torch.bfloat16), int(kp.dtype == torch.bfloat16),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
