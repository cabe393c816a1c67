"""Paged-attention decode: the CUDA kernel (``csrc/paged_attention.cu``) and
its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.paged_attention``
(``paged_attention_kernel`` / ``paged_attention_pallas``): one query token
per row against ``(NB, bs, KV, Dh)`` K/V pools read through the block table,
fp32 online softmax, keys valid iff ``kpos < length`` (and ``kpos >= length -
window`` with a window), zero rows for length 0.  Pools are fp32, bf16, int8
codes, or packed int4 (uint8 at ``Dh // 2``); the integer pools come with
fp32 per-slot scale pools ``kps``/``vps`` ``(NB, bs, KV)`` and are
dequantized (code times scale) before the dot, as
``ref.ref_paged_attention_q8``/``_q4`` do.  ``kernels/ops.paged_attention``
picks a version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import (
    ref_paged_attention,
    ref_paged_attention_q4,
    ref_paged_attention_q8,
)

__all__ = ["paged_attention_plain", "paged_attention_cuda"]

_FLOATS = (torch.float32, torch.bfloat16)
_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}


def paged_attention_plain(q, kp, vp, bt, lengths, kps=None, vps=None,
                          scale: Optional[float] = None, window: Optional[int] = None):
    """The plain version is the oracle itself: the gathered contiguous view
    (dequantized for int8 / packed-int4 pools) and a dense fp32 softmax."""
    if kps is None:
        return ref_paged_attention(q, kp, vp, bt, lengths, scale=scale, window=window)
    oracle = ref_paged_attention_q4 if kp.dtype == torch.uint8 else ref_paged_attention_q8
    return oracle(q, kp, vp, kps, vps, bt, lengths, scale=scale, window=window)


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def paged_attention_cuda(q, kp, vp, bt, lengths, kps=None, vps=None,
                         scale: Optional[float] = None, window: Optional[int] = None):
    """Launch the CUDA kernel on the current stream.  ``q (B, H, Dh)`` fp32 or
    bf16; pools ``(NB, bs, KV, Dh)`` of one dtype: fp32, bf16, int8 codes,
    or packed int4 (uint8, ``(NB, bs, KV, Dh // 2)``), the integer pools with
    fp32 scale pools ``kps``/``vps`` ``(NB, bs, KV)``; ``bt (B, MB)`` and
    ``lengths (B,)`` int32; all contiguous on one CUDA device, with
    ``H % KV == 0``.  Returns ``(B, H, Dh)`` in ``q``'s dtype.  Every launch
    adds one to ``paged_attention_cuda.launches``."""
    B, H, Dh = q.shape
    NB, bs, KV, Dhp = kp.shape
    MB = bt.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _FLOATS or kp.dtype not in _POOL_KIND or vp.dtype != kp.dtype:
        raise ValueError(f"paged_attention_cuda: q must be fp32 or bf16 and the pools one of "
                         f"fp32, bf16, int8, uint8 (alike), got {q.dtype}, {kp.dtype}, {vp.dtype}")
    quant = kp.dtype in (torch.int8, torch.uint8)
    if quant != (kps is not None) or (kps is None) != (vps is None):
        raise ValueError("paged_attention_cuda: integer pools need kps/vps scale pools, "
                         "float pools take none")
    width = Dh // 2 if kp.dtype == torch.uint8 else Dh
    if (kp.dtype == torch.uint8 and Dh % 2) or Dhp != width or \
            tuple(vp.shape) != tuple(kp.shape) or H % KV:
        raise ValueError(f"paged_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)} do not match")
    if tuple(bt.shape) != (B, MB) or tuple(lengths.shape) != (B,) or \
            bt.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_cuda: bt (B, MB) and lengths (B,) must be int32")
    named = [("q", q), ("kp", kp), ("vp", vp), ("bt", bt), ("lengths", lengths)]
    if quant:
        for name, t in (("kps", kps), ("vps", vps)):
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, bs, KV):
                raise ValueError(f"paged_attention_cuda: {name} must be fp32 {(NB, bs, KV)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            named.append((name, t))
    for name, t in named:
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
            ctypes.c_void_p(vp.data_ptr()),
            ctypes.c_void_p(kps.data_ptr() if quant else 0),
            ctypes.c_void_p(vps.data_ptr() if quant else 0), ctypes.c_void_p(bt.data_ptr()),
            ctypes.c_void_p(lengths.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            B, H, KV, Dh, bs, MB, float(scale), window or 0,
            int(q.dtype == torch.bfloat16), _POOL_KIND[kp.dtype],
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
