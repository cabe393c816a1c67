"""MLA absorbed-decode latent attention: the CUDA kernel
(``csrc/paged_mla_attention.cu``) and its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.paged_attention``
(``paged_mla_attention_kernel`` / ``paged_mla_attention_pallas``): one query
token per row, the absorbed query ``q_lat (B, H, R)`` and rope query
``q_pe (B, H, P)`` against the shared latent pool ``ckvp (NB, bs, R)`` and
rope-key pool ``kpep (NB, bs, P)`` read through the block table, fp32 online
softmax, keys valid iff ``kpos < length``, zero rows for length 0, and the
optional activation fake-quant of the latent (``aq_scale``/``act_bits``).
Pools are fp32, bf16, int8 codes or packed int4 (uint8 at half the width);
the integer pools come with fp32 per-token scale pools ``ckvs``/``kpes``
``(NB, bs)``, dequantized (code times scale) before the replay.
``kernels/ops.paged_mla_attention`` picks a version by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.ref import ref_paged_mla_attention

__all__ = ["paged_mla_attention_plain", "paged_mla_attention_cuda"]

# The plain version is the oracle itself: the gathered latent view and a
# dense fp32 softmax over it.
paged_mla_attention_plain = ref_paged_mla_attention

_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
MAX_R, MAX_P, MAX_BS = 512, 64, 32  # the kernel's register and lane budget


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("paged_mla_attention").paged_mla_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def paged_mla_attention_cuda(q_lat, q_pe, ckvp, kpep, bt, lengths, ckvs=None, kpes=None, *,
                             scale: float, aq_scale: Optional[torch.Tensor] = None,
                             act_bits: Optional[int] = None):
    """Launch the CUDA kernel on the current stream.  ``q_lat (B, H, R)`` and
    ``q_pe (B, H, P)`` fp32; pools ``(NB, bs, R)`` / ``(NB, bs, P)`` of one
    dtype: fp32, bf16, int8 codes, or packed int4 (uint8 at ``R // 2`` /
    ``P // 2``), the integer pools with fp32 per-token scale pools
    ``ckvs``/``kpes`` ``(NB, bs)``; ``bt (B, MB)`` and ``lengths (B,)`` int32;
    ``aq_scale`` a one-element fp32 tensor on the device (read by the kernel,
    never by the host) with ``act_bits``; all contiguous on one CUDA device,
    ``R <= 512``, ``P <= 64``, ``bs <= 32``, ``R`` and ``P`` multiples of 8,
    pools 16-byte aligned with a whole number of 16 bytes a block.  Returns
    ``(B, H, R)`` fp32.  Every launch adds one to
    ``paged_mla_attention_cuda.launches``."""
    B, H, R = q_lat.shape
    NB, bs, Rp = ckvp.shape
    P = q_pe.shape[-1]
    MB = bt.shape[1]
    dev = q_lat.device
    if dev.type != "cuda":
        raise ValueError(f"paged_mla_attention_cuda needs CUDA tensors, got {dev}")
    if q_lat.dtype != torch.float32 or q_pe.dtype != torch.float32:
        raise ValueError(f"paged_mla_attention_cuda: fp32 queries expected, got "
                         f"{q_lat.dtype}, {q_pe.dtype}")
    if ckvp.dtype not in _POOL_KIND or kpep.dtype != ckvp.dtype:
        raise ValueError(f"paged_mla_attention_cuda: pools must be one of fp32, bf16, int8, "
                         f"uint8 (alike), got {ckvp.dtype}, {kpep.dtype}")
    quant = ckvp.dtype in (torch.int8, torch.uint8)
    if quant != (ckvs is not None) or (ckvs is None) != (kpes is None):
        raise ValueError("paged_mla_attention_cuda: integer pools need ckvs/kpes scale pools, "
                         "float pools take none")
    pack = 2 if ckvp.dtype == torch.uint8 else 1
    if tuple(q_pe.shape) != (B, H, P) or Rp * pack != R or \
            tuple(kpep.shape) != (NB, bs, P // pack):
        raise ValueError(f"paged_mla_attention_cuda: shapes q_lat {tuple(q_lat.shape)}, "
                         f"q_pe {tuple(q_pe.shape)}, ckvp {tuple(ckvp.shape)}, "
                         f"kpep {tuple(kpep.shape)} do not match")
    if R > MAX_R or P > MAX_P or bs > MAX_BS or R % 8 or P % 8:
        raise ValueError(f"paged_mla_attention_cuda: R={R} P={P} bs={bs}: the kernel takes "
                         f"R <= {MAX_R}, P <= {MAX_P}, bs <= {MAX_BS}, R and P multiples of 8")
    if ckvp.data_ptr() % 16 or kpep.data_ptr() % 16 or \
            (bs * ckvp.shape[-1] * ckvp.element_size()) % 16 or \
            (bs * kpep.shape[-1] * kpep.element_size()) % 16:
        raise ValueError("paged_mla_attention_cuda: pools must be 16-byte aligned, with a "
                         "multiple of 16 bytes a block")
    if tuple(bt.shape) != (B, MB) or tuple(lengths.shape) != (B,) or \
            bt.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_mla_attention_cuda: bt (B, MB) and lengths (B,) must be int32")
    if (act_bits is None) != (aq_scale is None):
        raise ValueError("paged_mla_attention_cuda: aq_scale and act_bits must be given together")
    named = [("q_lat", q_lat), ("q_pe", q_pe), ("ckvp", ckvp), ("kpep", kpep), ("bt", bt),
             ("lengths", lengths)]
    if quant:
        for name, t in (("ckvs", ckvs), ("kpes", kpes)):
            if t.dtype != torch.float32 or tuple(t.shape) != (NB, bs):
                raise ValueError(f"paged_mla_attention_cuda: {name} must be fp32 {(NB, bs)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            named.append((name, t))
    if aq_scale is not None:
        if aq_scale.dtype != torch.float32 or aq_scale.numel() != 1 or not 2 <= act_bits <= 16:
            raise ValueError("paged_mla_attention_cuda: aq_scale must be one fp32 value "
                             "and act_bits in [2, 16]")
        named.append(("aq_scale", aq_scale))
    for name, t in named:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"paged_mla_attention_cuda: {name} must be contiguous on {dev}")
    out = torch.empty((B, H, R), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ctypes.c_void_p(q_lat.data_ptr()), ctypes.c_void_p(q_pe.data_ptr()),
            ctypes.c_void_p(ckvp.data_ptr()), ctypes.c_void_p(kpep.data_ptr()),
            ctypes.c_void_p(ckvs.data_ptr() if quant else 0),
            ctypes.c_void_p(kpes.data_ptr() if quant else 0),
            ctypes.c_void_p(bt.data_ptr()), ctypes.c_void_p(lengths.data_ptr()),
            ctypes.c_void_p(aq_scale.data_ptr() if aq_scale is not None else 0),
            ctypes.c_void_p(out.data_ptr()),
            B, H, R, P, bs, MB, float(scale), act_bits or 0,
            _POOL_KIND[ckvp.dtype], ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"paged_mla_attention kernel launch failed: cudaError {err}")
    paged_mla_attention_cuda.launches += 1
    return out


paged_mla_attention_cuda.launches = 0
