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
picks a version by the tensors' device.  The kernel cuts each row's table
into ``split_kv`` runs and merges their partial softmaxes in split order;
``paged_attention_split_plain`` is that arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._guard import plain_version
from repro_torch.kernels.ref import (
    _unpack_nibbles,
    ref_paged_attention,
    ref_paged_attention_q4,
    ref_paged_attention_q8,
)

__all__ = ["paged_attention_plain", "paged_attention_split_plain",
           "paged_attention_cuda", "split_kv"]

_FLOATS = (torch.float32, torch.bfloat16)
_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
MAX_DH = 256  # 32 lanes of 8 elements
BLOCKS_PER_SM = 4  # the split grid's aim: about this many blocks an SM
MIN_SPLIT_KEYS = 128  # a split holds at least this many key slots (two passes of 4 warps)
MAX_SPLITS = 8  # a row's runs are one thread-block cluster (its portable size)
_NEG = -1e30


@plain_version
def paged_attention_plain(q, kp, vp, bt, lengths, kps=None, vps=None,
                          scale: Optional[float] = None, window: Optional[int] = None):
    """The plain version is the oracle itself: the gathered contiguous view
    (dequantized for int8 / packed-int4 pools) and a dense fp32 softmax."""
    if kps is None:
        return ref_paged_attention(q, kp, vp, bt, lengths, scale=scale, window=window)
    oracle = ref_paged_attention_q4 if kp.dtype == torch.uint8 else ref_paged_attention_q8
    return oracle(q, kp, vp, kps, vps, bt, lengths, scale=scale, window=window)


def head_group(G: int) -> int:
    """Query heads a block takes of the ``G`` that share a KV head (all of
    them up to 4; more heads take more blocks)."""
    return min(max(G, 1), 4)


def _split_entries(MB: int, splits: int) -> tuple[int, int]:
    """``(entries a split, splits)``: the ``MB`` table entries cut into at
    most ``splits`` (and ``MAX_SPLITS``) runs of ``ceil(MB / splits)``, none
    empty."""
    eps = -(-MB // max(1, min(splits, MB, MAX_SPLITS)))
    return eps, -(-MB // eps)


def split_kv(B: int, KV: int, G: int, MB: int, bs: int, sms: int) -> int:
    """How many runs the kernel cuts each row's table into: enough blocks
    for ``BLOCKS_PER_SM`` on each of ``sms`` SMs, with at least
    ``MIN_SPLIT_KEYS`` key slots a run.  From the static shapes (``MB`` is
    the table's width), never from the lengths on the device."""
    blocks = B * KV * -(-G // head_group(G))
    want = -(-(BLOCKS_PER_SM * sms) // max(blocks, 1))
    return _split_entries(MB, min(want, max(1, MB * bs // MIN_SPLIT_KEYS)))[1]


@plain_version
def paged_attention_split_plain(q, kp, vp, bt, lengths, kps=None, vps=None, *, splits: int,
                                scale: Optional[float] = None,
                                window: Optional[int] = None):
    """The kernel's split-KV arithmetic in PyTorch: each row's table cut
    into ``splits`` runs of whole entries (as ``_split_entries`` cuts it);
    each run's partial softmax over its valid keys, ``m`` (the run's largest
    score, -1e30 for a run without a valid key), ``l = sum exp(s - m)`` and
    the unnormalized ``acc = sum exp(s - m) v``; then the runs merged in
    split order, ``M = max m``, ``L = sum l e^(m - M)``, ``A = sum acc
    e^(m - M)``, and the output ``A * (L > 0 ? 1 / max(L, 1e-30) : 0)`` in
    ``q``'s dtype.  Integer pools are dequantized first (code times the
    slot's scale), as the oracles do."""
    B, H, Dh = q.shape
    NB, bs, KV = kp.shape[:3]
    MB = bt.shape[1]
    G = H // KV
    if scale is None:
        scale = Dh**-0.5
    if kps is not None:
        unpack = _unpack_nibbles if kp.dtype == torch.uint8 else (lambda c: c)
        kp = unpack(kp).to(torch.float32) * kps.to(torch.float32)[..., None]
        vp = unpack(vp).to(torch.float32) * vps.to(torch.float32)[..., None]
    btl = bt.long()
    k = kp[btl].reshape(B, MB * bs, KV, Dh).to(torch.float32)
    v = vp[btl].reshape(B, MB * bs, KV, Dh).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(B, KV, G, Dh).to(torch.float32) * scale, k)
    kpos = torch.arange(MB * bs, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    valid = valid[:, None, None, :].expand_as(s)
    eps, splits = _split_entries(MB, splits)
    parts = []
    for lo in range(0, MB * bs, eps * bs):
        sl, vm = s[..., lo:lo + eps * bs], valid[..., lo:lo + eps * bs]
        m = torch.where(vm, sl, torch.full_like(sl, _NEG)).amax(-1)
        p = torch.where(vm, torch.exp(sl - m[..., None]), torch.zeros_like(sl))
        parts.append((m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:lo + eps * bs])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    big_l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:  # in split order
        f = torch.exp(m - mx)
        big_l = big_l + l * f
        acc = acc + a * f[..., None]
    norm = torch.where(big_l > 0.0, 1.0 / torch.clamp_min(big_l, 1e-30), torch.zeros_like(big_l))
    return (acc * norm[..., None]).reshape(B, H, Dh).to(q.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int])
    return fn


def paged_attention_cuda(q, kp, vp, bt, lengths, kps=None, vps=None,
                         scale: Optional[float] = None, window: Optional[int] = None):
    """Launch the CUDA kernel on the current stream.  ``q (B, H, Dh)`` fp32 or
    bf16; pools ``(NB, bs, KV, Dh)`` of one dtype: fp32, bf16, int8 codes,
    or packed int4 (uint8, ``(NB, bs, KV, Dh // 2)``), the integer pools with
    fp32 scale pools ``kps``/``vps`` ``(NB, bs, KV)``; ``bt (B, MB)`` and
    ``lengths (B,)`` int32; all contiguous on one CUDA device, with
    ``H % KV == 0`` and ``Dh <= 256``.  Returns ``(B, H, Dh)`` in ``q``'s
    dtype.  Each row's table is cut into ``split_kv`` runs (at most
    ``MAX_SPLITS``), a row's runs one thread-block
    cluster that merges them in shared memory; nothing here reads a device
    value.  Every launch adds one to ``paged_attention_cuda.launches``, one
    over several runs also to ``paged_attention_cuda.split_launches``."""
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
            tuple(vp.shape) != tuple(kp.shape) or H % KV or not 1 <= Dh <= MAX_DH:
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
    G = H // KV
    want = split_kv(B, KV, G, MB, bs, _sm_count(dev.index))
    if MB == 0:  # no key slots: every row is empty
        return out.zero_()
    splits = _split_entries(MB, want)[1]
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
            ctypes.c_void_p(stream), splits,
        )
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention_cuda.launches += 1
    paged_attention_cuda.split_launches += splits > 1
    return out


paged_attention_cuda.launches = 0
paged_attention_cuda.split_launches = 0
