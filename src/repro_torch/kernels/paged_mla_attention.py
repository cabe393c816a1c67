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

The CUDA wrapper picks one of two kernels (``tensor_core_route``): bf16,
int8 and int4 pools with no replay or one of at most 9 bits run on the bf16
tensor cores, 16 heads a block, a row's table cut into ``mla_splits`` runs
merged in a thread-block cluster; ``paged_mla_attention_tc_plain`` is that
arithmetic in PyTorch.  fp32 pools and wider replays, whose latent is not
exact in bf16, run on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._guard import plain_version
from repro_torch.kernels.ref import _unpack_nibbles, ref_paged_mla_attention

__all__ = ["paged_mla_attention_plain", "paged_mla_attention_tc_plain", "paged_mla_attention_cuda",
           "mla_splits", "tensor_core_route"]

# The plain version is the oracle itself: the gathered latent view and a
# dense fp32 softmax over it.
paged_mla_attention_plain = plain_version(ref_paged_mla_attention)

_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
MAX_R, MAX_P, MAX_BS = 512, 64, 32  # the kernels' register and lane budget
TC_MAX_ACT_BITS = 9  # the replay's codes (|code| <= 256) are exact in bf16 up to 9 bits
HEAD_TILE = 16  # heads a tensor-core block: the m16 rows of both products
STEP_KEYS = 64  # keys a tensor-core step
SLICE_R, SLICE_P = 64, 16  # latent / rope columns a warp owns
MAX_SPLITS = 8  # a row's runs are one thread-block cluster (its portable size)
_NEG = -1e30


def tensor_core_route(pool_dtype: torch.dtype, act_bits: Optional[int]) -> bool:
    """Whether the tensor-core kernel takes these pools: bf16, int8 or int4
    (uint8), with no replay or one of at most ``TC_MAX_ACT_BITS`` bits (the
    latent operand must be exact in bf16); fp32 pools and wider replays run
    on the CUDA cores."""
    return pool_dtype in (torch.bfloat16, torch.int8, torch.uint8) and \
        (act_bits is None or act_bits <= TC_MAX_ACT_BITS)


def _split_entries(MB: int, splits: int) -> tuple[int, int]:
    """``(entries a run, runs)``: the ``MB`` table entries cut into at most
    ``splits`` runs of ``ceil(MB / splits)``, none empty."""
    eps = -(-MB // max(1, min(splits, MB, MAX_SPLITS)))
    return eps, -(-MB // eps)


def mla_splits(B: int, H: int, MB: int, sms: int) -> int:
    """Runs the tensor-core kernel cuts each row's table into, from the
    static shapes (``MB`` is the table's width) and the SM count, never from
    the lengths on the device: the fewest runs that minimize the waves of
    one block an SM a run's share of the work takes (``ceil(blocks / sms) /
    runs``; each block holds a run's 16-head tile of a row)."""
    tiles = B * -(-H // HEAD_TILE)
    best, best_cost = 1, None
    for s in range(1, min(MAX_SPLITS, MB) + 1):
        if _split_entries(MB, s)[1] != s:
            continue
        cost = -(-(tiles * s) // sms) / s
        if best_cost is None or cost < best_cost - 1e-9:
            best, best_cost = s, cost
    return best


def _bf16_terms(x: torch.Tensor, n: int) -> list:
    """``x`` (fp32) as ``n`` bf16 terms, each the bf16 rounding of what the
    earlier ones leave (the differences are exact in fp32)."""
    terms = []
    for _ in range(n):
        t = x.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        x = x - t
    return terms


@plain_version
def paged_mla_attention_tc_plain(q_lat, q_pe, ckvp, kpep, bt, lengths, ckvs=None, kpes=None, *,
                                 scale: float, aq_scale=None, act_bits: Optional[int] = None,
                                 splits: int = 1):
    """The tensor-core kernel's arithmetic in PyTorch (bf16, int8 and int4
    pools): the latent operand as the kernel stages it (bf16 values, the
    codes, or the replay's codes ``clip(rint(code * scale / s_aq))``), with a
    per-key factor on the latent scores (1, the token scale, or ``s_aq``), one
    on the rope scores (1 or the rope token scale) and one folded into P (the
    token scale without a replay); q split into bf16 hi + mid + lo, the scores
    summed over 64-column latent slices (16-column rope slices) as the warps
    do; each run of ``ceil(MB / splits)`` table entries walked in steps of
    64 keys with an fp32 online softmax, P (times its factor) split into
    bf16 hi + lo (hi + mid + lo with a token scale folded in); the runs
    merged in order; the output times ``s_aq`` with a replay.  A row of
    one key gives the key's dequantized (replayed) latent."""
    B, H, R = q_lat.shape
    P = q_pe.shape[-1]
    bs = ckvp.shape[1]
    MB = bt.shape[1]
    btl = bt.long()
    unpack = _unpack_nibbles if ckvp.dtype == torch.uint8 else (lambda c: c)
    ckv = unpack(ckvp[btl]).to(torch.float32).reshape(B, MB * bs, R)
    kpe = unpack(kpep[btl]).to(torch.float32).reshape(B, MB * bs, P)
    one = torch.ones((B, MB * bs), dtype=torch.float32, device=q_lat.device)
    cs = ckvs[btl].reshape(B, MB * bs).to(torch.float32) if ckvs is not None else one
    ks = kpes[btl].reshape(B, MB * bs).to(torch.float32) if kpes is not None else one
    x = ckv * cs[..., None] if ckvs is not None else ckv  # the dequantized latent
    if act_bits is not None:
        lo, hi = -(1 << (act_bits - 1)), (1 << (act_bits - 1)) - 1
        s_aq = torch.as_tensor(aq_scale, dtype=torch.float32, device=q_lat.device).reshape(())
        lat = torch.clamp(torch.round(x / s_aq), lo, hi)
        single = lat * s_aq
        lsc, fold, out_mul = one * s_aq, one, s_aq
    else:
        lat, single = ckv, x
        lsc, fold, out_mul = cs, cs, 1.0
    fold3 = ckvs is not None and act_bits is None  # P times a token scale: three terms
    qt = _bf16_terms(q_lat.to(torch.float32), 3)
    pt = _bf16_terms(q_pe.to(torch.float32), 3)
    s = torch.zeros((B, H, MB * bs), dtype=torch.float32, device=q_lat.device)
    for w in range(max(-(-R // SLICE_R), -(-P // SLICE_P))):
        rl, pl = slice(w * SLICE_R, (w + 1) * SLICE_R), slice(w * SLICE_P, (w + 1) * SLICE_P)
        sl = sum(torch.einsum("bhr,bkr->bhk", t[..., rl], lat[..., rl]) for t in qt)
        part = sl * lsc[:, None, :]
        if w < 4 and w * SLICE_P < P:
            sr = sum(torch.einsum("bhp,bkp->bhk", t[..., pl], kpe[..., pl]) for t in pt)
            part = part + sr * ks[:, None, :]
        s = s + part
    s = s * scale
    length = lengths.to(torch.int64).clamp(max=MB * bs)
    eps, _ = _split_entries(MB, splits)
    runs = []
    for kbeg in range(0, MB * bs, eps * bs):
        m = torch.full((B, H), _NEG, dtype=torch.float32, device=q_lat.device)
        l = torch.zeros((B, H), dtype=torch.float32, device=q_lat.device)
        acc = torch.zeros((B, H, R), dtype=torch.float32, device=q_lat.device)
        kend = torch.clamp(length, max=kbeg + eps * bs)
        for k0 in range(kbeg, min(kbeg + eps * bs, MB * bs), STEP_KEYS):
            k1 = min(k0 + STEP_KEYS, MB * bs)
            valid = (torch.arange(k0, k1, device=q_lat.device)[None, :] < kend[:, None])[:, None, :]
            st = s[..., k0:k1]
            mx = torch.where(valid, st, torch.full_like(st, _NEG)).amax(-1)
            m_new = torch.maximum(m, mx)
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(st - m_new[..., None]), torch.zeros_like(st))
            l = alpha * l + p.sum(-1)
            m = m_new
            pf = p * fold[:, None, k0:k1]
            pb = sum(_bf16_terms(pf, 3 if fold3 else 2))
            acc = alpha[..., None] * acc + torch.einsum("bhk,bkr->bhr", pb, lat[:, k0:k1])
        runs.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in runs]).amax(0)
    big_l = torch.zeros_like(mx)
    acc = torch.zeros_like(runs[0][2])
    for m, l, a in runs:  # in run order
        f = torch.exp(m - mx)
        big_l = big_l + l * f
        acc = acc + a * f[..., None]
    norm = torch.where(big_l > 0.0, 1.0 / torch.clamp_min(big_l, 1e-30), torch.zeros_like(big_l))
    out = acc * norm[..., None] * out_mul
    one_key = length == 1
    return torch.where(one_key[:, None, None], single[:, None, 0, :].expand(B, H, R), out)


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("paged_mla_attention").paged_mla_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2)
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    ``(B, H, R)`` fp32.  ``tensor_core_route`` picks the kernel, and
    ``mla_splits`` the tensor-core kernel's runs a row; nothing here reads a
    device value.  Every launch adds one to
    ``paged_mla_attention_cuda.launches``, one on the tensor cores also to
    ``paged_mla_attention_cuda.tc_launches``."""
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
    if MB == 0:  # no key slots: every row is empty
        return out.zero_()
    tc = tensor_core_route(ckvp.dtype, act_bits)
    splits = _split_entries(MB, mla_splits(B, H, MB, _sm_count(dev.index)))[1] if tc else 1
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
            _POOL_KIND[ckvp.dtype], ctypes.c_void_p(stream), splits, int(tc),
        )
    if err != 0:
        raise RuntimeError(f"paged_mla_attention kernel launch failed: cudaError {err}")
    paged_mla_attention_cuda.launches += 1
    paged_mla_attention_cuda.tc_launches += tc
    return out


paged_mla_attention_cuda.launches = 0
paged_mla_attention_cuda.tc_launches = 0
