"""int8 x int8 -> int32 matmul with P-bit accumulator emulation, the fused
W8A8 epilogue, the quantizing prologue and the requantizing epilogue: the
CUDA kernel (``csrc/int_matmul.cu``) and its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.int_matmul`` (``int_matmul_kernel``
/ ``int_matmul_pallas``): the core GEMM with ``exact`` / ``wrap`` /
``saturate`` carry per reference K-tile, the optional int16 carry that the
A2Q bound makes lossless for ``acc_bits <= 16``, the fused epilogue
``(acc + offset) * scale (+ bias)``, the prologue that quantizes an fp32
or bf16 ``x`` with ``aq_scale`` (``clip(round(x / aq_scale), lo, hi)``,
minus 128 for unsigned 8-bit codes; bf16 widened to fp32 exactly first),
the chain-break entry of
``--int-chain``, and the requantizing epilogue that hands int8 codes to the
next linear (``out_scale``: the activation replayed in ``cast_dtype``, then
``clip(round(y / out_scale), lo, hi)``, minus 128 for unsigned 8-bit codes),
the chained edge of ``--int-chain`` (rwkv6's ``cm.wk -> relu^2 -> cm.wv``,
the non-gated MLP's ``w_in -> gelu -> w_out``).  The replay covers
``act_fn`` ``None``, ``"relu2"`` and ``"gelu"`` (``ref.gelu_tanh`` in fp32,
cast back to ``cast_dtype``).

Both versions replay the carry at the reference's K-tile boundaries
``block_k`` (the public wrapper passes ``min(512, round_up(K, 128))``), so
they agree bit for bit with each other and with ``repro.kernels.ref``.
``kernels/ops.int_matmul`` picks one by the tensors' device.  On the card
``int_matmul_cuda`` runs the decode kernel below ``TC_MIN_ROWS`` rows (split
over K, ``split_k``; ``int_matmul_split_plain`` is its arithmetic) and the
int8 tensor-core kernel from there on (prefill chunks, encodes), where the
prologue is a separate pass writing the codes once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._guard import plain_version
from repro_torch.kernels.ref import (_SQRT_2_OVER_PI, exact_product, gelu_tanh, saturate_bits,
                                    wrap_bits)

__all__ = ["MODES", "ACTS", "CAST_DTYPES", "TC_MIN_ROWS", "int_matmul_plain",
           "int_matmul_split_plain", "int_matmul_cuda", "split_k", "flush_bits", "prologue_codes",
           "requant_codes", "requant_ties"]

MODES = {"exact": 0, "wrap": 1, "saturate": 2}
ACTS = {None: 0, "relu2": 1, "gelu": 2}  # the requant epilogue's activation replays
CAST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # and the dtype they run in
PROLOGUE_DTYPES = (torch.float32, torch.bfloat16)  # the prologue's activations
TC_MIN_ROWS = 17  # from this many rows the tensor-core kernel runs, below it the decode kernel
DECODE_MAX_ROWS = 32  # the decode kernel's two m16 tiles
DECODE_ROUND = 256  # k of one step of each of the decode kernel's 8 warps
STRIP = 128  # output columns a decode block owns
BLOCKS_PER_SM = 4  # the decode grid's aim: about this many blocks an SM (measured best)
MAX_SPLITS = 4  # a strip's K splits are one thread-block cluster (measured: 8 is slower)


def prologue_codes(x: torch.Tensor, aq_scale: torch.Tensor, lo: int, hi: int,
                   shift: int) -> torch.Tensor:
    """The prologue's int8 operand: ``clip(round(x / aq_scale), lo, hi) -
    shift`` (dividing in fp32, rounding half to even), as ``act_quant_int``
    and the symmetrization compute it on their own."""
    x = x.to(torch.float32)
    return (torch.clamp(torch.round(x / aq_scale), lo, hi) - shift).to(torch.int8)


def requant_codes(y: torch.Tensor, out_scale: torch.Tensor, lo: int, hi: int, shift: int,
                  act_fn=None, cast_dtype=torch.float32) -> torch.Tensor:
    """The requant epilogue's int8 codes of the fp32 flush ``y (M, N)``: the
    cast to ``cast_dtype``, ``act_fn`` replayed there (``relu2``: relu, then
    the square, rounded once to ``cast_dtype``; ``gelu``: ``gelu_tanh`` in
    fp32, rounded once to ``cast_dtype``), back to fp32, then
    ``clip(round(y / out_scale), lo, hi) - shift`` (dividing, rounding half
    to even), as the layer code and the consumer's act-quant compute it."""
    y = y.to(cast_dtype)
    if act_fn == "relu2":
        y = torch.square(torch.relu(y))
    elif act_fn == "gelu":
        y = gelu_tanh(y.to(torch.float32)).to(cast_dtype)
    y = y.to(torch.float32)
    return (torch.clamp(torch.round(y / out_scale[None, :]), lo, hi) - shift).to(torch.int8)


def requant_ties(y: torch.Tensor, out_scale: torch.Tensor, act_fn=None,
                 cast_dtype=torch.float32) -> torch.Tensor:
    """Where another replay of the requant epilogue may round the fp32
    flush ``y (M, N)`` to a code one apart from ``requant_codes``': only
    the gelu replay calls a library function (``tanh``), and a ``tanh``
    within 4 of its own ulps of ``torch.tanh``'s (CUDA's ``tanhf`` and
    PyTorch's are each within 2 ulps of the exact value) moves nothing
    else.  Every op of ``gelu_tanh`` after the ``tanh``, the cast to
    ``cast_dtype``, the division and the rounding are monotone in it, so the
    codes of the two ends of that ``tanh`` interval bound every such
    replay's code; an element is a tie where they differ.  The None and
    relu2 replays have no ties: both versions round the same IEEE ops."""
    if act_fn != "gelu":
        return torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    x = y.to(cast_dtype).to(torch.float32)
    t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    dt = 4 * torch.ldexp(torch.ones_like(t), torch.frexp(t).exponent - 24)
    lo, hi = (torch.round((x * (0.5 * (1.0 + torch.clamp(t + e, -1.0, 1.0))))
                          .to(cast_dtype).to(torch.float32) / out_scale[None, :])
              for e in (-dt, dt))
    return lo != hi


@plain_version
def int_matmul_plain(x, w, scale=None, bias=None, offset=None, *, acc_bits: int = 32,
                     mode: str = "exact", block_k: int, spill_int16: bool = False,
                     aq_scale=None, q_lo: int = 0, q_hi: int = 0, q_shift: int = 0,
                     out_scale=None, r_lo: int = 0, r_hi: int = 0, r_shift: int = 0,
                     act_fn=None, cast_dtype=torch.float32):
    """The kernel's arithmetic in PyTorch, on any device: with ``aq_scale``
    the prologue's codes of the fp32 or bf16 ``x`` (``prologue_codes``), then one
    exact int64 partial per ``block_k`` K-tile, folded into the carry in tile
    order as the Pallas body does (``carried + tile``, the mode's wrap or
    clip, then the int16 store when ``spill_int16``), then the epilogue, and
    with ``out_scale`` its int8 codes (``requant_codes`` to ``[r_lo, r_hi]``
    minus ``r_shift``)."""
    if aq_scale is not None:
        x = prologue_codes(x, aq_scale, q_lo, q_hi, q_shift)
    K = x.shape[1]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64, device=x.device)
    for lo in range(0, K, block_k):
        acc = wrap_bits(acc + exact_product(x[:, lo:lo + block_k], w[lo:lo + block_k]), 32)
        if mode == "wrap":
            acc = wrap_bits(acc, acc_bits)
        elif mode == "saturate":
            acc = saturate_bits(acc, acc_bits)
        if spill_int16:
            acc = wrap_bits(acc, 16)
    return _epilogue(acc, scale, bias, offset, out_scale, r_lo, r_hi, r_shift, act_fn,
                     cast_dtype)


def flush_bits(mode: str, acc_bits: int, spill_int16: bool) -> int:
    """The one fold that stands for every per-tile fold of ``exact`` and
    ``wrap`` (with or without the int16 carry): sign extension to this many
    bits.  Each fold is a reduction mod 2^n and commutes with addition, and
    a tile's int8 products sum exactly in int32, so folding the int32 sum
    of all tiles once gives the reference's carry bit for bit."""
    bits = acc_bits if mode == "wrap" and acc_bits < 32 else 32
    return min(bits, 16) if spill_int16 else bits


@plain_version
def int_matmul_split_plain(x, w, scale=None, bias=None, offset=None, *, splits: int,
                           acc_bits: int = 32, mode: str = "exact", block_k: int,
                           spill_int16: bool = False, aq_scale=None, q_lo: int = 0,
                           q_hi: int = 0, q_shift: int = 0, out_scale=None, r_lo: int = 0,
                           r_hi: int = 0, r_shift: int = 0, act_fn=None,
                           cast_dtype=torch.float32):
    """The decode kernel's split-K arithmetic in PyTorch: K cut into
    ``splits`` runs of whole ``block_k`` tiles (as ``_split_runs`` cuts it),
    each run's int32 partial (each block adds its own), the partials added
    mod 2^32 in the order given (any order gives the same sum), then the
    one fold of ``flush_bits`` and the epilogue.  ``saturate`` below 32 bits
    is no homomorphism: the kernel keeps one split and folds per tile, so
    it goes through ``int_matmul_plain``."""
    if mode == "saturate" and acc_bits < 32:
        return int_matmul_plain(x, w, scale, bias, offset, acc_bits=acc_bits, mode=mode,
                                block_k=block_k, spill_int16=spill_int16, aq_scale=aq_scale,
                                q_lo=q_lo, q_hi=q_hi, q_shift=q_shift, out_scale=out_scale,
                                r_lo=r_lo, r_hi=r_hi, r_shift=r_shift, act_fn=act_fn,
                                cast_dtype=cast_dtype)
    if aq_scale is not None:
        x = prologue_codes(x, aq_scale, q_lo, q_hi, q_shift)
    K = x.shape[1]
    k_split, splits = _split_runs(K, block_k, splits)
    parts = [wrap_bits(exact_product(x[:, lo:lo + k_split], w[lo:lo + k_split]), 32)
             for lo in range(0, k_split * splits, k_split)]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64, device=x.device)
    for part in parts:
        acc = wrap_bits(acc + part, 32)
    acc = wrap_bits(acc, flush_bits(mode, acc_bits, spill_int16))
    return _epilogue(acc, scale, bias, offset, out_scale, r_lo, r_hi, r_shift, act_fn,
                     cast_dtype)


def _split_runs(K: int, block_k: int, splits: int) -> tuple[int, int]:
    """``(k_split, splits)``: K's ``block_k`` tiles dealt into at most
    ``splits`` (and ``MAX_SPLITS``) runs of equal whole tiles (the last may
    be shorter), none empty."""
    tiles = -(-max(K, 1) // block_k)
    per = -(-tiles // max(1, min(splits, tiles, MAX_SPLITS)))
    return per * block_k, -(-tiles // per)


def split_k(N: int, K: int, block_k: int, mode: str, acc_bits: int, sms: int) -> int:
    """How many K splits the decode kernel takes: enough blocks (one a
    128-column strip and split) for about ``BLOCKS_PER_SM`` on each of
    ``sms`` SMs, at most ``MAX_SPLITS``, at most one a reference K-tile, and
    one for ``saturate`` below 32 bits.  From the static shapes alone, never
    from a device value."""
    if mode == "saturate" and acc_bits < 32:
        return 1
    strips = -(-N // STRIP)
    return _split_runs(K, block_k, -(-(BLOCKS_PER_SM * sms) // strips))[1]


def _epilogue(acc, scale, bias, offset, out_scale, r_lo, r_hi, r_shift, act_fn, cast_dtype):
    """The flushed int64 accumulator through the fused epilogue (and the
    requant epilogue with ``out_scale``)."""
    if scale is None:
        return acc.to(torch.int32)
    if offset is not None:
        acc = wrap_bits(acc + offset.to(torch.int64)[None, :], 32)
    out = acc.to(torch.float32) * scale[None, :]
    if bias is not None:
        out = out + bias[None, :]
    if out_scale is not None:
        return requant_codes(out, out_scale, r_lo, r_hi, r_shift, act_fn, cast_dtype)
    return out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("int_matmul").int_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2)
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int_matmul_cuda(x, w, scale=None, bias=None, offset=None, *, acc_bits: int = 32,
                    mode: str = "exact", block_k: int, spill_int16: bool = False,
                    aq_scale=None, q_lo: int = 0, q_hi: int = 0, q_shift: int = 0,
                    out_scale=None, r_lo: int = 0, r_hi: int = 0, r_shift: int = 0,
                    act_fn=None, cast_dtype=torch.float32):
    """Launch the CUDA kernel on the current stream.  ``x (M, K)`` and
    ``w (K, N)`` are contiguous int8 on one CUDA device; ``scale``/``bias``
    fp32 and ``offset`` int32 are ``(N,)``; ``block_k`` is a positive multiple
    of 64.  With ``aq_scale`` (a one-element fp32 tensor on the device, read
    by the kernel, never by the host) ``x`` is fp32 or bf16 and the
    prologue quantizes it to ``[q_lo, q_hi]`` minus ``q_shift``.  With ``out_scale``
    (fp32 ``(N,)``; needs ``scale`` and ``mode="exact"``) the epilogue
    replays ``act_fn`` in ``cast_dtype`` and requantizes to int8 codes in
    ``[r_lo, r_hi]`` minus ``r_shift``.  Returns int8 ``(M, N)`` with
    ``out_scale``, fp32 with ``scale``, else int32.  From ``TC_MIN_ROWS``
    rows on the int8 tensor-core kernel runs (the prologue then a separate
    pass into an ``(M, K)`` int8 scratch buffer allocated here), below it the
    decode kernel (at most ``DECODE_MAX_ROWS`` rows), over ``split_k``'s K
    splits (at most ``MAX_SPLITS``), a strip's splits one thread-block
    cluster that sums them in shared memory.
    Nothing here reads a device value.  Every launch adds one to
    ``int_matmul_cuda.launches``, one on the tensor cores also to
    ``int_matmul_cuda.tc_launches``, one over several K splits to
    ``int_matmul_cuda.split_launches``, a launch with the prologue to
    ``int_matmul_cuda.prologue_launches``, and one with the requant epilogue
    to ``int_matmul_cuda.requant_launches``."""
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    if aq_scale is None:
        x_dtype = torch.int8
    else:
        x_dtype = x.dtype if x.dtype in PROLOGUE_DTYPES else torch.float32
    for name, t, dt, shape in (("x", x, x_dtype, (M, K)), ("w", w, torch.int8, (K, N)),
                               ("scale", scale, torch.float32, (N,)),
                               ("bias", bias, torch.float32, (N,)),
                               ("offset", offset, torch.int32, (N,)),
                               ("aq_scale", aq_scale, torch.float32, (1,)),
                               ("out_scale", out_scale, torch.float32, (N,))):
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"int_matmul_cuda: {name} must be a contiguous {dt} {shape} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"int_matmul_cuda needs CUDA tensors, got {dev}")
    if block_k <= 0 or block_k % 64:
        raise ValueError(f"int_matmul_cuda: block_k must be a positive multiple of 64, got {block_k}")
    if (bias is not None or offset is not None) and scale is None:
        raise ValueError("int_matmul_cuda: bias/offset need an epilogue scale")
    if aq_scale is not None and not -128 <= q_lo - q_shift <= q_hi - q_shift <= 127:
        raise ValueError(f"int_matmul_cuda: prologue codes [{q_lo}, {q_hi}] - {q_shift} "
                         "do not fit int8")
    if out_scale is not None:
        if scale is None or mode != "exact":
            raise ValueError("int_matmul_cuda: the requant epilogue needs a scale and mode='exact'")
        if act_fn not in ACTS or cast_dtype not in CAST_DTYPES:
            raise ValueError(f"int_matmul_cuda: no requant replay of act_fn={act_fn!r} in "
                             f"{cast_dtype}")
        if not -128 <= r_lo - r_shift <= r_hi - r_shift <= 127:
            raise ValueError(f"int_matmul_cuda: requant codes [{r_lo}, {r_hi}] - {r_shift} "
                             "do not fit int8")
        out_dtype = torch.int8
    else:
        out_dtype = torch.float32 if scale is not None else torch.int32
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    sat = mode == "saturate" and acc_bits < 32
    # the decode kernel folds saturate's sums at K-tiles of whole rounds
    tc = M >= TC_MIN_ROWS or (sat and block_k % DECODE_ROUND != 0)
    codes = torch.empty((M, K), dtype=torch.int8, device=dev) if tc and aq_scale is not None \
        else None
    k_split, splits = block_k, 1
    if not tc:
        if M > DECODE_MAX_ROWS:
            raise ValueError(f"int_matmul_cuda: the decode kernel takes at most {DECODE_MAX_ROWS} "
                             f"rows, got {M}")
        want = 1 if sat else split_k(N, K, block_k, mode, acc_bits, _sm_count(dev.index))
        k_split, splits = _split_runs(K, block_k, want)
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            _ptr(x), _ptr(w), M, N, K, block_k, MODES[mode], acc_bits, int(spill_int16),
            _ptr(scale), _ptr(bias), _ptr(offset), _ptr(aq_scale), q_lo, q_hi, q_shift,
            _ptr(out_scale), r_lo, r_hi, r_shift, ACTS.get(act_fn, 0),
            CAST_DTYPES.get(cast_dtype, 0),
            _ptr(out) if out_dtype == torch.float32 else None,
            _ptr(out) if out_dtype == torch.int32 else None,
            _ptr(out) if out_dtype == torch.int8 else None,
            int(x.dtype == torch.bfloat16), int(tc), _ptr(codes), ctypes.c_void_p(stream),
            splits, k_split,
        )
    if err != 0:
        raise RuntimeError(f"int_matmul kernel launch failed: cudaError {err}")
    int_matmul_cuda.launches += 1
    int_matmul_cuda.tc_launches += tc
    int_matmul_cuda.split_launches += splits > 1
    int_matmul_cuda.prologue_launches += aq_scale is not None
    int_matmul_cuda.requant_launches += out_scale is not None
    return out


int_matmul_cuda.launches = 0
int_matmul_cuda.tc_launches = 0
int_matmul_cuda.split_launches = 0
int_matmul_cuda.prologue_launches = 0
int_matmul_cuda.requant_launches = 0
