"""Fused A2Q weight quantizer: the CUDA kernel (``csrc/a2q_quantize.cu``) and
its plain PyTorch version.

Port of the Pallas kernel ``repro.kernels.a2q_quantize``
(``a2q_quantize_kernel`` / ``a2q_quantize_pallas``).  Per column of an fp32
``v (K, C)``::

    l1  = max(sum_k |v[k, c]|, 1e-12)
    q   = clip(trunc(gs[c] * v / l1), n, p)        int8
    deq = q * s[c]                                 fp32

where ``gs = 2^(min(t, T) - d)`` and ``s = 2^d`` (Eq. 20-23).  Both versions
take ``gs`` and ``s`` as inputs, computed once per column by the caller with
``core.a2q._effective_gs``'s own torch expression (``torch.exp2``, which
differs from CUDA's ``exp2f`` and ``jnp.exp2`` in the last bits), and both
sum the l1 norm in fp32 in one order, ``core.a2q.pairwise_sum``'s tree, so
l1 and the codes agree bit for bit on any device.  ``code_flips_explained``
tells apart the one flips another sum order would make (one apart where
``gs * v / l1`` lies within the sums' difference of an integer), and
``deployed_code_flips`` holds a deployed matrix to the plain quantizer.
Rounding toward zero keeps ``sum |q| <= gs`` below the A2Q budget whatever
the sum.  ``kernels/ops.a2q_quantize`` picks a version by the tensors'
device.  The kernel splits each strip of columns' rows across a
thread-block cluster (``a2q_split`` picks the strip width, the split and
the chunk from the shapes); ``a2q_l1_split_plain`` is its order of the l1
sum in PyTorch, which is ``pairwise_sum``'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.a2q import a2q_codes
from repro_torch.kernels._guard import plain_version

__all__ = ["a2q_quantize_plain", "a2q_quantize_cuda", "a2q_l1_split_plain", "a2q_split",
           "code_flips_explained", "deployed_code_flips"]

THREADS = 256  # a block's threads: 4 columns and one chunk each in the first pass
PIECE = 8  # rows a thread loads at once: the smallest chunk
STRIPS = (32, 16, 8)  # strip widths in columns, widest (longest contiguous rows) first
MAX_SPLITS = 8  # blocks a strip: one thread-block cluster (its portable size)
BLOCKS_PER_SM = 2  # the aim: this many blocks an SM, their rows resident
PAIR_SMEM = 100 * 1024  # resident rows of one of two blocks sharing an SM


def cluster_shape(K: int, splits: int, strip: int) -> tuple[int, int, int]:
    """``(chunk, cpb, blocks)`` for at most ``splits`` blocks a strip: the
    smallest power-of-two chunk (at least ``PIECE`` rows) whose
    ``ceil(K / chunk)`` chunks fit ``splits`` blocks of at most
    ``THREADS * 4 / strip`` chunk slots; ``cpb``, the chunks a block, the
    least power of two that covers them in ``splits`` blocks (each block's
    rows a perfect subtree), and the blocks that then hold a chunk."""
    slots = THREADS * 4 // strip
    S = PIECE
    while -(-K // S) > splits * slots:
        S *= 2
    nch = -(-K // S)
    cpb = 1
    while cpb * splits < nch:
        cpb *= 2
    return S, cpb, -(-nch // cpb)


def resident_bytes(K: int, strip: int, chunk: int, cpb: int) -> int:
    """Shared memory a block keeps its rows in: ``cpb`` chunks of ``chunk +
    1`` rows (one pad row each) of ``strip`` fp32 columns (fewer chunks
    when the matrix has fewer)."""
    return 4 * min(cpb, -(-K // chunk)) * (chunk + 1) * strip


def a2q_split(K: int, C: int, sms: int) -> tuple[int, int, int, bool]:
    """``(strip, splits, chunk, resident)`` for a ``(K, C)`` matrix on ``sms``
    SMs, from the static shape.  Wide strips first (32 columns, then 16:
    128- and 64-byte row segments; 8 only for the narrowest matrices), each
    with resident rows that let two blocks share an SM (``PAIR_SMEM``):
    1. the fewest splits that give ``BLOCKS_PER_SM`` blocks an SM;
    2. else the most blocks, if they cover every SM once;
    3. when neither width has resident rows that fit (tall K), the second
       pass reads v from device memory again: 32 columns, the fewest
       splits that cover every SM;
    4. else (narrow matrices) the most resident blocks of any strip."""
    def shapes(strip):
        for target in range(1, MAX_SPLITS + 1):
            S, cpb, splits = cluster_shape(K, target, strip)
            if splits == target:
                yield splits, S, resident_bytes(K, strip, S, cpb) <= PAIR_SMEM

    strips = -(-C // STRIPS[0]), -(-C // STRIPS[1])
    for strip, n in zip(STRIPS[:2], strips):
        for splits, S, fits in shapes(strip):
            if fits and n * splits >= BLOCKS_PER_SM * sms:
                return strip, splits, S, True
        best = max(((n * g, g, S) for g, S, fits in shapes(strip) if fits), default=None)
        if best is not None and best[0] >= sms:
            return strip, best[1], best[2], True
    if not any(fits for strip in STRIPS[:2] for _, _, fits in shapes(strip)):
        for splits, S, _ in shapes(STRIPS[0]):
            if strips[0] * splits >= sms:
                return STRIPS[0], splits, S, False
        S, _, splits = cluster_shape(K, MAX_SPLITS, STRIPS[0])
        return STRIPS[0], splits, S, False
    best = max((-(-C // strip) * g, strip, g, S) for strip in STRIPS
               for g, S, fits in shapes(strip) if fits)
    return best[1], best[2], best[3], True


@plain_version
def a2q_quantize_plain(v, gs, s, *, n: int, p: int, dequantize: bool = True):
    """The quantizer in PyTorch, on any device, with ``a2q_int_weights``'
    arithmetic (``core.a2q.a2q_codes``): returns ``(deq fp32 or None, q
    int8, l1 fp32 (C,))``, ``deq`` only when ``dequantize``."""
    q, l1 = a2q_codes(v, gs, n, p)
    return (q * s if dequantize else None), q.to(torch.int8), l1


def _tree(a: torch.Tensor) -> torch.Tensor:
    """Perfect pairwise tree over the leading axis (a power of two long)."""
    while a.shape[0] > 1:
        a = a[0::2] + a[1::2]
    return a[0]


@plain_version
def a2q_l1_split_plain(v: torch.Tensor, splits: int, strip: int = 32) -> torch.Tensor:
    """The kernel's order of the l1 sum ``sum_k |v[k, c]|`` (before the
    ``1e-12`` floor), in PyTorch, for at most ``splits`` blocks a strip of
    ``strip`` columns: the rows cut into chunks (``cluster_shape``); each
    chunk summed as 8-row nodes ``((a + b) + (c + d)) + ((e + f) + (g + h))``
    joined in a perfect tree (rows past K are zeros); each block's ``cpb``
    chunk sums joined in a perfect tree (chunks past the last are zeros);
    the blocks' sums joined in a perfect tree of 8 (zeros past the last
    block).  Every node is one of ``core.a2q.pairwise_sum``'s, so the two are
    equal bit for bit."""
    K, C = v.shape
    S, cpb, _ = cluster_shape(K, splits, strip)
    a = torch.zeros((MAX_SPLITS * cpb * S, C), dtype=torch.float32, device=v.device)
    a[:K] = v.abs()
    nodes = a.reshape(MAX_SPLITS * cpb, S // PIECE, PIECE, C)
    nodes = ((nodes[:, :, 0] + nodes[:, :, 1]) + (nodes[:, :, 2] + nodes[:, :, 3])) + \
        ((nodes[:, :, 4] + nodes[:, :, 5]) + (nodes[:, :, 6] + nodes[:, :, 7]))
    chunks = _tree(nodes.transpose(0, 1))  # (8 cpb, C)
    block_sums = _tree(chunks.reshape(MAX_SPLITS, cpb, C).transpose(0, 1))  # (8, C)
    return _tree(block_sums)


def code_flips_explained(q, q_ref, v, gs, l1, l1_ref) -> tuple[int, bool]:
    """``(flips, explained)``: how many codes of ``q`` differ from ``q_ref``
    (both from the same ``v``, ``gs``), and whether every one differs by
    exactly 1 at an element whose ``gs * v / l1_ref`` lies within two fp32
    ulps plus the two l1 sums' relative difference of an integer, where the
    other l1 can round it the other way."""
    diff = q.to(torch.int32) - q_ref.to(torch.int32)
    flipped = diff != 0
    n = int(flipped.sum())
    if n == 0:
        return 0, True
    r = (gs[None, :] * v / l1_ref[None, :])[flipped]
    rel = ((l1 - l1_ref).abs() / l1_ref).expand_as(v)[flipped]
    eps = torch.finfo(torch.float32).eps
    near = (r - torch.round(r)).abs() <= r.abs() * (rel + 2 * eps)
    return n, bool(near.all() and (diff.abs() <= 1).all())


def deployed_code_flips(q, l1, v, gs, s, *, n: int, p: int) -> tuple[int, bool]:
    """One deployed matrix held to the plain quantizer: ``q`` and ``l1`` as
    the deploy made them from ``v`` with ``gs``/``s``; the codes are
    recomputed with ``a2q_quantize_plain`` (``a2q_int_weights``'
    arithmetic) on ``v``'s device, and ``code_flips_explained`` returns
    ``(flips, explained)``."""
    _, q_ref, l1_ref = a2q_quantize_plain(v, gs, s, n=n, p=p, dequantize=False)
    return code_flips_explained(q, q_ref, v, gs, l1, l1_ref)


@functools.cache
def _bind():
    from repro_torch.kernels._build import load

    fn = load("a2q_quantize").a2q_quantize_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 4
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def a2q_quantize_cuda(v, gs, s, *, n: int, p: int, dequantize: bool = True):
    """Launch the CUDA kernel on the current stream.  ``v (K, C)`` is a
    contiguous fp32 tensor on a CUDA device, ``gs`` and ``s`` contiguous fp32
    ``(C,)`` on the same device; ``-128 <= n <= p <= 127``.  Returns
    ``(deq fp32 (K, C) or None, q int8 (K, C), l1 fp32 (C,))``: the kernel
    writes ``deq`` only when ``dequantize``.  ``a2q_split`` picks the strip,
    the cluster's split of the rows and the chunk from the shape.  Every
    launch adds one to ``a2q_quantize_cuda.launches``."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"a2q_quantize_cuda needs CUDA tensors, got {dev}")
    if v.ndim != 2 or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError(f"a2q_quantize_cuda: v must be a contiguous fp32 (K, C) tensor, got "
                         f"{v.dtype} {tuple(v.shape)}")
    K, C = v.shape
    for name, t in (("gs", gs), ("s", s)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (C,) or \
                not t.is_contiguous():
            raise ValueError(f"a2q_quantize_cuda: {name} must be a contiguous fp32 ({C},) tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not -128 <= n <= p <= 127:
        raise ValueError(f"a2q_quantize_cuda: codes [{n}, {p}] do not fit int8")
    deq = torch.empty((K, C), dtype=torch.float32, device=dev) if dequantize else None
    q = torch.empty((K, C), dtype=torch.int8, device=dev)
    l1 = torch.empty((C,), dtype=torch.float32, device=dev)
    if K * C == 0:
        return deq, q, l1.fill_(1e-12)
    strip, splits, chunk, resident = a2q_split(K, C, _sm_count(dev.index))
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(gs.data_ptr()),
                     ctypes.c_void_p(s.data_ptr()), K, C, n, p,
                     None if deq is None else ctypes.c_void_p(deq.data_ptr()),
                     ctypes.c_void_p(q.data_ptr()),
                     ctypes.c_void_p(l1.data_ptr()), ctypes.c_void_p(stream),
                     strip, splits, chunk, int(resident))
    if err != 0:
        raise RuntimeError(f"a2q_quantize kernel launch failed: cudaError {err}")
    a2q_quantize_cuda.launches += 1
    return deq, q, l1


a2q_quantize_cuda.launches = 0
