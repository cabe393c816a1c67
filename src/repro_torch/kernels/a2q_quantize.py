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
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.a2q import a2q_codes

__all__ = ["a2q_quantize_plain", "a2q_quantize_cuda", "code_flips_explained", "deployed_code_flips"]


def a2q_quantize_plain(v, gs, s, *, n: int, p: int, dequantize: bool = True):
    """The quantizer in PyTorch, on any device, with ``a2q_int_weights``'
    arithmetic (``core.a2q.a2q_codes``): returns ``(deq fp32 or None, q
    int8, l1 fp32 (C,))``, ``deq`` only when ``dequantize``."""
    q, l1 = a2q_codes(v, gs, n, p)
    return (q * s if dequantize else None), q.to(torch.int8), l1


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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    return fn


def a2q_quantize_cuda(v, gs, s, *, n: int, p: int, dequantize: bool = True):
    """Launch the CUDA kernel on the current stream.  ``v (K, C)`` is a
    contiguous fp32 tensor on a CUDA device, ``gs`` and ``s`` contiguous fp32
    ``(C,)`` on the same device; ``-128 <= n <= p <= 127``.  Returns
    ``(deq fp32 (K, C) or None, q int8 (K, C), l1 fp32 (C,))``: the kernel
    writes ``deq`` only when ``dequantize``.  Every launch adds
    one to ``a2q_quantize_cuda.launches``."""
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
    launch = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(gs.data_ptr()),
                     ctypes.c_void_p(s.data_ptr()), K, C, n, p,
                     None if deq is None else ctypes.c_void_p(deq.data_ptr()),
                     ctypes.c_void_p(q.data_ptr()),
                     ctypes.c_void_p(l1.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"a2q_quantize kernel launch failed: cudaError {err}")
    a2q_quantize_cuda.launches += 1
    return deq, q, l1


a2q_quantize_cuda.launches = 0
