"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA card (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: int_matmul — exact (integer carry, and the fused epilogue rounds
the multiply and the add once each, as the plain version does), also with
the quantizing prologue, whose codes must equal the standalone act-quant's,
and with the requantizing epilogue (int8 codes out, bit for bit);
paged attention — 1e-5 with fp32, int8 and int4 pools (fp32 softmax summed
in another order; integer codes dequantize exactly as in the plain version),
one bf16 rounding of the output (2^-6, one ulp at |o| < 2) with bf16 pools
or a bf16 query; MLA latent attention — 2e-5 (fp32 output; bf16 pools and
dequantized codes convert to fp32 exactly, so only the summation order
differs; the tensor-core kernel for bf16, int8 and int4 pools keeps fp32
precision with q in three bf16 terms), and exactly on a row of length 1,
whose output is the staged latent itself (the activation fake-quant
replay's codes times its scale), on every run split the cluster takes.
A block past a row's length holds NaN (in the pool, or in the scale pool of
an integer pool) and must not be read.  rwkv6_scan — 1e-5 of the largest
|y| and |S| with fp32 y (the step kernel: the same fp32 recurrence, its
64-deep sums split in four and contracted into FMAs; the chunked kernel:
Finch's matrix form, its products on the bf16 tensor cores in hi / mid /
lo terms, ~2^-16 of each term), 2^-7 of the largest |y| with bf16 y (one
bf16 rounding of values that differ in their last fp32 bits).  The gelu
requant epilogue — codes exact, or one apart only where a ``tanh`` 4 ulps
off PyTorch's could move the code (``requant_ties``: the kernel's ``tanhf``
against PyTorch's ``tanh``).  a2q_quantize — l1, codes and dequantized
weights exact (both sides sum in ``core.a2q.pairwise_sum``'s fp32 order),
on every strip width and cluster split the kernel takes, and every column
within the A2Q l1 budget.  flash_attention — 2e-5 in
fp32 (the softmax summed in another order), plus one bf16 ulp of the output
in bf16, on the CUDA cores (fp32) and the tensor cores (bf16).
"""

import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.a2q import _effective_gs
from repro_torch.core.bounds import l1_budget
from repro_torch.kernels.a2q_quantize import (
    a2q_quantize_cuda,
    a2q_quantize_plain,
    code_flips_explained,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.int_matmul import (
    int_matmul_cuda,
    int_matmul_plain,
    prologue_codes,
    requant_ties,
)
from repro_torch.kernels.ops import int_matmul_block_k
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
from repro_torch.kernels.paged_mla_attention import (
    paged_mla_attention_cuda,
    paged_mla_attention_plain,
)
from repro_torch.kernels.rwkv6_scan import CHUNK_MIN_T, rwkv6_scan_cuda, rwkv6_scan_plain
from repro_torch.nn.linear import init_linear

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode,acc_bits,spill", [
    ("exact", 32, False), ("exact", 16, True), ("wrap", 16, True), ("saturate", 16, True),
    ("saturate", 12, False), ("wrap", 20, False),
])
def test_int_matmul_cuda_matches_plain(dev, mode, acc_bits, spill):
    """Full-range weights, every carry mode, on the decode kernel (M <= 16)
    and the tensor-core kernel (M > 16): tiles crossed in M, ragged last
    reference K-tiles (K 100, 1000, 1280), N off the 128-column tile, rows
    16-byte aligned (cp.async) or not (K 100, 1000; N 200)."""
    rng = np.random.default_rng(7)
    for M, K, N in ((1, 576, 192), (8, 1536, 576), (64, 576, 1536), (33, 100, 70), (3, 40, 5),
                    (17, 100, 200), (200, 1000, 336), (200, 1280, 200), (17, 1280, 336),
                    (200, 1280, 1536)):
        x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
        kw = dict(acc_bits=acc_bits, mode=mode, block_k=int_matmul_block_k(K), spill_int16=spill)
        got = int_matmul_cuda(x, w, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, int_matmul_plain(x, w, **kw)), (M, K, N)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, N).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        offset = torch.from_numpy(rng.integers(-1000, 1000, N).astype(np.int32)).to(dev)
        got = int_matmul_cuda(x, w, scale, bias, offset, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, int_matmul_plain(x, w, scale, bias, offset, **kw)), (M, K, N)


def test_int_matmul_cuda_picks_the_kernel_by_rows(dev):
    """The wrapper's route: the tensor cores from TC_MIN_ROWS rows, the
    split-K decode kernel below; both agree with the plain version on either
    side of the edge."""
    from repro_torch.kernels.int_matmul import TC_MIN_ROWS

    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.integers(-128, 128, (1280, 336)).astype(np.int8)).to(dev)
    for M in (TC_MIN_ROWS - 1, TC_MIN_ROWS):
        x = torch.from_numpy(rng.integers(-128, 128, (M, 1280)).astype(np.int8)).to(dev)
        before = int_matmul_cuda.tc_launches
        got = int_matmul_cuda(x, w, block_k=512)
        torch.cuda.synchronize()
        assert int_matmul_cuda.tc_launches - before == (M >= TC_MIN_ROWS)
        assert torch.equal(got, int_matmul_plain(x, w, block_k=512)), M


def _int_matmul_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.int_matmul")


@pytest.mark.parametrize("mode,acc_bits,spill", [
    ("exact", 32, False), ("exact", 16, True), ("wrap", 16, True), ("wrap", 20, False),
    ("saturate", 16, True), ("saturate", 12, False),
])
@pytest.mark.parametrize("splits", [2, 3, 4])
def test_int_matmul_cuda_decode_forced_splits(dev, monkeypatch, mode, acc_bits, spill, splits):
    """The decode kernel at M = 1, 8, 16 with the split count forced above
    one (``saturate`` keeps one split): bit for bit the plain version and the
    split-K emulation, on int8 x, behind the prologue, and with the requant
    epilogue; full-range weights, ragged K tiles and N off the 128-column
    strip."""
    im = _int_matmul_module()
    monkeypatch.setattr(im, "split_k", lambda *shape: splits)
    rng = np.random.default_rng(30 + splits)
    for M, K, N in ((1, 1536, 576), (8, 1300, 200), (16, 2048, 336), (8, 576, 1536)):
        x8 = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
        xf = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32) * 3).to(dev)
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, N).astype(np.float32)).to(dev)
        kw = dict(acc_bits=acc_bits, mode=mode, block_k=int_matmul_block_k(K), spill_int16=spill)
        pro = dict(aq_scale=torch.tensor([2.0**-5], device=dev), q_lo=-128, q_hi=127, q_shift=0)
        before = int_matmul_cuda.split_launches
        for x, extra in ((x8, {}), (xf, pro), (xf.bfloat16(), pro)):
            for sc in (None, scale):
                got = int_matmul_cuda(x, w, sc, **kw, **extra)
                torch.cuda.synchronize()
                assert torch.equal(got, int_matmul_plain(x, w, sc, **kw, **extra)), (M, K, N)
                assert torch.equal(got, im.int_matmul_split_plain(x, w, sc, splits=splits, **kw,
                                                                  **extra)), (M, K, N)
        if mode == "exact":
            y = int_matmul_plain(xf, w, scale, **kw, **pro).clamp_min(0) ** 2
            req = dict(out_scale=(y.amax(0) / 200 + 1e-6).float(), r_lo=0, r_hi=255, r_shift=128,
                       act_fn="relu2", cast_dtype=torch.bfloat16)
            got = int_matmul_cuda(xf, w, scale, **kw, **pro, **req)
            torch.cuda.synchronize()
            assert torch.equal(got, int_matmul_plain(xf, w, scale, **kw, **pro, **req))
        split = mode != "saturate" or acc_bits >= 32
        assert (int_matmul_cuda.split_launches > before) == split


def test_int_matmul_cuda_decode_graph_replay_and_no_sync(dev):
    """The decode kernel over several splits inside a CUDA graph: two
    replays give the plain version's output both times (the splits meet in
    a thread-block cluster; nothing is kept between launches), and the calls
    make no host sync."""
    rng = np.random.default_rng(41)
    M, K, N = 8, 4096, 4096
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, N).astype(np.float32)).to(dev)
    kw = dict(acc_bits=16, mode="wrap", block_k=int_matmul_block_k(K), spill_int16=True,
              aq_scale=torch.tensor([2.0**-5], device=dev), q_lo=-128, q_hi=127, q_shift=0)
    want = int_matmul_plain(x, w, scale, **kw)
    before = int_matmul_cuda.split_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = int_matmul_cuda(x, w, scale, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int_matmul_cuda.split_launches > before
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = int_matmul_cuda(x, w, scale, **kw)
    got = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        got.append(out.clone())
    assert torch.equal(first, want) and torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, True)])
def test_int_matmul_cuda_prologue_matches_plain(dev, bits, signed):
    """fp32 and bf16 activations quantized on the card (in the decode
    kernel's staging, or the tensor-core route's codes pass): the output
    equals the plain version's and the kernel run on the standalone
    act-quant's codes."""
    rng = np.random.default_rng(11)
    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed else (0, (1 << bits) - 1)
    shift = 128 if not signed and bits == 8 else 0
    s = torch.tensor([2.0**-5], device=dev)
    for (M, K, N), dt in itertools.product(
            ((1, 576, 192), (8, 1536, 576), (64, 576, 1536), (33, 100, 70), (3, 40, 5),
             (200, 1000, 336), (200, 1280, 200)), (torch.float32, torch.bfloat16)):
        x = rng.normal(size=(M, K)).astype(np.float32) * 3
        ties = rng.random((M, K)) < 0.1
        x[ties] = (rng.integers(-140, 140, ties.sum()) + 0.5) * 2.0**-5
        x = torch.from_numpy(np.abs(x) if not signed else x).to(dev, dt)
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, N).astype(np.float32)).to(dev)
        kw = dict(acc_bits=32, mode="exact", block_k=int_matmul_block_k(K))
        pro = dict(aq_scale=s, q_lo=lo, q_hi=hi, q_shift=shift)
        got = int_matmul_cuda(x, w, scale, **kw, **pro)
        torch.cuda.synchronize()
        assert torch.equal(got, int_matmul_plain(x, w, scale, **kw, **pro)), (M, K, N, dt)
        codes = prologue_codes(x, s, lo, hi, shift)
        assert torch.equal(got, int_matmul_cuda(codes, w, scale, **kw)), (M, K, N, dt)
        if dt == torch.bfloat16:  # bf16 widens exactly: the fp32 call's output
            assert torch.equal(got, int_matmul_cuda(x.float(), w, scale, **kw, **pro))


def _paged_case(dev, dtype):
    rng = np.random.default_rng(8)
    B, H, KV, Dh, NB, bs, MB = 5, 8, 2, 16, 12, 4, 3
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(NB, bs, KV, Dh)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(NB, bs, KV, Dh)).astype(np.float32))
    bt = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0], [9, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([12, 9, 0, 5, 1], dtype=torch.int32)
    return [t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for t in (q, kp, vp, bt, lengths)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 3])
def test_paged_attention_cuda_matches_plain(dev, dtype, window):
    args = _paged_case(dev, dtype)
    got = paged_attention_cuda(*args, window=window)
    torch.cuda.synchronize()
    want = paged_attention_plain(*args, window=window)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert (got[2] == 0).all()


def _quantize_pools(kp, vp, bits):
    """Integer pools of the same shape: codes, packed for int4, and fp32
    per-slot scales."""
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    out = []
    for p in (kp, vp):
        codes, sc = _kv_quantize(p.float(), bits=bits)
        out.append((_pack_nibbles(codes) if bits == 4 else codes, sc))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 3])
def test_paged_attention_cuda_int_pools_match_plain(dev, bits, q_dtype, window):
    q, kp, vp, bt, lengths = _paged_case(dev, torch.float32)
    q = q.to(q_dtype)
    kq, vq, ks, vs = _quantize_pools(kp, vp, bits)
    got = paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs, window=window)
    torch.cuda.synchronize()
    want = paged_attention_plain(q, kq, vq, bt, lengths, ks, vs, window=window)
    tol = 1e-5 if q_dtype == torch.float32 else 2.0**-6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert (got[2] == 0).all()
    # a NaN scale block behind a table entry past row 4's length is never read
    ks_nan, bt_past = ks.clone(), bt.clone()
    ks_nan[10] = float("nan")
    bt_past[4, 1] = 10
    again = paged_attention_cuda(q, kq, vq, bt_past, lengths, ks_nan, vs, window=window)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def _served_case(dev, dtype, B=32, H=9, KV=3, Dh=64, bs=16, MB=128, seed=14):
    """SmolLM-135M's 2048-token context: B rows of lengths in [1536, 2048]
    drawn from the seed, every table entry past a row's length pointing at
    one block of NaN (never to be read)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1536, 2049, B).astype(np.int32)
    NB = B * MB + 2
    bt = rng.permutation(np.arange(1, NB - 1))[: B * MB].reshape(B, MB).astype(np.int32)
    bt[np.arange(MB)[None, :] >= -(-lengths[:, None] // bs)] = NB - 1
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32)).to(dev, dtype)
    kp, vp = (torch.from_numpy(rng.normal(size=(NB, bs, KV, Dh)).astype(np.float32)).to(dev)
              for _ in range(2))
    return q, kp, vp, torch.from_numpy(bt).to(dev), torch.from_numpy(lengths).to(dev)


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("window", [None, 700])
def test_paged_attention_cuda_served_context(dev, pool, window):
    """The 2048-token context, split over several runs, for every pool type:
    within the tolerance of the plain version, and the NaN block behind the
    entries past each length (in the pool, or its scale pool) never read."""
    from repro_torch.kernels.paged_attention import split_kv

    q_dtype = torch.float32 if pool == "fp32" else torch.bfloat16
    q, kp, vp, bt, lengths = _served_case(dev, q_dtype)
    NB = kp.shape[0]
    if pool in ("fp32", "bf16"):
        kp, vp = kp.to(q_dtype), vp.to(q_dtype)
        args = (kp, vp, bt, lengths)
        poisoned = (kp.clone(), vp.clone(), bt, lengths)
        poisoned[0][NB - 1] = poisoned[1][NB - 1] = float("nan")
    else:
        kq, vq, ks, vs = _quantize_pools(kp, vp, 8 if pool == "int8" else 4)
        args = (kq, vq, bt, lengths, ks, vs)
        poisoned = (kq, vq, bt, lengths, ks.clone(), vs.clone())
        poisoned[4][NB - 1] = poisoned[5][NB - 1] = float("nan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert split_kv(32, 3, 3, 128, 16, sms) > 1
    before = paged_attention_cuda.split_launches
    got = paged_attention_cuda(q, *args, window=window)
    torch.cuda.synchronize()
    assert paged_attention_cuda.split_launches == before + 1
    want = paged_attention_plain(q, *args, window=window)
    tol = 1e-5 if q_dtype == torch.float32 else 2.0**-6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    again = paged_attention_cuda(q, *poisoned, window=window)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_paged_attention_cuda_forced_splits(dev, monkeypatch, G, splits):
    """Forced split counts (empty runs included: short rows, a zero-length
    row, a window) and G query heads a KV head, against the plain version and
    the split-KV emulation."""
    import importlib

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    monkeypatch.setattr(pa, "split_kv", lambda *shape: splits)
    rng = np.random.default_rng(50 + G)
    B, KV, Dh, bs, MB = 5, 2, 64, 16, 7
    H = G * KV
    NB = B * MB + 1
    q = torch.from_numpy(rng.normal(size=(B, H, Dh)).astype(np.float32)).to(dev)
    kp, vp = (torch.from_numpy(rng.normal(size=(NB, bs, KV, Dh)).astype(np.float32)).to(dev)
              for _ in range(2))
    bt = torch.from_numpy(rng.permutation(np.arange(1, NB))[: B * MB].reshape(B, MB)
                          .astype(np.int32)).to(dev)
    lengths = torch.tensor([0, 1, 40, 97, 112], dtype=torch.int32, device=dev)
    for window in (None, 30):
        got = paged_attention_cuda(q, kp, vp, bt, lengths, window=window)
        torch.cuda.synchronize()
        want = paged_attention_plain(q, kp, vp, bt, lengths, window=window)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        emu = pa.paged_attention_split_plain(q, kp, vp, bt, lengths, splits=splits, window=window)
        torch.testing.assert_close(got, emu, rtol=0, atol=1e-5)
        assert (got[0] == 0).all()


def test_paged_attention_cuda_graph_replay_and_no_sync(dev):
    """The split kernel inside a CUDA graph: two replays give the same
    output, bit for bit, as the eager call (nothing is kept between launches and
    the splits merge in a fixed order), and the calls make no host sync."""
    q, kp, vp, bt, lengths = _served_case(dev, torch.bfloat16, B=8, seed=15)
    kq, vq, ks, vs = _quantize_pools(kp, vp, 8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs)
        second = paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = paged_attention_cuda(q, kq, vq, bt, lengths, ks, vs)
    got = []
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        got.append(out.clone())
    assert torch.equal(first, second) and torch.equal(got[0], first) and torch.equal(got[1], first)


def _mla_case(dev, dtype, B, H, R, P, bs, lens):
    rng = np.random.default_rng(9)
    MB = -(-max(lens) // bs) + 1
    NB = B * MB + 2
    bt = np.zeros((B, MB), np.int32)
    ids = iter(rng.permutation(np.arange(1, NB - 1)))
    for b, ln in enumerate(lens):
        for j in range(-(-ln // bs)):
            bt[b, j] = next(ids)
    bt[0, -1] = NB - 1  # past row 0's length: a block that must never be read
    q_lat = torch.from_numpy(rng.normal(size=(B, H, R)).astype(np.float32)).to(dev)
    q_pe = torch.from_numpy(rng.normal(size=(B, H, P)).astype(np.float32)).to(dev)
    ckvp = torch.from_numpy(rng.normal(size=(NB, bs, R)).astype(np.float32)).to(dev, dtype)
    kpep = torch.from_numpy(rng.normal(size=(NB, bs, P)).astype(np.float32)).to(dev, dtype)
    return (q_lat, q_pe, ckvp, kpep, torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("shape", [(5, 12, 32, 8, 4), (8, 128, 512, 64, 16)],
                         ids=["small", "deepseek"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
def test_paged_mla_attention_cuda_matches_plain(dev, shape, dtype, act_quant):
    B, H, R, P, bs = shape
    lens = [7, 1, 0, 2 * bs + 3, 3 * bs, bs - 1, 1, 4 * bs][:B]
    args = _mla_case(dev, dtype, B, H, R, P, bs, lens)
    kw = dict(scale=192**-0.5)
    if act_quant:
        kw.update(aq_scale=torch.tensor([0.02], device=dev), act_bits=8)
    got = paged_mla_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = paged_mla_attention_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert (got[2] == 0).all()  # length 0
    assert torch.equal(got[1], want[1])  # length 1: the (replayed) latent, exactly
    ckvp = args[2].clone()
    ckvp[-1] = float("nan")  # the block past row 0's length
    again = paged_mla_attention_cuda(*args[:2], ckvp, *args[3:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.parametrize("shape", [(5, 12, 32, 16, 4), (8, 128, 512, 64, 16)],
                         ids=["small", "deepseek"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
def test_paged_mla_attention_cuda_int_pools_match_plain(dev, shape, bits, act_quant):
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    B, H, R, P, bs = shape
    lens = [7, 1, 0, 2 * bs + 3, 3 * bs, bs - 1, 1, 4 * bs][:B]
    q_lat, q_pe, ckv, kpe, bt, lengths = _mla_case(dev, torch.float32, B, H, R, P, bs, lens)
    pools = []
    for p in (ckv, kpe):
        codes, sc = _kv_quantize(p, bits=bits)
        pools.append((_pack_nibbles(codes) if bits == 4 else codes, sc))
    (ckvq, ckvs), (kpeq, kpes) = pools
    kw = dict(scale=192**-0.5)
    if act_quant:
        kw.update(aq_scale=torch.tensor([0.02], device=dev), act_bits=8)
    got = paged_mla_attention_cuda(q_lat, q_pe, ckvq, kpeq, bt, lengths, ckvs, kpes, **kw)
    torch.cuda.synchronize()
    want = paged_mla_attention_plain(q_lat, q_pe, ckvq, kpeq, bt, lengths, ckvs, kpes, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert (got[2] == 0).all()  # length 0
    assert torch.equal(got[1], want[1])  # length 1: the dequantized (replayed) latent, exactly
    ckvs_nan = ckvs.clone()
    ckvs_nan[-1] = float("nan")  # the scales of the block past row 0's length
    again = paged_mla_attention_cuda(q_lat, q_pe, ckvq, kpeq, bt, lengths, ckvs_nan, kpes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


def test_paged_mla_attention_cuda_refuses_quantized_pools(dev):
    """Malformed integer pools are refused: without their scale pools, with
    mismatched code types, or with float scale pools of the wrong shape."""
    args = list(_mla_case(dev, torch.float32, 2, 8, 32, 8, 4, [5, 3]))
    codes = [a.to(torch.int8) for a in args[2:4]]
    scales = torch.full(args[2].shape[:2], 0.01, device=dev)
    with pytest.raises(ValueError):
        ops.paged_mla_attention(*args[:2], *codes, *args[4:], scale=0.1)
    with pytest.raises(ValueError):
        ops.paged_mla_attention(*args[:2], codes[0], codes[1].to(torch.uint8), *args[4:],
                                ckvs=scales, kpes=scales, scale=0.1)
    with pytest.raises(ValueError):
        ops.paged_mla_attention(*args[:2], *codes, *args[4:], ckvs=scales[:, :2],
                                kpes=scales[:, :2], scale=0.1)


@pytest.mark.parametrize("act_fn", [None, "relu2"], ids=["none", "relu2"])
@pytest.mark.parametrize("cast", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("out_bits,out_signed", [(8, False), (8, True), (4, True)])
@pytest.mark.parametrize("prologue", [False, True], ids=["int8_x", "prologue"])
def test_int_matmul_cuda_requant_matches_plain(dev, act_fn, cast, out_bits, out_signed, prologue):
    """The requant epilogue's int8 codes equal the plain version's bit for
    bit, on int8 codes and behind the prologue, at rwkv6's cm.wk shape and
    small ragged ones."""
    rng = np.random.default_rng(13)
    lo, hi = (-(1 << (out_bits - 1)), (1 << (out_bits - 1)) - 1) if out_signed else \
        (0, (1 << out_bits) - 1)
    shift = 128 if not out_signed and out_bits == 8 else 0
    for M, K, N in ((8, 4096, 14336), (32, 4096, 1024), (33, 100, 70), (3, 40, 5),
                    (200, 1000, 336), (200, 1280, 200)):
        w = torch.from_numpy(rng.integers(-3, 4, (K, N)).astype(np.int8)).to(dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, N).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        if prologue:
            x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
            pro = dict(aq_scale=torch.tensor([2.0**-5], device=dev), q_lo=-128, q_hi=127,
                       q_shift=0)
        else:
            x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
            pro = {}
        y = int_matmul_plain(x, w, scale, bias, block_k=int_matmul_block_k(K), **pro)
        y = y.clamp_min(0) ** 2 if act_fn == "relu2" else y
        out_scale = (y.abs().amax(0) / (0.7 * hi) + 1e-6).to(torch.float32)
        kw = dict(acc_bits=32, mode="exact", block_k=int_matmul_block_k(K), out_scale=out_scale,
                  r_lo=lo, r_hi=hi, r_shift=shift, act_fn=act_fn, cast_dtype=cast, **pro)
        got = int_matmul_cuda(x, w, scale, bias, **kw)
        torch.cuda.synchronize()
        want = int_matmul_plain(x, w, scale, bias, **kw)
        assert got.dtype == torch.int8
        assert torch.equal(got, want), (M, K, N, (got != want).sum().item())
        if M * N > 1000:
            assert len(torch.unique(got)) > 4  # the codes span their range


def _rwkv6_case(dev, B, H, T, D, dtype, seed, heads_view=True):
    """r, k, v in ``dtype`` and fp32 w as the time-mix makes them: (B, H, T, D)
    head views of (B, T, H * D) projections."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(t):
        return t.reshape(B, T, H, D).transpose(1, 2) if heads_view else \
            t.reshape(B, T, H, D).transpose(1, 2).contiguous()

    r, k, v = (heads(torch.randn((B, T, H * D), generator=g, device=dev).to(dtype))
               for _ in range(3))
    w = heads(torch.exp(-torch.exp(torch.randn((B, T, H * D), generator=g, device=dev) - 0.6)))
    u = torch.randn((H, D), generator=g, device=dev) * 0.5
    s0 = torch.randn((B, H, D, D), generator=g, device=dev)
    return r, k, v, w, u, s0


def _rwkv6_close(got, want, out_dtype):
    (y, s), (y_p, s_p) = got, want
    rel = 1e-5 if out_dtype == torch.float32 else 2.0**-7
    assert y.dtype == y_p.dtype == out_dtype
    assert (y.float() - y_p.float()).abs().max().item() <= rel * y_p.float().abs().max().item()
    assert (s - s_p).abs().max().item() <= 1e-5 * s_p.abs().max().item()


@pytest.mark.parametrize("case", [
    # (B, H, T, D, in dtype, out dtype, floor, carried, zero decays): rwkv6-7b's
    # decode, prefill chunk and chunked T=64, then reduced and ragged shapes;
    # the step kernel's last T and the chunked kernel's first; a long
    # prompt's engine chunk and a whole 4096-token prompt; decays of exactly
    # 0 in some channels, floored and not
    (8, 64, 1, 64, torch.bfloat16, torch.float32, False, True, False),
    (1, 64, 32, 64, torch.bfloat16, torch.bfloat16, False, True, False),
    (1, 64, 64, 64, torch.bfloat16, torch.bfloat16, True, False, False),
    (2, 4, 8, 16, torch.float32, torch.float32, True, True, False),
    (3, 5, 37, 24, torch.float32, torch.float32, False, False, False),
    (1, 64, CHUNK_MIN_T - 1, 64, torch.bfloat16, torch.float32, False, True, False),
    (1, 64, CHUNK_MIN_T, 64, torch.bfloat16, torch.float32, False, True, False),
    (1, 64, 512, 64, torch.bfloat16, torch.bfloat16, True, True, False),
    (1, 64, 4096, 64, torch.bfloat16, torch.bfloat16, True, False, False),
    (2, 3, 45, 24, torch.bfloat16, torch.float32, False, True, False),
    (1, 8, 200, 64, torch.bfloat16, torch.float32, False, True, True),
    (1, 8, 200, 64, torch.bfloat16, torch.float32, True, True, True),
], ids=["decode", "prefill32", "chunk64_floor", "reduced", "ragged", "below_threshold",
        "threshold", "t512", "t4096", "ragged_bf16", "zero_decays", "zero_decays_floor"])
def test_rwkv6_scan_cuda_matches_plain(dev, case):
    """Both kernels against the plain recurrence: T below ``CHUNK_MIN_T`` on
    the step kernel, from it on the chunked one (read from the wrapper's
    counters); strided head views, then contiguous inputs through ops with
    the state updated in place."""
    B, H, T, D, dt, out_dtype, floor, carried, zero_w = case
    r, k, v, w, u, s0 = _rwkv6_case(dev, B, H, T, D, dt, seed=T + D)
    if floor:
        w[..., ::7] = 1e-5  # below e^-8, where the floor acts
    if zero_w:
        w[..., 1::5] = 0.0
    kw = dict(out_dtype=out_dtype, min_w=math.exp(-8.0) if floor else None)
    init = s0 if carried else None
    want = rwkv6_scan_plain(r, k, v, w, u, init, **kw)
    launches, chunked = rwkv6_scan_cuda.launches, rwkv6_scan_cuda.chunked_launches
    got = rwkv6_scan_cuda(r, k, v, w, u, init, **kw)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == launches + 1
    assert rwkv6_scan_cuda.chunked_launches == chunked + (T >= CHUNK_MIN_T)
    assert torch.isfinite(got[0].float()).all()
    _rwkv6_close(got, want, out_dtype)
    # the same through ops, contiguous inputs, the state updated in place
    rc, kc, vc, wc = (t.contiguous() for t in (r, k, v, w))
    state = s0.clone() if carried else torch.zeros_like(s0)
    y, s = ops.rwkv6_scan(rc, kc, vc, wc, u, state, state_out=state, **kw)
    torch.cuda.synchronize()
    assert s is state
    _rwkv6_close((y, s), want, out_dtype)


def test_rwkv6_scan_cuda_refuses_bad_arguments(dev):
    r, k, v, w, u, s0 = _rwkv6_case(dev, 1, 2, 3, 16, torch.float32, seed=1)
    with pytest.raises(ValueError):  # fp32 decays
        rwkv6_scan_cuda(r, k, v, w.half(), u, out_dtype=torch.float32)
    with pytest.raises(ValueError):  # a strided feature axis
        rwkv6_scan_cuda(r[..., ::2], k[..., ::2], v[..., ::2], w[..., ::2], u[:, ::2],
                        out_dtype=torch.float32)
    big = torch.zeros((1, 1, 2, 80), device=dev)
    with pytest.raises(ValueError):  # head dims above 64
        rwkv6_scan_cuda(big, big, big, big, torch.zeros((1, 80), device=dev),
                        out_dtype=torch.float32)
    with pytest.raises(ValueError):  # the state is contiguous fp32
        rwkv6_scan_cuda(r, k, v, w, u, s0.transpose(-1, -2), out_dtype=torch.float32)


@pytest.mark.parametrize("cast", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("prologue", [False, True], ids=["int8_x", "prologue"])
def test_int_matmul_cuda_gelu_requant_matches_plain(dev, cast, prologue):
    """The non-gated MLP's chained edge (biased, gelu replayed, signed 8-bit
    codes out) at hubert's mlp.w_in (M = 8 clips x 1000 frames, K 1280, N
    5120) and small ragged shapes."""
    rng = np.random.default_rng(17)
    for M, K, N in ((8000, 1280, 5120), (200, 1000, 336), (200, 1280, 200), (33, 100, 70),
                    (3, 40, 5)):
        w = torch.from_numpy(rng.integers(-3, 4, (K, N)).astype(np.int8)).to(dev)
        scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, N).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        if prologue:
            x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
            pro = dict(aq_scale=torch.tensor([2.0**-5], device=dev), q_lo=-128, q_hi=127,
                       q_shift=0)
        else:
            x = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(dev)
            pro = {}
        kw = dict(acc_bits=32, mode="exact", block_k=int_matmul_block_k(K), **pro)
        y = int_matmul_plain(x, w, scale, bias, **kw)
        out_scale = (y.abs().amax(0) / 100 + 1e-6).to(torch.float32)
        req = dict(out_scale=out_scale, r_lo=-128, r_hi=127, r_shift=0, act_fn="gelu",
                   cast_dtype=cast)
        got = int_matmul_cuda(x, w, scale, bias, **kw, **req)
        torch.cuda.synchronize()
        want = int_matmul_plain(x, w, scale, bias, **kw, **req)
        diff = got.to(torch.int32) - want.to(torch.int32)
        ties = requant_ties(y, out_scale, "gelu", cast)
        assert got.dtype == torch.int8
        assert diff.abs().max().item() <= 1 and not (diff != 0)[~ties].any(), \
            (M, K, N, (diff != 0).sum().item())
        if M * N > 1000:
            assert len(torch.unique(got)) > 50  # the codes span their range


@pytest.mark.parametrize("K,C", [(1280, 504), (5120, 1280), (17, 5), (300, 130), (1, 40),
                                 (4, 9), (7168, 2048), (18432, 64)])
def test_a2q_quantize_cuda_matches_plain(dev, K, C):
    """hubert's head and w_out shapes, deepseek's expert and dense w_out
    depths, small ragged ones and K below the 8 row groups, from the A2Q
    initializer (P = 16, signed 8-bit inputs)."""
    quant = get_arch("hubert-xlarge").quant
    p = init_linear(torch.Generator(device=dev).manual_seed(K + C), K, C, quant)
    gs, s = _effective_gs(p, quant.acc_bits, quant.act_bits, True)
    deq, q, l1 = a2q_quantize_cuda(p["v"], gs, s, n=-128, p=127)
    torch.cuda.synchronize()
    deq_p, q_p, l1_p = a2q_quantize_plain(p["v"], gs, s, n=-128, p=127)
    # one fp32 sum order on both sides (core.a2q.pairwise_sum): bit for bit
    assert torch.equal(l1, l1_p) and torch.equal(q, q_p) and torch.equal(deq, deq_p)
    assert code_flips_explained(q, q_p, p["v"], gs, l1, l1_p) == (0, True)
    assert (q.to(torch.int64).abs().sum(0) <= l1_budget(quant.acc_bits, quant.act_bits, True)).all()
    q_o, s_o = ops.a2q_quantize(p["v"], p["t"], p["d"], weight_bits=8, acc_bits=quant.acc_bits,
                                input_bits=quant.act_bits, input_signed=True)
    _, q_n, _ = a2q_quantize_cuda(p["v"], gs, s, n=-128, p=127, dequantize=False)
    torch.cuda.synchronize()
    assert torch.equal(q_o, q) and torch.equal(q_n, q) and torch.equal(q_o * s_o, deq)


def test_a2q_quantize_cuda_budget_with_norms_over_the_cap(dev):
    """Norms over the cap (t above T), unsigned 8-bit inputs, P = 14, a short
    K whose codes come close to the budget: every column stays within it."""
    g = torch.Generator(device=dev).manual_seed(3)
    for K in (24, 640):
        v = torch.randn((K, 256), generator=g, device=dev)
        t = torch.randn((256,), generator=g, device=dev) + 6
        d = torch.randn((256,), generator=g, device=dev) - 5
        q, _ = ops.a2q_quantize(v, t, d, weight_bits=8, acc_bits=14, input_bits=8,
                                input_signed=False)
        torch.cuda.synchronize()
        assert (q.to(torch.int64).abs().sum(0) <= l1_budget(14, 8, False)).all()


def _flash_close(got, want):
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    tol = 2e-5
    if want.dtype == torch.bfloat16:  # plus one bf16 rounding of the output
        tol = tol + torch.ldexp(torch.ones_like(w), torch.frexp(torch.maximum(g.abs(),
                                                                              w.abs())).exponent - 8)
    assert ((g - w).abs() <= tol).all(), (g - w).abs().max().item()


@pytest.mark.parametrize("case", [
    # (B, H, KV, Tq, Tk, D, causal, window)
    (2, 16, 16, 100, 100, 80, False, None),   # hubert's heads, bidirectional
    (2, 9, 3, 64, 64, 64, True, None),        # smollm's GQA, causal
    (1, 4, 4, 200, 200, 64, True, 64),        # sliding window
    (2, 4, 2, 16, 100, 64, True, None),       # Tq < Tk, end-aligned
    (1, 2, 2, 8, 4, 16, True, None),          # queries with no key give 0
    (1, 2, 1, 37, 70, 128, False, 20),        # window, bidirectional, D 128
    (3, 4, 4, 65, 65, 32, True, None),        # ragged tiles
], ids=["hubert", "gqa", "window", "end_aligned", "no_key", "d128", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_cuda_matches_plain(dev, case, dtype):
    B, H, KV, Tq, Tk, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Tq + D)
    # head views of (B, T, heads * D) projections, as the layer passes them
    q = torch.randn((B, Tq, H * D), generator=g, device=dev).to(dtype)
    q = q.reshape(B, Tq, H, D).transpose(1, 2)
    k, v = (torch.randn((B, Tk, KV * D), generator=g, device=dev).to(dtype)
            .reshape(B, Tk, KV, D).transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, scale=D**-0.5)
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    assert got.shape == (B, H, Tq, D)
    _flash_close(got, want)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal, window=window), got)


def test_flash_attention_cuda_refuses_bad_arguments(dev):
    q = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError):  # no kernel for D = 48
        flash_attention_cuda(q, q, q, causal=True, window=None, scale=1.0)
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError):  # one dtype
        flash_attention_cuda(q, q.bfloat16(), q.bfloat16(), causal=True, window=None, scale=1.0)
    with pytest.raises(ValueError):  # a strided feature axis
        flash_attention_cuda(q[..., ::2], q[..., ::2], q[..., ::2], causal=True, window=None,
                             scale=1.0)


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", [
    # (B, H, KV, Tq, Tk, causal, window)
    (2, 4, 2, 130, 130, True, None),   # causal GQA, a ragged last tile
    (1, 4, 4, 150, 150, True, 40),     # a sliding window
    (2, 4, 4, 20, 150, True, None),    # queries end-aligned to the keys
    (1, 2, 2, 8, 4, True, None),       # queries with no key give 0
    (2, 3, 3, 70, 200, False, None),   # bidirectional, Tq < Tk
], ids=["causal", "window", "end_aligned", "no_key", "bidirectional"])
def test_flash_attention_cuda_bf16_tensor_cores(dev, D, case):
    """bf16 head views on the tensor-core kernel at every head size: within
    2e-5 plus one bf16 ulp of the output of the plain fp32 softmax."""
    B, H, KV, Tq, Tk, causal, window = case
    g = torch.Generator(device=dev).manual_seed(Tq + Tk + D)
    q = torch.randn((B, Tq, H * D), generator=g, device=dev).bfloat16()
    q = q.reshape(B, Tq, H, D).transpose(1, 2)
    k, v = (torch.randn((B, Tk, KV * D), generator=g, device=dev).bfloat16()
            .reshape(B, Tk, KV, D).transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, scale=D**-0.5)
    before = flash_attention_cuda.tc_launches
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.tc_launches == before + 1
    _flash_close(got, flash_attention_plain(q, k, v, **kw))
    if Tq > Tk:
        assert not got[:, :, :Tq - Tk].float().abs().any()


def _a2q_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.a2q_quantize")


@pytest.mark.parametrize("K,C", [(7168, 2048), (2048, 7168), (1280, 1280), (300, 130)])
def test_a2q_quantize_cuda_forced_splits(dev, monkeypatch, K, C):
    """deepseek's expert shapes (and hubert's projection, a ragged one) on
    every strip width and cluster size the kernel takes, resident or not:
    l1, codes and dequantized weights bit for bit the plain version's."""
    aq = _a2q_module()
    quant = get_arch("hubert-xlarge").quant
    p = init_linear(torch.Generator(device=dev).manual_seed(K + 2 * C), K, C, quant)
    gs, s = _effective_gs(p, quant.acc_bits, quant.act_bits, True)
    deq_p, q_p, l1_p = a2q_quantize_plain(p["v"], gs, s, n=-128, p=127)
    tried = 0
    for strip in aq.STRIPS:
        for target in (1, 2, 3, 5, 8):
            chunk, cpb, splits = aq.cluster_shape(K, target, strip)
            for resident in (True, False):
                if resident and aq.resident_bytes(K, strip, chunk, cpb) > 200 * 1024:
                    continue
                monkeypatch.setattr(aq, "a2q_split",
                                    lambda *a, c=(strip, splits, chunk, resident): c)
                deq, q, l1 = a2q_quantize_cuda(p["v"], gs, s, n=-128, p=127)
                torch.cuda.synchronize()
                assert torch.equal(l1, l1_p) and torch.equal(q, q_p) and torch.equal(deq, deq_p)
                tried += 1
    assert tried >= 20


def test_a2q_quantize_cuda_graph_replay_and_no_sync(dev):
    """The split kernel keeps no state between launches: two CUDA-graph
    replays equal the eager call, and a launch makes no host sync."""
    quant = get_arch("hubert-xlarge").quant
    p = init_linear(torch.Generator(device=dev).manual_seed(5), 7168, 2048, quant)
    gs, s = _effective_gs(p, quant.acc_bits, quant.act_bits, True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, want, l1 = a2q_quantize_cuda(p["v"], gs, s, n=-128, p=127, dequantize=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _, out, out_l1 = a2q_quantize_cuda(p["v"], gs, s, n=-128, p=127, dequantize=False)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(out_l1, l1)


def _mla_module():
    import importlib

    return importlib.import_module("repro_torch.kernels.paged_mla_attention")


def _mla_int_pools(ckv, kpe, bits):
    from repro_torch.nn.attention import _kv_quantize, _pack_nibbles

    out = []
    for p in (ckv, kpe):
        codes, sc = _kv_quantize(p, bits=bits)
        out.append((_pack_nibbles(codes) if bits == 4 else codes, sc))
    (ckvq, ckvs), (kpeq, kpes) = out
    return ckvq, kpeq, ckvs, kpes


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("act_quant", [False, True], ids=["plain", "act_quant"])
def test_paged_mla_attention_cuda_forced_splits(dev, monkeypatch, pool, act_quant):
    """deepseek's widths on the tensor-core kernel, each row's table cut into
    1 to 8 runs (a cluster): within 2e-5 of the plain version, the length-1
    row exact, a zero row for length 0, the block past a length unread."""
    mla = _mla_module()
    B, H, R, P, bs = 8, 128, 512, 64, 16
    lens = [7, 1, 0, 2 * bs + 3, 3 * bs, bs - 1, 1, 4 * bs]
    q_lat, q_pe, ckv, kpe, bt, lengths = _mla_case(dev, torch.float32, B, H, R, P, bs, lens)
    if pool == "bf16":
        pools = (ckv.bfloat16(), kpe.bfloat16(), None, None)
    else:
        pools = _mla_int_pools(ckv, kpe, 8 if pool == "int8" else 4)
    kw = dict(scale=192**-0.5)
    if act_quant:
        kw.update(aq_scale=torch.tensor([0.02], device=dev), act_bits=8)
    args = (q_lat, q_pe, pools[0], pools[1], bt, lengths, pools[2], pools[3])
    want = paged_mla_attention_plain(*args, **kw)
    for splits in range(1, 9):
        monkeypatch.setattr(mla, "mla_splits", lambda *a, n=splits: n)
        tc0 = paged_mla_attention_cuda.tc_launches
        got = paged_mla_attention_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert paged_mla_attention_cuda.tc_launches == tc0 + 1
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        assert (got[2] == 0).all() and torch.equal(got[1], want[1])
        poisoned = list(args)
        if pool == "bf16":
            poisoned[2] = args[2].clone()
            poisoned[2][-1] = float("nan")  # the block past row 0's length
        else:
            poisoned[6] = args[6].clone()
            poisoned[6][-1] = float("nan")
        again = paged_mla_attention_cuda(*poisoned, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, got)


@pytest.mark.parametrize("dtype,act_bits", [(torch.float32, None), (torch.float32, 8),
                                            (torch.bfloat16, 12), (torch.bfloat16, 16)])
def test_paged_mla_attention_cuda_core_route_is_counted_apart(dev, dtype, act_bits):
    """fp32 pools and replays over 9 bits (a latent not exact in bf16) run
    on the CUDA-core kernel: counted in ``launches`` and not in
    ``tc_launches``, within 2e-5 of the plain version."""
    B, H, R, P, bs = 8, 128, 512, 64, 16
    lens = [7, 1, 0, 2 * bs + 3, 3 * bs, bs - 1, 1, 4 * bs]
    args = _mla_case(dev, dtype, B, H, R, P, bs, lens)
    kw = dict(scale=192**-0.5)
    if act_bits is not None:
        kw.update(aq_scale=torch.tensor([0.002], device=dev), act_bits=act_bits)
    n0, tc0 = paged_mla_attention_cuda.launches, paged_mla_attention_cuda.tc_launches
    got = paged_mla_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert paged_mla_attention_cuda.launches == n0 + 1
    assert paged_mla_attention_cuda.tc_launches == tc0
    torch.testing.assert_close(got, paged_mla_attention_plain(*args, **kw), rtol=0, atol=2e-5)


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
def test_paged_mla_attention_cuda_4k_context_graph_replay_and_no_sync(dev, pool):
    """DeepSeek-V3's 4K context (B=8, lengths in [3072, 4096]) with the
    replay at 8 bits: within 2e-5 of the plain version, no host sync, two
    CUDA-graph replays equal to the eager call."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, H, R, P, bs, MB = 8, 128, 512, 64, 16, 256
    lengths = torch.randint(3072, 4097, (B,), generator=g, device=dev, dtype=torch.int32)
    NB = B * MB + 1
    bt = (torch.randperm(NB - 1, generator=g, device=dev).to(torch.int32) + 1)[: B * MB]
    bt = bt.reshape(B, MB).clone()
    q_lat = torch.randn((B, H, R), generator=g, device=dev)
    q_pe = torch.randn((B, H, P), generator=g, device=dev)
    ckv = torch.randn((NB, bs, R), generator=g, device=dev)
    kpe = torch.randn((NB, bs, P), generator=g, device=dev)
    if pool == "bf16":
        pools = (ckv.bfloat16(), kpe.bfloat16(), None, None)
    else:
        pools = _mla_int_pools(ckv, kpe, 8 if pool == "int8" else 4)
    args = (q_lat, q_pe, pools[0], pools[1], bt, lengths, pools[2], pools[3])
    kw = dict(scale=192**-0.5, aq_scale=torch.tensor([0.02], device=dev), act_bits=8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = paged_mla_attention_cuda(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.testing.assert_close(want, paged_mla_attention_plain(*args, **kw), rtol=0, atol=2e-5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_mla_attention_cuda(*args, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# -- the decode megastep on a CUDA graph ---------------------------------------

MEGASTEP_CASES = {  # reduced archs on the card's phase 4m paths
    "smollm-135m": dict(kv_quant=True, rt=dict(int_chain=True, decode_kernel=True)),
    "deepseek-v3-671b": dict(rt=dict(int_forward=True, decode_kernel=True, mla_absorb=True)),
    "rwkv6-7b": dict(rt=dict(int_chain=True)),
}


def _megastep_engine(dev, name, **kw):
    from repro_torch.configs import reduced
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.nn.module import tree_to
    from repro_torch.serve.engine import PagedServeEngine, deploy_params

    arch = reduced(get_arch(name))
    params = deploy_params(init_lm(torch.Generator().manual_seed(0), arch, device="cpu"),
                           arch.quant)
    case = dict(MEGASTEP_CASES[name])
    rt = Runtime(**case.pop("rt"))
    return arch, PagedServeEngine(arch, tree_to(params, dev), device=dev, rt=rt, batch=2,
                                  max_seq=64, block_size=4, prefill_chunk=4, **case, **kw)


def _megastep_prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in (5, 7, 4)]


@pytest.mark.parametrize("name", list(MEGASTEP_CASES))
def test_megastep_graph_replay_matches_eager_window_and_per_tick(dev, name):
    """Every window a replay of the graph captured at the first step: tokens
    and margins equal, bit for bit, an engine running the same windows
    eagerly on the card and the per-tick engine; every kernel of the window
    counted once a replay."""
    arch, mega = _megastep_engine(dev, name, decode_steps=4)
    prompts = _megastep_prompts(arch.vocab)
    got = mega.generate(prompts, max_new=6)
    assert mega.stats["graph_replays"] == mega.stats["decode_dispatches"] >= 2
    assert mega.graph_info["capture_s"] > 0 and mega.graph_info["launches"]
    _, eager = _megastep_engine(dev, name, decode_steps=4)

    def eager_window(inp):
        out = eager._window(torch.from_numpy(inp).to(dev)).cpu().numpy()
        return out[0], out[1].view(np.float32), out[2] != 0

    eager._capture = lambda: None
    eager._run_window = eager_window
    _, tick = _megastep_engine(dev, name)
    for other in (eager, tick):
        assert other.generate(prompts, max_new=6) == got
        assert [r.margins for r in other.last_requests] == \
            [r.margins for r in mega.last_requests]
    before = ops.launch_counts()
    mega._run_window(mega._window_inputs([]))  # one replay, every row inactive
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        mega.graph_info["launches"]


def test_sampled_megastep_redraws_noise_every_replay(dev):
    """Top-k sampling inside the captured window: the engine's generator is
    registered with the graph, so two replays on the same inputs draw other
    tokens and advance its offset alike, and two engines of one seed give
    the same tokens."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.sampling import SampleConfig

    hot = SampleConfig("topk", temperature=64.0, top_k=40)
    outs = []
    for _ in range(2):
        arch, engine = _megastep_engine(dev, "smollm-135m", decode_steps=4, sample=hot, seed=3)
        outs.append(engine.generate(_megastep_prompts(arch.vocab), max_new=6))
    assert outs[0] == outs[1]
    for i, p in enumerate(_megastep_prompts(arch.vocab)[:2]):
        engine.submit(Request(uid=10 + i, prompt=p, max_new=12))
    engine.step()
    inp = engine._window_inputs(engine.sched.live)
    offsets = [engine._gen.get_offset()]
    windows = []
    for _ in range(2):
        windows.append(engine._run_window(inp)[0].copy())
        offsets.append(engine._gen.get_offset())
    assert (windows[0] != windows[1]).any()
    assert offsets[2] - offsets[1] == offsets[1] - offsets[0] > 0


@pytest.mark.parametrize("name", list(MEGASTEP_CASES))
def test_megastep_eager_window_makes_no_host_sync(dev, name):
    """One window of the decode forward run eagerly on live slots under
    ``set_sync_debug_mode("error")``: no op reads a device value back or
    copies from pageable host memory (what a CUDA graph cannot capture)."""
    arch, engine = _megastep_engine(dev, name, decode_steps=4)
    from repro_torch.serve.engine import Request

    for i, p in enumerate(_megastep_prompts(arch.vocab)[:2]):
        engine.submit(Request(uid=i, prompt=p, max_new=9))
    engine.step()  # captures, admits and prefills both, one window
    inp = torch.from_numpy(engine._window_inputs(engine.sched.live)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine._window(inp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.shape == (3, 2, 4) and bool((out[2] != 0).all())


def test_rwkv6_training_forward_skips_the_scan_kernel(dev):
    """A cacheless time-mix forward that autograd records (training) takes
    ``rwkv6_chunked`` on the card, as the reference trains (the kernel has no
    backward): no ``rwkv6_scan`` launch, and its output and gradients (the
    input's and every parameter's) within 1e-4 of their largest value of
    the CPU's.  The same forward under ``no_grad`` launches the kernel
    once.  Float weights (``mode="none"``), so no act-quant code sits at a
    rounding tie between the two devices' fp32 sums."""
    from repro_torch import resolve_device
    from repro_torch.configs.base import QuantConfig
    from repro_torch.nn.module import tree_leaves_with_path, tree_map
    from repro_torch.nn.ssm import apply_rwkv6_timemix, init_rwkv6_timemix

    resolve_device("cuda")  # TF32 off: fp32 matmuls in full fp32
    ssm = get_arch("rwkv6-7b").stacks[0].ssm  # 64-wide heads, 64-token chunks
    q = QuantConfig(mode="none")
    gen = torch.Generator().manual_seed(0)
    params = init_rwkv6_timemix(gen, 256, ssm, q)
    params["u"] = torch.randn(params["u"].shape, generator=gen) * 0.5
    x = torch.randn((2, 2 * ssm.chunk, 256), generator=gen)
    ct = torch.randn(x.shape, generator=gen)

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(), params)
        xi = x.to(device).requires_grad_()
        y, _ = apply_rwkv6_timemix(p, xi, ssm, q, compute_dtype=torch.float32)
        leaves = [xi] + [v for _, v in tree_leaves_with_path(p)]
        return y, torch.autograd.grad((y * ct.to(device)).sum(), leaves)

    want_y, want_g = run("cpu")
    before = rwkv6_scan_cuda.launches
    got_y, got_g = run(dev)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before
    for got, want in zip((got_y, *got_g), (want_y, *want_g)):
        want = want.detach()
        torch.testing.assert_close(got.detach().cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    with torch.no_grad():
        y, _ = apply_rwkv6_timemix(tree_map(lambda t: t.to(dev), params), x.to(dev), ssm, q,
                                   compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert rwkv6_scan_cuda.launches == before + 1
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("scale", ["tensor", "column"])
def test_compressed_allreduce_tree_on_the_card_equals_the_cpu(dev, scale, monkeypatch):
    """The global-view compressed reduction (no kernel of its own: the
    port's elementwise PyTorch ops) on the card against the CPU port, fed
    the same stacked numpy gradients through three rounds of error
    feedback at int8 and int16: every leaf's codes (both phases), totals and
    residuals bit for bit; the overflow guard raises before any work, from
    the mesh's data extent."""
    from repro_torch.dist import collectives
    from repro_torch.dist.collectives import compressed_allreduce_tree, owner_dim, server_shape
    from repro_torch.dist.sharding import Mesh

    n = 4
    leaves = {"fsdp": ((8, 48), ("data", None)), "free": ((6, 40), ("model", None)),
              "padded": ((30, 24), None), "padded_col": ((3, 37), ("model", None)),
              "vector": ((7,), None), "scalar": ((), None)}
    rng = np.random.default_rng(0)
    grads = [{k: (rng.standard_normal((n,) + s) * 10.0 ** rng.integers(-3, 1, (n,) + (1,) * len(s)))
              .astype(np.float32) for k, (s, _) in leaves.items()} for _ in range(3)]
    specs = {k: p for k, (_, p) in leaves.items()}
    orig = collectives._quantize
    for bits in (8, 16):
        runs = {}
        for device in ("cpu", dev):
            rec = []
            monkeypatch.setattr(collectives, "_quantize",
                                lambda *a: rec.append(orig(*a)) or rec[-1])
            mesh = Mesh.on_device(device, data=n, model=1)
            err = {"local": {k: torch.zeros((n,) + s, device=device)
                             for k, (s, _) in leaves.items()},
                   "server": {k: torch.zeros(server_shape(s, n, owner_dim(p, len(s), "data")),
                                             device=device) for k, (s, p) in leaves.items()}}
            out = []
            for g in grads:
                rec.clear()
                total, err = compressed_allreduce_tree(
                    {k: torch.from_numpy(v).to(device) for k, v in g.items()}, err, mesh=mesh,
                    axis="data", bits=bits, scale_axis=scale, pspec_tree=specs)
                out.append(([c.cpu() for c in rec], {k: v.cpu() for k, v in total.items()},
                            {p: {k: v.cpu() for k, v in err[p].items()} for p in err}))
            runs[str(device)] = out
        for cpu, card in zip(runs["cpu"], runs[str(dev)]):
            assert len(cpu[0]) == len(card[0]) == 2 * len(leaves)
            for a, b in zip(cpu[0], card[0]):
                assert a.dtype == (torch.int8 if bits <= 8 else torch.int16)
                assert torch.equal(a, b)
            for k in leaves:
                assert torch.equal(cpu[1][k], card[1][k]), k
                for p in ("local", "server"):
                    assert torch.equal(cpu[2][p][k], card[2][p][k]), (p, k)
    monkeypatch.setattr(collectives, "_quantize", orig)
    big = 1 << 17  # 2**17 shards of int16 codes can overflow the int32 sum
    g = torch.zeros((big, 0), device=dev)
    with pytest.raises(ValueError, match="overflow"):
        compressed_allreduce_tree({"w": g}, {"local": {"w": g}, "server": {"w": g[0]}},
                                  mesh=Mesh(("data",), (big,)), axis="data", bits=16,
                                  scale_axis=scale)


def test_sharded_world_of_one_over_nccl(dev):
    """The world phase 4x runs on one card: one rank over NCCL on a ``(data=1,
    model=1)`` mesh (gloo hangs in DTensor's all-gather of CUDA tensors of
    ranks that share the card, NCCL refuses two ranks on one device).  Two
    ``adamw`` steps of reduced yi-6b on DTensors against the unsharded steps
    on the card: losses to 1e-4 (``tests/test_torch_sharded.py``'s
    ``ADAM_TOL``), params within 1e-3 of lr x steps; MoE EP over ``model``
    and ``(model, data)`` equal to the local path; the kernel ops refuse a
    DTensor operand."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import reduced
    from repro_torch.configs.base import MoEConfig, QuantConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.dist.sharding import Mesh, ShardingRules, full_tree
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.nn import moe
    from repro_torch.nn.module import tree_leaves_with_path, tree_map
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train.state import init_state, shard_state

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = Mesh.over_ranks("cuda", data=1, model=1)
        arch = reduced(get_arch("yi-6b"))
        rules = ShardingRules.default(mesh, arch)
        params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
        opt, lr = adamw(), 2e-3
        sched = lambda s: torch.full((), lr, device=dev)  # noqa: E731
        one = init_state(tree_map(torch.clone, params), opt).tree()
        sharded = shard_state(init_state(tree_map(torch.clone, params), opt).tree(), opt, mesh,
                              rules)
        step1 = build_train_step(arch, opt, Runtime(), lr_schedule=sched)
        step2 = build_train_step(arch, opt, Runtime(mesh=mesh, rules=rules), lr_schedule=sched,
                                 donate=True)
        stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=8)
        for i in range(2):
            b = {k: torch.from_numpy(v).to(dev) for k, v in stream.batch(i).items()}
            one, m1 = step1(one, b)
            sharded, m2 = step2(sharded, b)
            assert not isinstance(m2["loss"], DTensor)
            np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-4)
        got = dict(tree_leaves_with_path(full_tree(sharded["params"])))
        for path, want in tree_leaves_with_path(one["params"]):
            assert float((got[path] - want).abs().max()) <= 1e-3 * lr * 2, path
        cfg, q = MoEConfig(n_experts=8, top_k=2, d_ff=16, capacity_factor=8.0), \
            QuantConfig(mode="none")
        p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), 8, cfg, q)
        x = torch.randn(4, 8, 8, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        local = moe.apply_moe(p, x, cfg, q, compute_dtype=torch.float32)
        for ep in ("model", ("model", "data")):
            y = moe.apply_moe(p, x, cfg, q, compute_dtype=torch.float32, mesh=mesh, ep_axis=ep)
            assert torch.equal(y.full_tensor(), local), ep
        w = next(v for path, v in tree_leaves_with_path(sharded["params"]) if path[-1] == "v")
        with pytest.raises(TypeError, match="DTensor"):
            ops.a2q_quantize(w, torch.zeros(w.shape[-1], device=dev),
                             torch.zeros(w.shape[-1], device=dev), weight_bits=8, acc_bits=16,
                             input_bits=8, input_signed=True)
    finally:
        dist.destroy_process_group()
