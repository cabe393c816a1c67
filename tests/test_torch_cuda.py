"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA card (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: int_matmul — exact (integer carry, and the fused epilogue rounds
the multiply and the add once each, as the plain version does); paged
attention — 1e-5 with fp32 pools (fp32 softmax summed in another order), one
bf16 rounding of the output (2^-6, one ulp at |o| < 2) with bf16 pools.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.int_matmul import int_matmul_cuda, int_matmul_plain
from repro_torch.kernels.ops import int_matmul_block_k
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

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
    rng = np.random.default_rng(7)
    for M, K, N in ((1, 576, 192), (8, 1536, 576), (64, 576, 1536), (33, 100, 70), (3, 40, 5)):
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
