"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, public wrappers (ops.py) and PyTorch oracles (ref.py).  Layers
import from ops."""

from repro_torch.kernels.ops import (  # noqa: F401
    a2q_quantize,
    flash_attention,
    int_matmul,
    paged_attention,
    paged_mla_attention,
    rwkv6_scan,
)
