"""rwkv6-7b [ssm]: 32L d=4096 (attention-free) d_ff=14336 vocab=65536.

Finch: data-dependent per-channel decay, 64 heads of 64.  O(1) recurrent state
-> runs long_500k.  A2Q attaches to r/k/v/g/o + channel-mix projections; the
recurrence itself has no frozen weight vector to bound (DESIGN Sec. 5).
[arXiv:2404.05892; hf]
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, SSMConfig, StackConfig

ARCH = ArchConfig(
    name="rwkv6-7b",
    family="lm",
    d_model=4096,
    vocab=65536,
    stacks=(
        StackConfig(
            kind="rwkv6",
            count=32,
            ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=64, lora_rank=64),
            d_ff=14336,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=True,
)
