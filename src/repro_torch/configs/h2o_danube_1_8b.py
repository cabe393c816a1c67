"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

Llama+Mistral mix with sliding-window attention (window 4096) -> ring KV cache,
runs the long_500k cell. [arXiv:2401.16818; hf]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="h2o-danube-1.8b",
    family="lm",
    d_model=2560,
    vocab=32000,
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=24,
            attn=AttnConfig(heads=32, kv_heads=8, head_dim=80, rope_theta=10000.0, window=4096),
            d_ff=6912,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=True,
)
