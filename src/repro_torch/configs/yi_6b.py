"""yi-6b [dense]: 32L d=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama-architecture GQA (RMSNorm, SwiGLU, RoPE theta=5e6). [arXiv:2403.04652; hf]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="yi-6b",
    family="lm",
    d_model=4096,
    vocab=64000,
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=32,
            attn=AttnConfig(heads=32, kv_heads=4, head_dim=128, rope_theta=5e6),
            d_ff=11008,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,
)
