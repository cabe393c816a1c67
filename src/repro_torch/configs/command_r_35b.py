"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

GQA, no-bias, parallel attention+FFN residual block, LayerNorm (Cohere arch).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="command-r-35b",
    family="lm",
    d_model=8192,
    vocab=256000,
    norm="layernorm",
    use_bias=False,
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=40,
            attn=AttnConfig(heads=64, kv_heads=8, head_dim=128, rope_theta=8e6),
            d_ff=22528,
            parallel_block=True,
            mlp_gated=True,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,  # pure full attention -> long_500k skipped (DESIGN Sec.5)
)
