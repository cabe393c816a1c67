"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Llama-architecture small model, tied embeddings.  9 heads do not divide the
16-way model axis -> heads replicate, d_ff/vocab still shard (DESIGN Sec. 4).
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="smollm-135m",
    family="lm",
    d_model=576,
    vocab=49152,
    tie_embeddings=True,
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=30,
            attn=AttnConfig(heads=9, kv_heads=3, head_dim=64, rope_theta=10000.0),
            d_ff=1536,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,
)
