"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Anyres tiling frontend is a STUB: input_specs provides precomputed patch
embeddings prepended to the token embeddings.  Backbone = Yi-34B-style
decoder. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, FrontendConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    d_model=7168,
    vocab=64000,
    frontend=FrontendConfig(kind="patches", seq_len=576),
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=60,
            attn=AttnConfig(heads=56, kv_heads=8, head_dim=128, rope_theta=5e6),
            d_ff=20480,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,
)
