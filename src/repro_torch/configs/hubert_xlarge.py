"""hubert-xlarge [audio]: 48L d=1280 16H d_ff=5120 vocab(classes)=504.

Encoder-only (bidirectional attention), same backbone as wav2vec2.  The conv
feature frontend is a STUB: input_specs provides precomputed frame embeddings
(B, S, d).  No decode step -> decode_32k / long_500k skipped.
[arXiv:2106.07447; unverified]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, FrontendConfig, QuantConfig, StackConfig

ARCH = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    d_model=1280,
    vocab=504,
    n_classes=504,
    norm="layernorm",
    use_bias=True,
    frontend=FrontendConfig(kind="frames", seq_len=0),
    stacks=(
        StackConfig(
            kind="attn_mlp",
            count=48,
            attn=AttnConfig(heads=16, kv_heads=16, head_dim=80, rope_theta=None, causal=False),
            d_ff=5120,
            mlp_gated=False,  # GELU MLP, wav2vec2-style
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,
)
