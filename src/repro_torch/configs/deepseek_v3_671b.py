"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA d_ff(expert)=2048 vocab=129280.

MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128), first 3 layers
dense (d_ff 18432), 58 MoE layers with 1 shared + 256 routed experts top-8,
MTP head.  Group-limited routing is simplified to plain top-k (DESIGN Sec. 8).
[arXiv:2412.19437; hf]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig, QuantConfig, StackConfig

_MLA = AttnConfig(
    kind="mla",
    heads=128,
    kv_heads=128,
    head_dim=128,
    rope_theta=10000.0,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

ARCH = ArchConfig(
    name="deepseek-v3-671b",
    family="lm",
    d_model=7168,
    vocab=129280,
    mtp_depth=1,
    stacks=(
        StackConfig(kind="attn_mlp", count=3, attn=_MLA, d_ff=18432),
        StackConfig(
            kind="moe",
            count=58,
            attn=_MLA,
            moe=MoEConfig(
                n_experts=256, top_k=8, d_ff=2048, n_shared=1, shared_d_ff=2048,
                capacity_factor=1.25,
            ),
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=False,
)
