"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192 MoE 16e top-1.

iRoPE interleave: 3 chunked-local (RoPE, chunk 8192) : 1 global (NoPE) layers,
every layer MoE (16 routed top-1 + 1 shared expert).  Early-fusion multimodal
frontend out of scope for the LM cells (text-only input specs).  Chunked-local
layers use ring caches; global layers decode O(S) per step -> runs long_500k.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, MoEConfig, QuantConfig, StackConfig

_MOE = MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1, shared_d_ff=8192,
                 capacity_factor=1.25)


def _local(count: int) -> StackConfig:
    return StackConfig(
        kind="moe",
        count=count,
        attn=AttnConfig(heads=40, kv_heads=8, head_dim=128, rope_theta=5e5, chunk=8192),
        moe=_MOE,
    )


def _global() -> StackConfig:
    return StackConfig(
        kind="moe",
        count=1,
        attn=AttnConfig(heads=40, kv_heads=8, head_dim=128, rope_theta=None),
        moe=_MOE,
    )


ARCH = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="lm",
    d_model=5120,
    vocab=202048,
    stacks=tuple(s for _ in range(12) for s in (_local(3), _global())),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=True,
)
