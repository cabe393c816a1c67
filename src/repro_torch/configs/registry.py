"""Architecture registry + reduced-config factory for smoke tests.

``get_arch(name)`` returns the full assigned config; ``reduced(arch)`` shrinks
it to a CPU-runnable config of the *same family* (same stack kinds, same
attention/MoE/SSM structure, tiny dims) for the per-arch smoke tests.  The
fields match ``repro.configs.registry`` one for one, so the reduced configs
of the two packages describe the same models.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.configs.base import ArchConfig, AttnConfig, FrontendConfig, MoEConfig, SSMConfig, StackConfig

_MODULES = {
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).ARCH


def _reduce_attn(a: Optional[AttnConfig], head_dim: int) -> Optional[AttnConfig]:
    if a is None:
        return None
    if a.kind == "mla":
        return dataclasses.replace(
            a, heads=4, kv_heads=4, head_dim=head_dim,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=head_dim, qk_rope_dim=8,
            v_head_dim=head_dim,
        )
    heads = 4 if a.heads != a.kv_heads else 2
    kv = max(1, heads // max(a.heads // a.kv_heads, 1))
    window = min(a.window, 16) if a.window else None
    chunk = min(a.chunk, 16) if a.chunk else None
    return dataclasses.replace(
        a, heads=heads, kv_heads=kv, head_dim=head_dim, window=window, chunk=chunk
    )


def reduced(arch: ArchConfig, *, head_dim: int = 16, count: int = 2, vocab: int = 256) -> ArchConfig:
    """Same-family tiny config: ~64-wide, 2 blocks per stack, <=2 stacks."""
    stacks = []
    for s in arch.stacks[:2]:
        a = _reduce_attn(s.attn, head_dim)
        d_model = (a.heads * head_dim) if a is not None and a.kind != "mla" else 64
        moe = None
        if s.moe is not None:
            moe = dataclasses.replace(
                s.moe, n_experts=8, top_k=min(s.moe.top_k, 2), d_ff=32,
                n_shared=min(s.moe.n_shared, 1), shared_d_ff=32, capacity_factor=2.0,
            )
        ssm = None
        if s.ssm is not None:
            ssm = dataclasses.replace(s.ssm, head_dim=16, state_dim=4, chunk=8, lora_rank=8)
        stacks.append(
            dataclasses.replace(
                s, count=min(s.count, count), attn=a, moe=moe, ssm=ssm,
                d_ff=(64 if s.d_ff else 0),
            )
        )
    # All stacks must agree on d_model; derive from the first.
    s0 = stacks[0]
    if s0.attn is not None and s0.attn.kind != "mla":
        d_model = s0.attn.heads * head_dim
    elif s0.ssm is not None:
        d_model = 4 * (s0.ssm.head_dim if s0.ssm else 16)
    else:
        d_model = 64
    frontend = None
    if arch.frontend is not None:
        frontend = dataclasses.replace(arch.frontend, seq_len=min(arch.frontend.seq_len or 8, 8))
    return dataclasses.replace(
        arch,
        d_model=d_model,
        vocab=vocab,
        n_classes=min(arch.n_classes, 32) if arch.n_classes else 0,
        stacks=tuple(stacks),
        frontend=frontend,
        attn_q_chunk=8,
        compute_dtype="float32",
        param_dtype="float32",
        max_seq_len=4096,
    )
