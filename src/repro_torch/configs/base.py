"""Config system: architecture, quantization, and input-shape descriptors.

Everything the launcher, engine and tests consume is described by these
frozen dataclasses.  One ``<arch>.py`` per assigned architecture under
``repro_torch/configs/`` builds an :class:`ArchConfig`; ``SHAPES`` lists the
four assigned input-shape cells.  The fields and defaults are those of
``repro.configs.base``, so a config means the same model in both packages
(``input_specs`` gives the dry-run's allocation-free inputs as ``meta``
tensors).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence

import torch

__all__ = [
    "QuantConfig",
    "AttnConfig",
    "MoEConfig",
    "SSMConfig",
    "StackConfig",
    "FrontendConfig",
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "applicable_shapes",
    "input_specs",
]


@dataclass(frozen=True)
class QuantConfig:
    """A2Q / QAT settings (paper Sec. 5.1 conventions).

    ``mode``: 'none' (float), 'qat' (baseline Sec. 2.1), 'a2q' (Sec. 4).
    ``weight_bits`` M / ``act_bits`` N / ``acc_bits`` P are the uniform hidden
    layer widths; first/last layers stay at ``boundary_bits`` (8, per App. B).
    """

    mode: Literal["none", "qat", "a2q"] = "none"
    weight_bits: int = 8
    act_bits: int = 8
    acc_bits: int = 32
    boundary_bits: int = 8
    reg_lambda: float = 1e-3
    # Beyond-paper lever: store deployable weights as int8 + per-channel scale
    # (sound because A2Q guarantees the accumulator), halving weight HBM bytes.
    int8_weight_storage: bool = False


@dataclass(frozen=True)
class AttnConfig:
    kind: Literal["gqa", "mla"] = "gqa"
    heads: int = 8
    kv_heads: int = 8
    head_dim: int = 128
    causal: bool = True
    rope_theta: Optional[float] = 10000.0  # None => NoPE
    window: Optional[int] = None  # sliding-window width
    chunk: Optional[int] = None  # chunked-local (llama4) block width
    qk_norm: bool = False
    # MLA (deepseek-v3) dims
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff: int = 2048  # per-expert FFN width
    n_shared: int = 0  # shared (always-on) experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    kind: Literal["rwkv6", "mamba"] = "rwkv6"
    head_dim: int = 64
    state_dim: int = 16  # mamba N
    chunk: int = 64
    lora_rank: int = 64  # rwkv6 data-dependent decay LoRA
    expand: int = 2  # mamba inner expansion


@dataclass(frozen=True)
class StackConfig:
    """A run of ``count`` identical blocks, applied in order."""

    kind: Literal["attn_mlp", "moe", "rwkv6", "hymba", "conv"] = "attn_mlp"
    count: int = 1
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    d_ff: int = 0  # dense MLP width (attn_mlp blocks)
    parallel_block: bool = False  # command-r style parallel attn+FFN
    mlp_gated: bool = True  # SwiGLU vs plain GELU MLP


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs provides precomputed embeddings."""

    kind: Literal["patches", "frames"] = "patches"
    seq_len: int = 576  # embeddings prepended (vlm) or consumed directly (audio)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["lm", "encoder", "vlm", "audio"] = "lm"
    d_model: int = 512
    vocab: int = 32000
    stacks: Sequence[StackConfig] = ()
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False
    frontend: Optional[FrontendConfig] = None
    mtp_depth: int = 0  # deepseek multi-token prediction heads
    n_classes: int = 0  # encoder classification head (hubert)
    quant: QuantConfig = field(default_factory=QuantConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: Literal["none", "block", "full"] = "block"
    # Unroll stacks as python loops instead of lax.scan.  Used by the roofline
    # costing variants: XLA cost_analysis counts a while body ONCE (verified in
    # tests/test_roofline.py), so per-layer costs are measured on unrolled
    # 1-layer vs 2-layer models and extrapolated (launch/dryrun.py).
    unroll_stacks: bool = False
    attn_q_chunk: int = 256  # query-chunked attention block (jnp path)
    max_seq_len: int = 532480  # RoPE table bound (covers long_500k + frontend)
    # True => this arch can run the long_500k decode cell (sub-quadratic attn)
    sub_quadratic: bool = False

    @property
    def n_layers(self) -> int:
        return sum(s.count for s in self.stacks)

    def layer_dims(self) -> list[tuple[int, int]]:
        """(K, C_out) of every distinct matmul family — for bound tables."""
        dims = []
        for s in self.stacks:
            if s.attn is not None:
                dims.append((self.d_model, s.attn.heads * s.attn.head_dim))
            if s.d_ff:
                dims.append((self.d_model, s.d_ff))
                dims.append((s.d_ff, self.d_model))
            if s.moe is not None:
                dims.append((self.d_model, s.moe.d_ff))
                dims.append((s.moe.d_ff, self.d_model))
        return dims


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable_shapes(arch: ArchConfig) -> list[str]:
    """Which of the four assigned cells this arch runs (DESIGN.md Sec. 5)."""
    out = ["train_4k", "prefill_32k"]
    if arch.family in ("lm", "vlm"):  # decoder LMs decode
        out.append("decode_32k")
        if arch.sub_quadratic:
            out.append("long_500k")
    return out


def input_specs(arch: ArchConfig, shape: ShapeSpec, *, per_pod_batch: Optional[int] = None):
    """``meta`` tensor stand-ins for every model input: no allocation.

    train: {tokens, targets [, frontend_embeds]}: ``tokens (B, S)`` int32.
    prefill: {tokens [, frontend_embeds]}.
    decode: {tokens (B, 1)}: the cache comes from the model builder
    (``models.lm.init_cache``).  The shapes and dtypes are the reference's."""
    B = per_pod_batch if per_pod_batch is not None else shape.global_batch
    S = shape.seq_len
    specs = {}

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if arch.family == "audio":
        # stub frame frontend: the model consumes precomputed frame embeddings
        specs["frontend_embeds"] = spec((B, S, arch.d_model), bf16)
        if shape.kind == "train":
            specs["targets"] = spec((B, S), i32)
        return specs
    s_text = S
    if arch.family == "vlm" and arch.frontend is not None:
        s_img = (min(arch.frontend.seq_len, max(S // 8, 1)) if shape.kind != "decode"
                 else arch.frontend.seq_len)
        if shape.kind != "decode":
            s_text = S - s_img
            specs["frontend_embeds"] = spec((B, s_img, arch.d_model), bf16)
    if shape.kind == "train":
        specs["tokens"] = spec((B, s_text), i32)
        specs["targets"] = spec((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, s_text), i32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = spec((B, 1), i32)
    return specs
