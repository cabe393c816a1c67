"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16.

Parallel attention + mamba heads in every block (outputs averaged), SWA
attention (window 1024).  Mamba heads use the Mamba-2 SSD form (scalar
per-head decay) — DESIGN Sec. 5 notes this + the meta-token simplification.
Runs long_500k (ring cache + O(1) SSM state). [arXiv:2411.13676; hf]
"""

from repro_torch.configs.base import ArchConfig, AttnConfig, QuantConfig, SSMConfig, StackConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="lm",
    d_model=1600,
    vocab=32001,
    stacks=(
        StackConfig(
            kind="hymba",
            count=32,
            attn=AttnConfig(heads=25, kv_heads=5, head_dim=64, rope_theta=10000.0, window=1024),
            ssm=SSMConfig(kind="mamba", head_dim=64, state_dim=16, chunk=64),
            d_ff=5504,
        ),
    ),
    quant=QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=16),
    sub_quadratic=True,
)
