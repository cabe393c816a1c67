"""Core A2Q library: accumulator bounds, quantizers, the A2Q operator, the
bit-exact integer simulator, sparsity accounting, and the FINN LUT cost model."""

from repro_torch.core import a2q, bounds, integer, lut, quantizers, sparsity  # noqa: F401
from repro_torch.core.a2q import (  # noqa: F401
    a2q_channel_l1,
    a2q_int_weights,
    a2q_norm_cap,
    a2q_penalty,
    apply_a2q,
    init_a2q,
)
from repro_torch.core.bounds import (  # noqa: F401
    data_type_bound,
    int_range,
    l1_budget,
    min_accumulator_bits_data_type,
    min_accumulator_bits_weights,
    weight_norm_bound,
)
from repro_torch.core.quantizers import (  # noqa: F401
    apply_act_quant,
    apply_weight_qat,
    fake_quant,
    init_act_quant,
    init_weight_qat,
    ste_round,
    ste_round_to_zero,
)
