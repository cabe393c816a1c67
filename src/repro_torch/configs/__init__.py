from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    AttnConfig,
    FrontendConfig,
    MoEConfig,
    QuantConfig,
    SSMConfig,
    ShapeSpec,
    StackConfig,
    applicable_shapes,
    input_specs,
)
from repro_torch.configs.registry import ARCH_NAMES, get_arch, reduced  # noqa: F401
