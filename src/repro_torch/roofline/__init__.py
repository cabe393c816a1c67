from repro_torch.roofline import hw  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    collective_bytes_from_trace,
    model_flops,
    roofline_terms,
    wire_bytes,
)
