"""Distribution layer (port of ``repro.dist``): logical-axis sharding rules
and the accumulator-aware compressed collectives.

``sharding``    — the mesh description (``Mesh``) and logical axis name ->
                  mesh axis resolution with divisibility-aware fallback
                  (``ShardingRules``, ``resolve_pspec``, ``param_specs``,
                  ``cache_specs``).
``collectives`` — the compressed all-reduce with error-feedback residuals,
                  shard-local over a ``torch.distributed`` group
                  (``compressed_psum``) and global-view over stacked
                  contributions (``compressed_allreduce``).
"""

from repro_torch.dist.collectives import (  # noqa: F401
    GradCompressConfig,
    compressed_allreduce,
    compressed_allreduce_tree,
    compressed_psum,
    compressed_psum_tree,
    quantize_shared_scale,
    resolve_grad_compress,
)
from repro_torch.dist.sharding import (  # noqa: F401
    Mesh,
    ShardingRules,
    cache_specs,
    param_axes,
    param_specs,
    resolve_pspec,
)
