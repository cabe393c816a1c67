"""Distribution layer (port of ``repro.dist``): logical-axis sharding rules
and the accumulator-aware compressed collectives.

``sharding``    — the mesh (``Mesh``; bound to a world's ranks it executes
                  sharded on DTensors) and logical axis name -> mesh axis
                  resolution with divisibility-aware fallback
                  (``ShardingRules``, ``resolve_pspec``, ``param_specs``,
                  ``cache_specs``), specs as DTensor placements
                  (``placements``, ``NamedSharding``, ``shard_tree``) and
                  the activation constraint (``constrain``).
``collectives`` — the compressed all-reduce with error-feedback residuals,
                  shard-local over a ``torch.distributed`` group
                  (``compressed_psum``), global-view over stacked
                  contributions (``compressed_allreduce``) and the same
                  laid over a group's processes
                  (``compressed_allreduce_shard``).
"""

from repro_torch.dist.collectives import (  # noqa: F401
    GradCompressConfig,
    compressed_allreduce,
    compressed_allreduce_shard,
    compressed_allreduce_tree,
    compressed_psum,
    compressed_psum_tree,
    quantize_shared_scale,
    resolve_grad_compress,
)
from repro_torch.dist.sharding import (  # noqa: F401
    Mesh,
    NamedSharding,
    ShardingRules,
    cache_specs,
    constrain,
    full_tree,
    param_axes,
    param_specs,
    placements,
    resolve_pspec,
    shard_tree,
    sharded_scope,
)
