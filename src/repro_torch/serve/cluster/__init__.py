"""The serving cluster: router, replicas (in process or spawned) and
prefill/decode disaggregation.  Port of ``repro.serve.cluster``."""

from repro_torch.serve.cluster.replica import (  # noqa: F401
    InProcessReplica,
    Replica,
    ReplicaConfig,
    SubprocessReplica,
    build_engine,
)
from repro_torch.serve.cluster.router import ClusterRequest, Router  # noqa: F401
from repro_torch.serve.cluster.disagg import (  # noqa: F401
    handoff_local,
    make_cluster_configs,
    parse_disagg,
)
