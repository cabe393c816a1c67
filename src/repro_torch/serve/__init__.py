from repro_torch.serve.engine import PagedServeEngine, Request, deploy_params  # noqa: F401
from repro_torch.serve.paged_cache import PagedKVCache  # noqa: F401
from repro_torch.serve.sampling import SampleConfig, sample_tokens  # noqa: F401
from repro_torch.serve.scheduler import Scheduler, ServeRequest  # noqa: F401
