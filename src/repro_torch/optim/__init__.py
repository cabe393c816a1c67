from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, clip_by_global_norm, global_norm, sgdm  # noqa: F401
from repro_torch.optim import schedules  # noqa: F401
