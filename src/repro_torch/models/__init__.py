from repro_torch.models.lm import Runtime, apply_lm, init_lm  # noqa: F401
