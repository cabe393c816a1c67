from repro_torch.train import checkpoint, elastic, state, trainer  # noqa: F401
