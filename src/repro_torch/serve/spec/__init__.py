"""Speculative decoding on the paged serving stack (port of
``repro.serve.spec``): ``drafter.py`` proposes, ``verify.py`` scores and
accepts, ``engine.py`` runs the rounds and the rollback."""

from repro_torch.serve.spec.drafter import ModelDrafter, SelfDrafter  # noqa: F401
from repro_torch.serve.spec.engine import SpecServeEngine  # noqa: F401
from repro_torch.serve.spec.verify import accept_prefix, make_verify_step  # noqa: F401
