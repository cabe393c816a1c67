"""The plain versions refuse fake tensors.

A dry-run traces one step of the card's path on fake tensors
(``FakeTensorMode``); on a CPU-only torch those are fake ``cpu`` tensors.
Every ``kernels.ops`` entry takes its fake branch (the kernel's cost, no
launch) before it looks at the device, so a plain version (``*_plain``, or
the recurrent forms the card replaces with its scan kernel) reached with a
fake tensor means a device branch sent the trace down the CPU's path, and
the record would cost the wrong code: it raises instead.
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["plain_version"]


def plain_version(fn=None, *, under_autograd: bool = False):
    """Decorate a plain version: a call with a fake tensor among its
    arguments raises.  ``under_autograd``: allowed when autograd records an
    argument (training runs the form on the card too, the kernel having no
    backward)."""

    def wrap(fn):
        @functools.wraps(fn)
        def guarded(*args, **kwargs):
            tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
            if any(isinstance(t, FakeTensor) for t in tensors) and not (
                    under_autograd and torch.is_grad_enabled()
                    and any(t.requires_grad for t in tensors)):
                raise RuntimeError(f"{fn.__name__}: a plain version reached on fake tensors "
                                   "(a dry-run traces the card's path, which launches the "
                                   "kernel here)")
            return fn(*args, **kwargs)

        return guarded

    return wrap(fn) if fn is not None else wrap
