"""Production meshes over a fake world (port of ``repro.launch.mesh``).

The reference compiles against 512 placeholder host devices.  The port
stands up a ``torch.distributed`` world of the same size on the ``fake``
backend (``torch.testing._internal.distributed.fake_pg``): this process is
rank 0, every collective returns at once with outputs of the right shapes,
and under ``FakeTensorMode`` nothing is allocated.  A mesh bound to that
world runs the port's DTensor programs as one rank of the real world would,
which is what the dry-run traces and costs.

Nothing here runs at import: only the dry-run (and a test) makes a world.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh, forget_dead_worlds

__all__ = ["PRODUCTION_MESHES", "make_production_mesh", "fake_mesh", "production_mesh"]

# (axis names, sizes): one pod of 256 GPUs, or two
PRODUCTION_MESHES = {
    False: (("data", "model"), (16, 16)),
    True: (("pod", "data", "model"), (2, 16, 16)),
}


def _open(device_type: str, axes: dict) -> Mesh:
    """A fake world of ``prod(axes)`` ranks (this process rank 0) and a
    ``Mesh`` of ``axes`` (name=size, row-major) bound to it, its positions
    on ``device_type``.  Refuses when a world is already initialized."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already initialized in this process")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(axes.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = Mesh(tuple(axes), tuple(axes.values()), (torch.device(device_type),) * n)
        mesh.device_mesh()
    except BaseException:
        _close()
        raise
    return mesh


def _close() -> None:
    """Destroy the fake world and drop its cached ``DeviceMesh``es."""
    dist.destroy_process_group()
    forget_dead_worlds()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """16x16 (one pod of 256 GPUs) or 2x16x16 across two pods, on a fake
    world of that many ranks, positions on ``device_type``.  The world stays
    up until ``dist.destroy_process_group()``; ``production_mesh`` closes it
    on leaving its block.

    Axes: ``data`` = FSDP+DP, ``model`` = TP/EP/split-KV, ``pod`` = outer DP
    (one cross-pod gradient reduction a step)."""
    names, sizes = PRODUCTION_MESHES[multi_pod]
    return _open(device_type, dict(zip(names, sizes)))


@contextlib.contextmanager
def fake_mesh(device_type: str = "cuda", **axes: int):
    """A ``Mesh`` of ``axes`` (name=size) on a fake world of their product
    for the ``with`` block; the world and its meshes are destroyed on
    leaving, whatever happened inside."""
    mesh = _open(device_type, axes)
    try:
        yield mesh
    finally:
        _close()


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``make_production_mesh``'s mesh for the ``with`` block, closed on
    leaving."""
    names, sizes = PRODUCTION_MESHES[multi_pod]
    with fake_mesh(device_type, **dict(zip(names, sizes))) as mesh:
        yield mesh
