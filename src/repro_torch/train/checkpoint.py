"""Fault-tolerant checkpointing: atomic, keep-k (port of
``repro.train.checkpoint``, in its layout).

Layout (one directory per step)::

    <dir>/step_00000123/
        manifest.json       # leaf paths, shapes, dtypes, step
        arrays.npz          # one entry per leaf
        _COMPLETE           # written last -> a checkpoint is valid iff present

Leaf paths are spelled as the reference's ``jax.tree_util.keystr`` spells a
dict path (``['params']['embed']['table']``) and the leaves are numbered in
its sorted-key order, so a checkpoint written by either package restores
into the other with no reshaping.

* **atomic**: writes go to ``step_X.tmp`` then a single rename; a crash
  mid-save never corrupts the latest valid checkpoint;
* **keep-k** garbage collection;
* **emergency save**: ``install_signal_handler`` flushes a checkpoint on
  SIGTERM (preemption) before exit.

A checkpoint holds global arrays: ``save`` gathers a DTensor leaf
(``full_tensor()``) and rank 0 alone writes, behind a barrier.  A restore
places every leaf on the device of the ``like`` leaf it replaces, or with
``shardings`` re-lays each global leaf onto the live mesh (the reference's
elastic restart: the mesh that saved it may have had another shape).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.nn.module import keystr, tree_leaves_with_path, tree_map_with_path

__all__ = ["save", "restore", "latest_step", "install_signal_handler"]

_SENTINEL = "_COMPLETE"


def _world() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def save(directory: str, tree: Any, step: int, keep: int = 3) -> str:
    """Atomically write ``tree`` (nested dicts of tensors) for ``step``.  In
    a ``torch.distributed`` world every rank calls it: DTensor leaves are
    gathered to their global arrays, rank 0 writes, and every rank returns
    once the checkpoint is complete."""
    tree = tree_map_with_path(lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
    if _world():
        final = os.path.join(directory, f"step_{step:08d}")
        if dist.get_rank() == 0:
            _write(directory, tree, step, keep)
        dist.barrier()
        return final
    return _write(directory, tree, step, keep)


def _write(directory: str, tree: Any, step: int, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": int(step), "leaves": []}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        key = f"leaf_{i:05d}"
        val = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        arrays[key] = val
        manifest["leaves"].append(
            {"key": key, "path": keystr(path), "shape": list(val.shape), "dtype": str(val.dtype)}
        )
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(tmp, _SENTINEL), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_valid_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _valid_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _SENTINEL)):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _valid_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, like: Any, step: Optional[int] = None, shardings: Any = None,
            allow_missing: bool = False) -> tuple[Any, int]:
    """Load a checkpoint into the structure of ``like`` (nested dicts of
    tensors): each leaf on its ``like`` leaf's device, in the dtype the
    checkpoint stored.

    ``shardings`` (a tree of ``dist.sharding.NamedSharding`` matching
    ``like``, e.g. ``train.state.specs_to_shardings``) re-lays each global
    leaf onto the live mesh, whatever mesh saved it: every rank reads the
    checkpoint and keeps its shards.  ``allow_missing`` keeps the ``like``
    value for leaves the checkpoint does not record instead of raising.  A
    leaf whose shape differs from its ``like`` leaf's raises
    ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, _SENTINEL)):
        raise FileNotFoundError(f"checkpoint {d} is incomplete")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    placed = {} if shardings is None else dict(tree_leaves_with_path(shardings))
    with np.load(os.path.join(d, "arrays.npz")) as arrays:

        def load(path, leaf):
            key = keystr(path)
            if key not in by_path:
                if allow_missing:
                    return leaf
                raise KeyError(f"checkpoint missing leaf {key}")
            val = arrays[by_path[key]["key"]]
            if tuple(val.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {val.shape} vs expected "
                                 f"{tuple(leaf.shape)}")
            if path in placed:
                return placed[path].place(torch.from_numpy(val))
            return torch.from_numpy(val).to(leaf.device)

        return tree_map_with_path(load, like), step


def install_signal_handler(save_fn: Callable[[], None], signals=(signal.SIGTERM, signal.SIGINT)):
    """Emergency checkpoint on preemption.  ``save_fn`` must be reentrant-safe
    (the trainer passes a closure over its latest completed state)."""
    done = threading.Event()

    def handler(signum, frame):
        if not done.is_set():
            done.set()
            save_fn()
        raise SystemExit(128 + signum)

    for s in signals:
        signal.signal(s, handler)
    return done
