"""The per-device cost of one traced step: the port's counterpart of XLA's
``cost_analysis`` and ``memory_analysis``.

``CostTrace`` is a context manager around one call of a step.  Run on the
fake tensors of a fake world (``launch.mesh``) it allocates nothing and
counts what one rank of the world would do, op by op:

* **FLOPs** of every op on a rank's local tensors, by
  ``torch.utils.flop_counter``'s registered formulas (``FlopCounterMode``'s
  own rule: an op with no formula is decomposed when it has a decomposition),
  plus the operations a kernel op records for itself (``kernels.ops``: on
  fake tensors each op only records the counts ``chip_smoke.py``'s
  ``bound_ms`` uses for its kernel).  A DTensor op is seen as the local ops
  it runs; the ops DTensor's sharding propagation runs on fake tensors of
  the *global* shape (``ShardingPropagator._propagate_tensor_meta_non_cached``)
  are not a rank's work and are left out.
* **Bytes accessed**: each counted op's input and output bytes (views and
  allocations move none), which is what an eager step moves.
* **Collectives**: each collective's op and result tensors, summed by
  ``roofline.analysis.collective_bytes_from_trace``.
* **Memory**: the peak of the storages the step made and still held, live
  at once (``temp``); the caller adds the arguments it passed
  (``memory_analysis``).

On real tensors the same trace counts a real step (the flops and the
collectives; the peak then is of the storages the trace saw).
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Any, Iterable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import collective_bytes_from_trace, collective_kind

__all__ = ["CostTrace", "tree_bytes", "record_kernel"]

_STATE = threading.local()  # .traces: the active traces; .propagating: DTensor's global pass depth

# shape queries and allocations: no work, no bytes
_FREE = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format, torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default, torch.ops.prim.layout.default,
    torch.ops.prim.device.default,
}
_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (a DTensor's local shard), a
    leaf that is the same view of the same storage as another once."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        key = (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape), t.stride())
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


def _active() -> list:
    return getattr(_STATE, "traces", [])


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel op's cost on fake tensors (``kernels.ops``): its operations
    and bytes join every active trace."""
    for trace in _active():
        trace.flops += flops
        trace.bytes_accessed += nbytes
        trace.kernels[name] += 1


def _patch_propagation():
    """Mark DTensor's global-shape pass (the op run on fake tensors of the
    global shape to learn the output's metadata), so a trace leaves it out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(orig, "_cost_marked", False):
        return

    def marked(self, *args, **kwargs):
        _STATE.propagating = getattr(_STATE, "propagating", 0) + 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _STATE.propagating -= 1

    marked._cost_marked = True
    ShardingPropagator._propagate_tensor_meta_non_cached = marked


class _Mode(TorchDispatchMode):
    def __init__(self, trace: "CostTrace"):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if DTensor in types:  # the local ops it runs come back through here
            return NotImplemented
        if getattr(_STATE, "propagating", 0) or func in _FREE:
            return func(*args, **kwargs)
        if func not in flop_registry and func._overloadpacket not in flop_registry and \
                collective_kind(str(func)) is None and not func.is_view:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.trace._count(func, args, kwargs, out)
        return out


class CostTrace:
    """Counts one traced step on each rank's local tensors: ``flops``,
    ``bytes_accessed``, ``collective_records`` (``collectives``), ``ops``
    (counts by op), ``kernels`` (kernel ops recorded on fake tensors) and
    ``temp_peak`` (the most bytes of storages made inside the trace and
    live at once)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collective_records: list = []
        self.ops: Counter = Counter()
        self.kernels: Counter = Counter()
        self.temp_peak = 0
        self._live: dict = {}  # storage key -> (weak ref, bytes)
        self._live_bytes = 0
        self._mode = _Mode(self)

    def __enter__(self):
        _patch_propagation()
        _STATE.traces = _active() + [self]
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        _STATE.traces = [t for t in _active() if t is not self]
        return False

    # -- counting ------------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        self.ops[str(packet)] += 1
        kind = collective_kind(str(func))
        if kind is not None:
            # the functional ops return their result; the in-place c10d ops
            # write it into their first argument
            res = _tensors(out) if str(func).startswith("_c10d_functional") else \
                _tensors(args[0] if args else out)
            self.collective_records.append({
                "op": str(packet), "tensors": [(str(t.dtype).replace("torch.", ""), _nbytes(t))
                                               for t in res]})
        elif func in flop_registry or packet in flop_registry:
            formula = flop_registry.get(packet, flop_registry.get(func))
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and func not in _ALLOC and kind is None and \
                str(packet) != "_c10d_functional.wait_tensor":
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in _tensors(out))
        self._hold(_tensors(out))

    def _hold(self, outs: Iterable[torch.Tensor]) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
            if self._live_bytes > self.temp_peak:
                self._sweep()
                self.temp_peak = max(self.temp_peak, self._live_bytes)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    # -- results -------------------------------------------------------------
    def collectives(self) -> dict:
        """The reference's collective record of the trace."""
        return collective_bytes_from_trace(self.collective_records)

    def cost(self) -> dict:
        """``cost_analysis``'s keys; nothing counts transcendentals (0)."""
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed),
                "transcendentals": 0.0}

    def memory_analysis(self, arguments: Any, outputs: Any) -> dict:
        """``memory_analysis``'s keys: the local bytes of ``arguments`` (the
        state and the batch passed in) and of ``outputs``, the step's peak
        of its own live storages (``temp``), and no generated code."""
        return {"argument_size_in_bytes": tree_bytes(arguments),
                "output_size_in_bytes": tree_bytes(outputs),
                "temp_size_in_bytes": int(self.temp_peak),
                "generated_code_size_in_bytes": 0}
