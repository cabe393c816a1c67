"""Three-term roofline over one traced step (port of
``repro.roofline.analysis``).

    compute    = FLOPs / peak
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

all per device.  The reference reads FLOPs and bytes from XLA's
``cost_analysis`` and the collectives from the optimized HLO; the port has
no compiled artifact, so ``roofline.cost.CostTrace`` counts one eager step
op by op on each rank's local shards, and ``collective_bytes_from_trace``
sums the collectives that trace recorded.  The byte convention is the
reference's: each collective's *result* bytes, by kind, so any wire
convention can be recomputed (``wire_bytes``: ring all-reduce ~2x its
buffer, the rest ~1x).

``MODEL_FLOPS = 6*N*D`` (dense) / ``6*N_active*D`` (MoE) gives the
useful-work ratio that catches recompute and redundancy.

Compressed-gradient classification: ``dist.collectives`` puts the
data-parallel gradient on the wire as 8- or 16-bit integer codes (an
all-to-all and an all-gather a leaf, as ``uint8`` views where the backend
has no int16).  No other path moves low-bit integers through a collective,
so an int8/uint8/int16/uint16 all-gather or all-to-all IS gradient traffic,
reported apart as ``gradient_wire_bytes``.
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.roofline import hw

__all__ = ["COLLECTIVE_KINDS", "collective_kind", "collective_bytes_from_trace", "wire_bytes",
           "link_bytes_per_s",
           "roofline_terms", "model_flops"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# op name (namespace.name, no overload) -> kind.  The functional ops
# (DTensor's redistributions, funcol) return their result; the in-place c10d
# ops (``torch.distributed``'s eager calls, as dist/collectives.py issues
# them) write it into their first argument.  ``wait_tensor`` completes a
# functional op and is not a second collective (the reference's start/done).
_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}

_GRADIENT_WIRE_DTYPES = ("int8", "uint8", "int16", "uint16")


def collective_kind(op: str) -> Optional[str]:
    """The reference's kind of a collective op (``"c10d.allgather_"``, with
    or without its overload), or None for any other op."""
    name = op.rsplit(".", 1)[0] if op.count(".") == 2 else op
    return _KINDS.get(name)


def collective_bytes_from_trace(records: Iterable[dict]) -> dict:
    """Sum collective result bytes by kind over a trace's op records.

    Each record is ``{"op": "c10d.allgather_", "tensors": [(dtype name,
    bytes), ...]}``: the op and the tensors of its result (``CostTrace``
    writes them).  Records of other ops are ignored.  Low-bit integer
    all-gather / all-to-all results are also counted as compressed-gradient
    traffic (``gradient_wire_bytes``, ``gradient_wire_counts``)."""
    per_kind = {k: 0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    gradient_wire = 0
    gradient_count = 0
    for rec in records:
        kind = collective_kind(rec["op"])
        if kind is None:
            continue
        total = sum(int(b) for _, b in rec["tensors"])
        int_bytes = sum(int(b) for dt, b in rec["tensors"] if dt in _GRADIENT_WIRE_DTYPES)
        per_kind[kind] += total
        counts[kind] += 1
        if int_bytes and kind in ("all-gather", "all-to-all"):
            gradient_wire += int_bytes
            gradient_count += 1
    return {
        "bytes_by_kind": per_kind,
        "counts": counts,
        "total_bytes": sum(per_kind.values()),
        "gradient_wire_bytes": gradient_wire,
        "gradient_wire_counts": gradient_count,
    }


# Ring-algorithm wire weight per result byte: a ring all-reduce moves ~2x
# its buffer (reduce-scatter pass + all-gather pass); gather/scatter/permute
# collectives move ~1x their result.
_WIRE_WEIGHT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wire_bytes(collectives: dict) -> float:
    """Result-byte record -> estimated per-device wire bytes (ring convention)."""
    return sum(_WIRE_WEIGHT.get(kind, 1.0) * b for kind, b in collectives["bytes_by_kind"].items())


def model_flops(n_params: float, tokens: float, kind: str = "train") -> float:
    """6*N*D for training; 2*N*D for a forward/decode pass."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params * tokens


def link_bytes_per_s(n_chips: int) -> float:
    """The link a device's collectives cross, one direction: NVLink 4
    inside one node of ``hw.GPUS_PER_NODE`` GPUs, else the node's NIC, one a
    GPU.  A ring over more than one node runs at its slowest hop, and every
    mesh axis of the 256- and 512-rank worlds spans nodes (the 16 ranks of
    ``model`` are two nodes; ``data`` and ``pod`` stride across them), so
    there the NIC is the term's denominator."""
    return hw.NVLINK_BYTES_PER_S if n_chips <= hw.GPUS_PER_NODE else hw.NIC_BYTES_PER_S


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    n_chips: int,
    link_bw: Optional[float] = None,
) -> dict:
    """Seconds per step for each roofline term, per device: FLOPs over the
    bf16 tensor cores' peak, bytes over HBM, collective bytes over
    ``link_bw`` (default ``link_bytes_per_s(n_chips)``: NVLink within a node,
    the NIC across nodes; both NVIDIA's data sheet, not measured)."""
    link = link_bytes_per_s(n_chips) if link_bw is None else link_bw
    compute = flops_per_device / hw.BF16_FLOPS_PER_S
    memory = bytes_per_device / hw.HBM_BYTES_PER_S
    collective = collective_bytes_per_device / link
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update(
        dominant=dominant,
        bound_s=bound,
        # how close the compute term is to being the only cost: 1 when the
        # step sits on the compute roof
        roofline_fraction=(compute / bound) if bound > 0 else 0.0,
        n_chips=n_chips,
    )
    return terms
