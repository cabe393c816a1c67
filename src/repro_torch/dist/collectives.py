"""Accumulator-aware compressed collectives (port of ``repro.dist.collectives``).

``compressed_psum`` extends A2Q's per-device guarantee (paper Sec. 3-4:
invert the accumulator bound into a constraint on what gets summed) to the
cross-device reduction.  It is the two-phase compressed all-reduce
(1-bit-Adam / EF-SGD lineage), with every quantization error folded into an
error-feedback residual:

1. each shard adds its residual to the payload and quantizes it to
   ``bits``-bit integers on a *shared* scale (a max across the shards: one
   fp32 scalar per tensor, or one per output column with
   ``scale_axis="column"``, the A2Q+-style per-channel granularity);
2. **phase 1 (scatter)**: the flat int8/int16 payload is split into one chunk
   per shard and exchanged all-to-all; each shard owns one chunk and sums
   the ``n_shards`` quantized contributions in int32, exactly;
3. **phase 2 (gather)**: the owner requantizes its chunk-sum back to ``bits``
   wide integers on the statically widened scale ``n_shards * scale`` (safe:
   ``|sum| <= n_shards * qmax``) and the low-bit result is all-gathered.  The
   requantization error goes to the owner's residual, so both phases are
   error-fed-back.

About ``2 * bits / 8`` bytes an element cross the wire against ~8 for a
ring fp32 all-reduce.  Overflow avoidance is by construction (paper Eq. 12):
every summand is bounded by ``qmax = 2**(bits-1) - 1``, so the int32 sum over
``n_shards`` is exact whenever ``n_shards * qmax <= 2**31 - 1``; the guard
checks that from the shard count before any collective runs.

**Two transports, one wire format and one rounding order.**

* ``compressed_psum`` / ``_tree`` is the *shard-local* transport: each
  process of a ``torch.distributed`` group holds its own payload and
  residual; the scale's max is an ``all_reduce(MAX)``, phase 1 an
  ``all_to_all_single`` of the int8/int16 chunks, phase 2 an ``all_gather``
  (gloo on the CPU, NCCL on cards).
* ``compressed_allreduce`` / ``_tree`` is the *global-view* transport the
  train step uses: its input is the stacked ``(n_shards, *shape)``
  contributions, ownership falls on a payload dim (``owner_dim``: the
  param's FSDP dim when it has one) and the phase-2 requantization error is
  kept per owner as a ``server`` residual.  The reference expresses its two
  reshards as sharding constraints; on one device they are plain indexing,
  so what remains is the math: the same quantization, int32 sums, widened
  requantization and residual pair ``{"local", "server"}``
  (``train.state.init_grad_err``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.nn.module import tree_map, tree_unzip

__all__ = [
    "GradCompressConfig",
    "resolve_grad_compress",
    "quantize_shared_scale",
    "compressed_psum",
    "compressed_psum_tree",
    "compressed_allreduce",
    "compressed_allreduce_tree",
    "compressed_allreduce_shard",
    "owner_dim",
    "server_shape",
    "strip_axis",
]

_I32_MAX = 2**31 - 1
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    """Wire format for the data-parallel gradient reduction.

    ``bits``        integer width of the wire payload (2..16).
    ``scale_axis``  "tensor": one shared fp32 scale per gradient leaf;
                    "column": one fp32 scale per output column (last dim) of
                    rank>=2 leaves; rank<2 leaves fall back to the tensor scale.
    ``axis``        mesh axis to reduce over; ``None`` resolves to ``"pod"``
                    when the mesh has one, else ``"data"``.
    """

    bits: int = 8
    scale_axis: Literal["tensor", "column"] = "tensor"
    axis: Optional[str] = None


def resolve_grad_compress(cfg: Optional[GradCompressConfig], mesh) -> Optional[GradCompressConfig]:
    """Pin ``cfg.axis`` to a concrete mesh axis, or return ``None`` when
    compression cannot apply (no mesh / axis absent / axis extent 1)."""
    if cfg is None or mesh is None:
        return None
    axis = cfg.axis or ("pod" if "pod" in mesh.shape else "data")
    if axis not in mesh.shape or mesh.shape[axis] <= 1:
        return None
    return dataclasses.replace(cfg, axis=axis)


def _check_format(bits: int, scale_axis: str) -> None:
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    if scale_axis not in ("tensor", "column"):
        raise ValueError(f"scale_axis must be 'tensor' or 'column', got {scale_axis!r}")


def _check_overflow(n_shards: int, bits: int) -> int:
    """``qmax`` of ``bits``; raises when ``n_shards`` int32-summed codes can
    overflow."""
    qmax = 2 ** (bits - 1) - 1
    if n_shards * qmax > _I32_MAX:
        raise ValueError(
            f"int32 accumulator can overflow: {n_shards} shards * qmax {qmax} "
            f"= {n_shards * qmax} > {_I32_MAX}"
        )
    return qmax


def _wire_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` correctly rounded on every device: PyTorch's CUDA division
    by a Python number multiplies by its rounded reciprocal instead (one
    ulp off at times), so a number divides as a tensor on ``a``'s device."""
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def _quantize(y: torch.Tensor, scale, qmax: int, wire: torch.dtype) -> torch.Tensor:
    return torch.clamp(torch.round(_div(y, scale)), -qmax, qmax).to(wire)


def _owner_sum(codes: torch.Tensor) -> torch.Tensor:
    """The owner's exact int32 sum of the shards' codes (dim 0)."""
    return codes.to(torch.int32).sum(0, dtype=torch.int32)


def quantize_shared_scale(y: torch.Tensor, group=None, bits: int = 8, scale_axis: str = "tensor"):
    """Symmetric integer quantization on a scale agreed across ``group``
    (a ``torch.distributed`` process group; the default group when
    ``None``; this process alone when no group is initialized).

    Returns ``(q, scale)``: the wire payload (int8 for ``bits <= 8``, else
    int16) and the fp32 scale, broadcastable against ``y``: shape ``()`` for
    ``scale_axis="tensor"``, ``(1, ..., 1, C)`` (one scale per output column)
    for ``scale_axis="column"`` on rank>=2 payloads.
    """
    qmax = 2 ** (bits - 1) - 1
    if scale_axis == "column" and y.dim() >= 2:
        absmax = torch.amax(torch.abs(y), dim=tuple(range(y.dim() - 1)), keepdim=True)
    else:
        absmax = torch.max(torch.abs(y))
    if dist.is_available() and dist.is_initialized():
        absmax = absmax.contiguous()
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = _div(torch.clamp_min(absmax, _TINY), qmax)
    return _quantize(y, scale, qmax, _wire_dtype(bits)), scale


def compressed_psum(x: torch.Tensor, group, err: torch.Tensor, bits: int = 8,
                    scale_axis: str = "tensor"):
    """int-quantized all-reduce over the processes of ``group`` with error
    feedback.

    Args:
        x:    this process's payload (e.g. its gradient contribution).
        group: the ``torch.distributed`` process group to reduce over (the
              default group when ``None``).
        err:  this process's residual from the previous call
              (``torch.zeros_like(x)`` on the first).
        bits: integer width of the wire format (2..16).
        scale_axis: "tensor" (one shared scale) or "column" (one fp32 scale
              per last-dim column of rank>=2 payloads).

    Returns ``(total, new_err)``: the dequantized sum, the same on every
    process, and the residual to feed back next call.  The overflow guard
    raises from the group's size before any collective.
    """
    _check_format(bits, scale_axis)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("compressed_psum: no torch.distributed process group is initialized")
    n_shards = dist.get_world_size(group)
    qmax = _check_overflow(n_shards, bits)
    rank = dist.get_rank(group)

    y = (x + err).to(torch.float32)
    q, scale = quantize_shared_scale(y, group, bits, scale_axis)
    err1 = y - q.to(torch.float32) * scale  # phase-1 EF: what quantization dropped

    # flat chunk layout: shard i owns elements [i*chunk, (i+1)*chunk)
    nelem = q.numel()
    chunk = -(-nelem // n_shards)
    pad = chunk * n_shards - nelem
    scale_flat = F.pad(torch.broadcast_to(scale, y.shape).reshape(-1), (0, pad), value=1.0)
    my_scale = scale_flat[rank * chunk:(rank + 1) * chunk]

    # phase 1: all-to-all the low-bit chunks; the owner sums in int32 (exact
    # by the guard above)
    sent = F.pad(q.reshape(-1), (0, pad)).reshape(n_shards, chunk)
    recv = torch.empty_like(sent)
    # int16 codes travel as their bytes: neither gloo nor NCCL has an int16 type
    dist.all_to_all_single(recv.view(torch.uint8), sent.view(torch.uint8), group=group)
    chunk_sum = _owner_sum(recv)

    # phase 2: requantize the chunk-sum onto the widened scale and
    # all-gather the low-bit result; the requantization error is the owner's
    value_sum = chunk_sum.to(torch.float32) * my_scale
    wide = my_scale * n_shards
    q2 = _quantize(chunk_sum.to(torch.float32), n_shards, qmax, q.dtype)
    err2_chunk = value_sum - q2.to(torch.float32) * wide
    gathered = torch.empty((n_shards, chunk), dtype=q2.dtype, device=q2.device)
    dist.all_gather(list(gathered.view(torch.uint8)), q2.view(torch.uint8), group=group)
    gathered = gathered.reshape(-1)
    total = (gathered.to(torch.float32)[:nelem] * scale_flat[:nelem] * n_shards).reshape(x.shape)

    # phase-2 EF: the owner's requantization error at its owned positions
    err2_flat = torch.zeros(chunk * n_shards, dtype=torch.float32, device=x.device)
    err2_flat[rank * chunk:(rank + 1) * chunk] = err2_chunk
    new_err = err1 + err2_flat[:nelem].reshape(x.shape)
    return total.to(x.dtype), new_err.to(err.dtype)


def compressed_psum_tree(tree, group, err_tree, bits: int = 8, scale_axis: str = "tensor"):
    """``compressed_psum`` over a tree (e.g. a gradient tree), a leaf at a
    time in the tree's own order (the same on every process).  Returns
    ``(total_tree, new_err_tree)`` with the input structure."""
    pairs = tree_map(lambda x, e: compressed_psum(x, group, e, bits, scale_axis), tree, err_tree)
    return tree_unzip(pairs, 2)


# ---------------------------------------------------------------------------
# Global-view transport (the train step's): stacked per-shard contributions.
# ---------------------------------------------------------------------------


def owner_dim(pspec, ndim: int, axis: str) -> int:
    """Payload dim that carries the ownership split after the all-to-all.

    Prefer the dim the param layout already shards over ``axis`` (the FSDP
    dim, spelled bare or inside a multi-axis tuple): ownership then
    coincides with the param's own slice and the phase-2 result is the
    param layout (ZeRO-style).  Otherwise the first dim that claims no other
    mesh axis; otherwise dim 0."""
    entries = (list(pspec or ()) + [None] * ndim)[:ndim]
    for i, e in enumerate(entries):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    for i, e in enumerate(entries):
        if e is None:
            return i
    return 0


def server_shape(shape, n_shards: int, owner: int = 0) -> tuple:
    """Shape of the phase-2 (server) residual for a payload of ``shape``:
    the payload with dim ``owner`` padded up to a multiple of ``n_shards``;
    scalars stack to ``(n_shards,)``."""
    eff = tuple(int(d) for d in shape) or (1,)
    padded = -(-eff[owner] // n_shards) * n_shards
    return eff[:owner] + (padded,) + eff[owner + 1:]


def strip_axis(entries, axis):
    """Remove ``axis`` from a list of spec entries (replaced by ``None`` /
    dropped from tuples): a spec may not mention one mesh axis twice, and
    the residual / wire layouts reserve ``axis`` for the shard or owner dim."""
    out = []
    for e in entries:
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != axis)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
        else:
            out.append(e)
    return out


def compressed_allreduce(g: torch.Tensor, err_local: torch.Tensor, err_server: torch.Tensor, *,
                         mesh, axis: str, bits: int = 8, scale_axis: str = "tensor",
                         pspec=None):
    """Global-view compressed sum over the leading (per-shard) dim of ``g``.

    Args:
        g:          ``(n_shards, *shape)`` stacked per-shard contributions.
        err_local:  fp32 ``(n_shards, *shape)`` phase-1 residual.
        err_server: fp32 ``server_shape(shape, n_shards, owner)`` phase-2
                    (requantization) residual, one slice per owner.
        mesh/axis:  the mesh (``dist.sharding.Mesh``) and the axis the shard
                    dim is laid out on; ``n_shards = mesh.shape[axis]``.
        bits/scale_axis: wire format, as in ``compressed_psum``.
        pspec:      the payload's param spec (a tuple of axis entries): picks
                    the ownership dim (``owner_dim``); ``None`` = dim 0.

    Returns ``(total, new_err_local, new_err_server)``; ``total`` has shape
    ``shape``.  The codes are int8 (``bits <= 8``) or int16, summed in int32
    and requantized onto ``n_shards * scale``, as the reference rounds them.
    """
    _check_format(bits, scale_axis)
    n = int(mesh.shape[axis])
    if g.shape[0] != n:
        raise ValueError(f"leading dim {g.shape[0]} != axis {axis!r} extent {n}")
    qmax = _check_overflow(n, bits)
    wire = _wire_dtype(bits)
    shape = tuple(g.shape[1:])
    scalar = shape == ()
    if scalar:
        g, err_local, shape = g[:, None], err_local[:, None], (1,)
    ndim = len(shape)
    od = owner_dim(pspec, ndim, axis)

    y = g.to(torch.float32) + err_local
    # the scale is shared across shards: the max over the stacked dim
    if scale_axis == "column" and y.dim() >= 3:
        absmax = torch.amax(torch.abs(y), dim=tuple(range(y.dim() - 1)), keepdim=True)
    else:
        absmax = torch.max(torch.abs(y))
    scale = _div(torch.clamp_min(absmax, _TINY), qmax)
    q = _quantize(y, scale, qmax, wire)
    new_local = y - q.to(torch.float32) * scale

    d_own = shape[od]
    d_pad = -(-d_own // n) * n
    if d_pad != d_own:  # pad rows quantize to 0 and stay 0 in the server residual
        pads = [0, 0] * q.dim()
        pads[2 * (q.dim() - 2 - od) + 1] = d_pad - d_own  # F.pad lists the last dim first
        q = F.pad(q, pads)

    scale1 = scale[0] if scale.dim() else scale  # drop the stack dim
    if d_pad != d_own and scale1.dim() and od == ndim - 1 and scale1.shape[-1] > 1:
        # per-column scales ride along when the owner dim is the column dim
        scale1 = F.pad(scale1, (0, d_pad - d_own), value=1.0)

    # phase 1: the owners' int32 sums over the stacked dim (the all-to-all)
    part_sum = _owner_sum(q)
    # phase 2: requantize onto the widened scale (the all-gather); the
    # requantization error stays with the owner as the server residual
    value_sum = part_sum.to(torch.float32) * scale1 + err_server
    wide = scale1 * n
    q2 = _quantize(value_sum, wide, qmax, wire)
    new_server = value_sum - q2.to(torch.float32) * wide
    total = q2.to(torch.float32) * wide
    if d_pad != d_own:
        total = total.narrow(od, 0, d_own)
    return (
        total.to(g.dtype).reshape(() if scalar else shape),
        (new_local[:, 0] if scalar else new_local).to(err_local.dtype),
        new_server.to(err_server.dtype),
    )


def compressed_allreduce_shard(g: torch.Tensor, err_local: torch.Tensor,
                               err_server: torch.Tensor, *, group=None, bits: int = 8,
                               scale_axis: str = "tensor", owner: int = 0, scale_groups=()):
    """``compressed_allreduce`` with its stacked dim laid over the processes
    of ``group``: each calls it with its own row.

    Args:
        g:          this process's contribution (``shape``).
        err_local:  its row of the phase-1 residual (``shape``).
        err_server: its slice of the phase-2 residual: the process of rank
                    ``r`` owns rows ``[r * c, (r + 1) * c)`` of the owner dim
                    padded to ``n * c`` (``server_shape``).
        owner:      the owner dim (``owner_dim`` of the param's spec).
        scale_groups: further groups the shared scale is agreed over (those
                    that split the payload without splitting its scale's
                    columns: a tensor-parallel shard of one leaf).

    Returns ``(total, new_err_local, new_err_server)``: the same codes,
    int32 sums, requantization and residuals, element for element, as the
    global view's (the phase-1 codes move in an all-to-all, the phase-2
    codes in an all-gather, both as bytes)."""
    _check_format(bits, scale_axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    qmax = _check_overflow(n, bits)
    wire = _wire_dtype(bits)
    shape = tuple(g.shape)
    if shape == ():
        g, err_local = g[None], err_local[None]

    y = g.to(torch.float32) + err_local
    if scale_axis == "column" and y.dim() >= 2:
        absmax = torch.amax(torch.abs(y), dim=tuple(range(y.dim() - 1)), keepdim=True)
    else:
        absmax = torch.max(torch.abs(y))
    absmax = absmax.contiguous()
    for grp in (group, *scale_groups):
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=grp)
    scale = _div(torch.clamp_min(absmax, _TINY), qmax)
    q = _quantize(y, scale, qmax, wire)
    new_local = y - q.to(torch.float32) * scale

    d_own = q.shape[owner]
    c = -(-d_own // n)
    if c * n != d_own:
        pads = [0, 0] * q.dim()
        pads[2 * (q.dim() - 1 - owner) + 1] = c * n - d_own
        q = F.pad(q, pads)
    if scale.dim() and owner == q.dim() - 1 and scale.shape[-1] > 1:
        scale = F.pad(scale, (0, c * n - d_own), value=1.0)  # per-column scales ride along
    mine = scale.narrow(owner, rank * c, c) if scale.dim() and scale.shape[owner] > 1 else scale

    # phase 1: each owner's slice of every row (an all-to-all), summed in int32
    sent = q.movedim(owner, 0).reshape(n, -1).contiguous()
    recv = torch.empty_like(sent)
    dist.all_to_all_single(recv.view(torch.uint8), sent.view(torch.uint8), group=group)
    rest = q.movedim(owner, 0).shape[1:]
    part_sum = _owner_sum(recv).reshape((c,) + tuple(rest)).movedim(0, owner)
    # phase 2: requantize onto the widened scale; all-gather the codes
    value_sum = part_sum.to(torch.float32) * mine + err_server
    q2 = _quantize(value_sum, mine * n, qmax, wire)
    new_server = value_sum - q2.to(torch.float32) * (mine * n)
    parts = torch.empty((n,) + tuple(q2.movedim(owner, 0).shape), dtype=wire, device=q2.device)
    dist.all_gather(list(parts.view(torch.uint8)), q2.movedim(owner, 0).contiguous()
                    .view(torch.uint8), group=group)
    codes = parts.reshape((n * c,) + tuple(rest)).movedim(0, owner)
    total = (codes.to(torch.float32) * (scale * n)).narrow(owner, 0, d_own)
    return (total.to(g.dtype).reshape(shape), new_local.reshape(shape).to(err_local.dtype),
            new_server.to(err_server.dtype))


def compressed_allreduce_tree(tree, err_tree, *, mesh, axis: str, bits: int = 8,
                              scale_axis: str = "tensor", pspec_tree=None):
    """``compressed_allreduce`` over a stacked-gradient tree.

    ``tree`` leaves are ``(n_shards, *shape)``; ``err_tree`` is the residual
    pair ``{"local": like tree, "server": server_shape per leaf}``
    (``train.state.init_grad_err``); ``pspec_tree`` optionally carries each
    leaf's param spec (``dist.sharding.param_specs``), which picks its owner
    dim.  Returns ``(total_tree, new_err_tree)``."""

    def one(g, el, es, ps=None):
        return compressed_allreduce(g, el, es, mesh=mesh, axis=axis, bits=bits,
                                    scale_axis=scale_axis, pspec=ps)

    rest = (err_tree["local"], err_tree["server"])
    pairs = tree_map(one, tree, *rest, *(() if pspec_tree is None else (pspec_tree,)))
    totals, locals_, servers = tree_unzip(pairs, 3)
    return totals, {"local": locals_, "server": servers}
