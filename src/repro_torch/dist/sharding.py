"""Logical-axis sharding rules with divisibility-aware fallback (port of
``repro.dist.sharding``).

Every parameter of the reference is boxed with *logical* axis names:
``embed``, ``heads``, ``kv_heads``, ``mlp``, ``experts``, ``vocab``,
``layers``, plus the activation-only ``batch``.  The port's parameters are
plain tensors in the same tree, so ``param_axes`` reads each leaf's names
from its path (the reference's initializers' boxes, as a table).  This module
maps those names onto mesh axes:

* ``ShardingRules.rules[name]`` — ordered tuple of mesh axes the logical
  axis *wants* to shard over (Megatron-style TP on ``model``, FSDP on
  ``data``, outer DP on ``pod``);
* ``ShardingRules.unit_counts[name]`` — how many *semantic units* the axis
  carries (heads, experts, ffn channels...).  A dim only shards when its unit
  count divides the mesh extent; otherwise it replicates.

A spec is a tuple with one entry a dim: a mesh axis name, a tuple of names,
or ``None`` (replicated).  ``resolve_pspec`` never reuses one mesh axis for
two dims of the same array: earlier dims win.

``Mesh`` describes a mesh: its axis names, their sizes and the devices
behind its positions.  A mesh of one card (``Mesh.on_device``: every
position is that card) is the stacked global view of the compressed train
step.  A mesh bound to the ranks of a ``torch.distributed`` world
(``Mesh.over_ranks``, or ``device_mesh()`` on a description of the world's
size) executes sharded, one process a position: a spec maps onto DTensor
placements (``placements``: an axis named by dim ``d`` is ``Shard(d)`` on
that mesh dim, every other mesh dim ``Replicate()``), ``shard_tree`` places
a tree, DTensor's sharding propagation plays XLA's partitioner, and
``constrain`` (the reference's ``with_sharding_constraint``) redistributes
an activation; all three do nothing without a bound mesh.  Inside
``sharded_scope`` a plain tensor that meets a DTensor counts as replicated
(the positions, masks and constants a forward makes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.nn.module import tree_map, tree_map_with_path

__all__ = [
    "Mesh",
    "NamedSharding",
    "ShardingRules",
    "resolve_pspec",
    "param_axes",
    "param_specs",
    "cache_specs",
    "placements",
    "constrain",
    "shard_tree",
    "full_tree",
    "sharded_scope",
    "forget_dead_worlds",
    "local_shape_and_offset",
    "split_last",
    "merge_last",
    "even_shards",
    "local_as",
]

# (world's default group, device type, names, sizes) -> DeviceMesh: groups are
# made once a world (a fake world's meshes must never reach a later real one);
# a dead world's entries go when the next mesh is made (forget_dead_worlds)
_DEVICE_MESHES: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh: ``axis_names`` and their ``axis_sizes`` (row-major), and the
    device of every position (``devices``, ``prod(axis_sizes)`` of them, or
    empty for a mesh that is only planned)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: tuple = ()
    bound: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} differ in length")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.size} positions")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @staticmethod
    def on_device(device, **axes: int) -> "Mesh":
        """A mesh of ``axes`` (name=size, in order) whose every position is
        ``device``."""
        n = math.prod(axes.values())
        return Mesh(tuple(axes), tuple(axes.values()), (torch.device(device),) * n)

    @staticmethod
    def over_ranks(device_type: str, **axes: int) -> "Mesh":
        """A mesh of ``axes`` (name=size, in order) over the ranks of the
        initialized ``torch.distributed`` world, row-major, bound to its
        ``DeviceMesh``: rank ``r``'s device is ``cuda:{r % device_count}``
        on cards, the CPU otherwise.  Every rank must call it."""
        n = math.prod(axes.values())
        if device_type == "cuda":
            devices = tuple(torch.device("cuda", r % torch.cuda.device_count()) for r in range(n))
        else:
            devices = (torch.device(device_type),) * n
        mesh = Mesh(tuple(axes), tuple(axes.values()), devices)
        mesh.device_mesh()
        return mesh

    @property
    def spmd(self) -> bool:
        """Bound to a world's ranks: the mesh executes sharded."""
        return self.bound is not None

    def device_mesh(self):
        """The torch ``DeviceMesh`` of this description: the same axis names
        and sizes, row-major over the ranks of the initialized world, which
        must have ``size`` of them.  Binds the mesh (``spmd``); made once
        for each layout, since its groups are collective to make."""
        if self.bound is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError("Mesh.device_mesh: no torch.distributed world is initialized")
            if dist.get_world_size() != self.size:
                raise ValueError(f"a mesh of {self.size} positions over a world of "
                                 f"{dist.get_world_size()} ranks")
            kind = self.devices[0].type if self.devices else "cpu"
            key = (dist.distributed_c10d._get_default_group(), kind, self.axis_names,
                   self.axis_sizes)
            if key not in _DEVICE_MESHES:
                from torch.distributed.device_mesh import init_device_mesh

                forget_dead_worlds()
                _DEVICE_MESHES[key] = init_device_mesh(kind, self.axis_sizes,
                                                       mesh_dim_names=self.axis_names)
            object.__setattr__(self, "bound", _DEVICE_MESHES[key])
        return self.bound

    def submesh(self, *names: str) -> "Mesh":
        """The mesh of ``names`` that holds this rank (its coordinates on the
        other axes fixed), bound to the sub-``DeviceMesh``."""
        dm = self.device_mesh()[names if len(names) > 1 else names[0]]
        return Mesh(tuple(names), tuple(self.shape[a] for a in names), bound=dm)

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        return self.device_mesh().get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's position on ``axis``."""
        return self.device_mesh().get_local_rank(axis)


def forget_dead_worlds() -> None:
    """Drop the cached ``DeviceMesh``es of every world but the initialized
    one: a destroyed world's groups neither reach a later world nor stay
    alive.  ``Mesh.device_mesh`` calls it before it makes a mesh, and
    ``launch.mesh`` when it destroys a fake world."""
    world = dist.distributed_c10d._get_default_group() if dist.is_initialized() else None
    for key in [k for k in _DEVICE_MESHES if k[0] is not world]:
        del _DEVICE_MESHES[key]


def _gcd_all(vals: Sequence[int]) -> Optional[int]:
    """gcd of all values (a sharding must divide *every* stack's count)."""
    out = 0
    for v in vals:
        out = math.gcd(out, int(v))
    return out or None


@dataclasses.dataclass
class ShardingRules:
    """Logical-axis -> mesh-axis mapping plus per-axis semantic unit counts."""

    rules: dict
    unit_counts: dict

    @staticmethod
    def default(mesh, arch, *, fsdp: bool = True, seq_shard_extra: bool = False,
                tp_extra: bool = False) -> "ShardingRules":
        """The production layout from the mesh axes and the arch's dims:
        ``data`` carries FSDP (and batch), ``model`` TP/EP, ``pod`` the outer
        data-parallel axis (batch spans ``("pod", "data")``).  ``arch=None``
        gives activation-only rules with no unit counts.  ``fsdp=False``
        keeps params unsharded over ``data``; ``tp_extra`` widens ``vocab``
        onto ``data``; ``seq_shard_extra`` marks the activation ``seq`` axis
        for ``model``."""
        names = tuple(mesh.axis_names)
        model = ("model",) if "model" in names else ()
        data = ("data",) if "data" in names else ()
        batch = tuple(a for a in ("pod", "data") if a in names)
        rules = {
            "batch": batch,
            "embed": data if fsdp else (),
            "heads": model,
            "kv_heads": model,
            "mlp": model,
            "experts": model,
            "vocab": model + (data if tp_extra else ()),
            "layers": (),  # the stacked-layers dim: never sharded
            "seq": model if seq_shard_extra else (),
        }
        unit_counts: dict = {}
        if arch is not None:
            heads, kv_heads, mlp, experts = [], [], [], []
            for s in arch.stacks:
                if s.attn is not None:
                    heads.append(s.attn.heads)
                    kv_heads.append(s.attn.kv_heads)
                if s.ssm is not None and arch.d_model % s.ssm.head_dim == 0:
                    heads.append(arch.d_model // s.ssm.head_dim)
                if s.d_ff:
                    mlp.append(s.d_ff)
                if s.moe is not None:
                    mlp.append(s.moe.d_ff)
                    experts.append(s.moe.n_experts)
                    if s.moe.n_shared:
                        mlp.append(s.moe.shared_d_ff or s.moe.d_ff * s.moe.n_shared)
            unit_counts["embed"] = arch.d_model
            unit_counts["vocab"] = arch.vocab
            for name, count in (("heads", _gcd_all(heads)), ("kv_heads", _gcd_all(kv_heads)),
                                ("mlp", _gcd_all(mlp)), ("experts", _gcd_all(experts))):
                if count is not None:
                    unit_counts[name] = count
        return ShardingRules(rules=rules, unit_counts=unit_counts)


def resolve_pspec(dims, shape, mesh, rules: ShardingRules) -> tuple:
    """Per-dim logical names -> a spec tuple.

    For each dim: take the rule's mesh axes (skipping axes an earlier dim
    used and size-1 axes), then keep the order-preserving subset with the
    *largest* extent such that both the dim's unit count and its size divide
    it; ties prefer earlier axes.  No valid subset -> the dim replicates."""
    used: set = set()
    entries = []
    for name, dim in zip(dims, shape):
        want = rules.rules.get(name) if name is not None else None
        if not want:
            entries.append(None)
            continue
        candidates = tuple(a for a in want
                           if a in mesh.shape and mesh.shape[a] > 1 and a not in used)
        units = rules.unit_counts.get(name, dim)
        axes, best_extent = (), 1
        for mask in range(1, 1 << len(candidates)):
            subset = tuple(a for i, a in enumerate(candidates) if mask >> i & 1)
            extent = math.prod(mesh.shape[a] for a in subset)
            if extent > best_extent and units % extent == 0 and dim % extent == 0:
                axes, best_extent = subset, extent
        if not axes:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return tuple(entries)


# The reference's boxes, by place in the tree.  A linear's (in, out) axes by
# (parent key, name); its ``v``/``w`` take both, ``t``/``d``/``b``/``wq``
# the out axis, ``aq`` none (a deployed linear's ``q8`` and ``s8`` as
# ``v`` and ``t``).  A MoE's expert weights lead with ``experts``.
_LINEAR_AXES = {
    ("attn", "wq"): ("embed", "heads"), ("attn", "wk"): ("embed", "kv_heads"),
    ("attn", "wv"): ("embed", "kv_heads"), ("attn", "wo"): ("heads", "embed"),
    ("attn", "wq_a"): ("embed", None), ("attn", "wq_b"): (None, "heads"),
    ("attn", "wkv_a"): ("embed", None), ("attn", "wkv_b"): (None, "heads"),
    ("mlp", "w_in"): ("embed", "mlp"), ("mlp", "w_gate"): ("embed", "mlp"),
    ("mlp", "w_out"): ("mlp", "embed"),
    ("moe", "shared_in"): ("embed", "mlp"), ("moe", "shared_gate"): ("embed", "mlp"),
    ("moe", "shared_out"): ("mlp", "embed"),
    ("tm", "wr"): ("embed", "heads"), ("tm", "wk"): ("embed", "heads"),
    ("tm", "wv"): ("embed", "heads"), ("tm", "wg"): ("embed", "heads"),
    ("tm", "wo"): ("heads", "embed"),
    ("cm", "wk"): ("embed", "mlp"), ("cm", "wv"): ("mlp", "embed"),
    ("mamba", "in_proj"): ("embed", "heads"), ("mamba", "bc_proj"): ("embed", "heads"),
    ("mamba", "dt_proj"): ("embed", "heads"), ("mamba", "out_proj"): ("heads", "embed"),
    ("mtp", "proj"): (None, "embed"),
}
_EXPERT_AXES = {"w_in": ("experts", "embed", None), "w_gate": ("experts", "embed", None),
                "w_out": ("experts", None, "embed")}
_NORMS = ("ln1", "ln2", "final_norm", "norm_h", "norm_e")
_PLAIN_AXES = {
    ("embed", "table"): ("vocab", "embed"),
    ("moe", "router"): ("embed", None),
    ("tm", "mix"): (None, "embed"), ("tm", "w_lora_a"): ("embed", None),
    ("tm", "w_lora_b"): (None, "heads"), ("tm", "w0"): ("heads",),
    ("tm", "u"): ("heads", None), ("tm", "ln_scale"): ("embed",),
    ("cm", "mix"): ("embed",),
    ("mamba", "A_log"): ("heads",), ("mamba", "D"): ("heads", None),
    ("mamba", "dt_bias"): ("heads",),
    ("q_norm", "scale"): (None,), ("kv_norm", "scale"): (None,),
}


def _leaf_axes(path: tuple, ndim: int, audio: bool) -> tuple:
    """One leaf's logical axes (without the stacked ``layers`` dim)."""
    if len(path) >= 2 and path[-2] in _NORMS:
        return ("embed",)
    if path[-2:] in _PLAIN_AXES:
        return _PLAIN_AXES[path[-2:]]
    # a linear's leaf: (..., parent, name, leaf) or (..., parent, name, aq|wq, log2_scale)
    i = len(path) - (2 if path[-1] == "log2_scale" else 1)
    site, leaf = path[:i], path[i:]
    if site == ("head",):
        axes = ("embed", None if audio else "vocab")
    elif len(site) >= 2 and site[-2:] in _LINEAR_AXES:
        axes = _LINEAR_AXES[site[-2:]]
    elif len(site) >= 2 and site[-2] == "moe" and site[-1] in _EXPERT_AXES:
        axes = _EXPERT_AXES[site[-1]]
        if leaf[0] in ("t", "d", "wq", "s8"):
            return (axes[0], axes[-1])
        return axes if leaf[0] in ("v", "w", "q8") else ()
    elif path[-2:] == ("aq", "log2_scale"):  # the MoE's entry quantizer
        return ()
    else:
        return (None,) * ndim
    if leaf[0] in ("v", "w", "q8"):
        return axes
    if leaf[0] in ("t", "d", "b", "wq", "s8"):
        return (axes[-1],)
    return ()


def param_axes(params: dict) -> dict:
    """The reference's logical axes of every leaf of a model's param tree
    (``models.lm.init_lm``'s: stacked leaves under ``stacks`` and
    ``mtp.block`` lead with ``layers``; the audio family's head has no
    ``vocab`` axis).  A leaf the table does not know replicates, as a plain
    leaf does in the reference."""
    audio = isinstance(params, dict) and "embed" not in params and "head" in params

    def one(path, leaf):
        stacked = path[:1] == ("stacks",) or path[:2] == ("mtp", "block")
        body = path[2:] if stacked else path
        axes = _leaf_axes(body, leaf.dim() - int(stacked), audio) if body else ()
        axes = (("layers",) if stacked else ()) + tuple(axes)
        if len(axes) != leaf.dim():
            raise ValueError(f"axes {axes} do not match {path}'s rank {leaf.dim()}")
        return axes

    return tree_map_with_path(one, params)


def param_specs(params: dict, mesh, rules: ShardingRules) -> dict:
    """Param tree -> spec tree (same structure): each leaf's
    ``param_axes`` resolved on ``mesh`` (``resolve_pspec``).  Works on any
    tensors, ``meta`` ones included (nothing is allocated)."""
    axes = param_axes(params)
    return tree_map(lambda p, a: resolve_pspec(a, tuple(p.shape), mesh, rules), params, axes)


def cache_specs(cache_tree, mesh, rules: ShardingRules):
    """Decode-cache tree -> spec tree, by each leaf's name (its last key)
    and rank, as the reference reads them.

    Contiguous leaves are stacked ``(layers, batch, ...)``: the batch dim
    shards over the batch axes when divisible and the sequence dims stay
    local; GQA ``k``/``v`` ``(layers, batch, slots, kv_heads, head_dim)``
    take the ``kv_heads`` rule on dim 3, SSM states ``S`` ``(layers, batch,
    heads, ...)`` the ``heads`` rule on dim 2.  Paged pools ``kp``/``vp``
    ``(layers, num_blocks, block_size, kv_heads, head_dim)`` keep the block
    axis local and shard the head dim; their int8 scale pools ``kps``/``vps``
    ``(layers, NB, bs, kv_heads)`` likewise; MLA pools (``ckvp``, ``kpep``,
    ``ckvs``, ``kpes``) carry nothing shardable but ``layers``.  The block
    table ``bt`` and the write watermarks ``wm`` ride with the batch; the
    block refcounts ``rc`` replicate."""

    def one(path, leaf):
        name = path[-1] if path else None
        ndim = leaf.dim()
        if name == "wm":
            return resolve_pspec(("batch",) + (None,) * (ndim - 1), tuple(leaf.shape), mesh, rules)
        if name == "rc" or ndim < 2:
            return (None,) * ndim
        if name == "bt":
            return resolve_pspec(("batch",) + (None,) * (ndim - 1), tuple(leaf.shape), mesh, rules)
        if name in ("kp", "vp", "ckvp", "kpep", "kps", "vps", "ckvs", "kpes"):
            dims = ["layers"] + [None] * (ndim - 1)
            if name in ("kp", "vp") and ndim == 5:
                dims[3] = "kv_heads"
            elif name in ("kps", "vps") and ndim == 4:
                dims[3] = "kv_heads"
            return resolve_pspec(tuple(dims), tuple(leaf.shape), mesh, rules)
        dims = ["layers", "batch"] + [None] * (ndim - 2)
        if name in ("k", "v") and ndim == 5:
            dims[3] = "kv_heads"
        elif name == "S" and ndim == 5:
            dims[2] = "heads"
        return resolve_pspec(tuple(dims), tuple(leaf.shape), mesh, rules)

    return tree_map_with_path(one, cache_tree)



# ---------------------------------------------------------------------------
# Sharded execution: specs as DTensor placements over a bound mesh.
# ---------------------------------------------------------------------------


def placements(spec, mesh: Mesh) -> list:
    """A spec's DTensor placements on ``mesh``, one a mesh dim: an axis that
    dim ``d`` of the spec names is ``Shard(d)``, an axis it does not name
    ``Replicate()``.  A dim over several axes (``("data", "model")``) is
    split row-major over them, which is DTensor's order only when they are
    listed in the mesh's own order; an entry in another order is refused by
    name (no placement of plain ``Shard``s lays it out)."""
    names = tuple(mesh.axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of the mesh {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dim {d} lists mesh axes out of the mesh's "
                             f"order {names}: DTensor splits a dim in mesh-dim order, so it is "
                             f"not Shard({d}) on each")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``): ``place``
    distributes a global tensor to it."""

    mesh: Mesh
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor):
        """``t`` (the global tensor, the same on every rank) as a DTensor of
        this layout; each rank keeps its shard."""
        dm = self.mesh.device_mesh()
        return distribute_tensor(t.to(dm.device_type), dm, self.placements)


def local_shape_and_offset(global_shape, device_mesh, placements_) -> tuple:
    """This rank's shard of a tensor of ``global_shape`` laid out by
    ``placements_`` on ``device_mesh``: ``(local shape, global offset)``,
    in Python ints (DTensor's own helper indexes a tensor of offsets, which
    a fake trace cannot read).  Each ``Shard(d)`` splits dim ``d``'s current
    extent as ``torch.chunk`` does, mesh dim by mesh dim."""
    shape, offset = list(global_shape), [0] * len(global_shape)
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if not isinstance(p, Shard):
            continue
        n, c = device_mesh.size(i), coord[i]
        chunk = -(-shape[p.dim] // n)
        size = max(min(shape[p.dim] - c * chunk, chunk), 0)
        offset[p.dim] += min(c * chunk, shape[p.dim])
        shape[p.dim] = size
    return tuple(shape), tuple(offset)


def local_as(t, device_mesh, placements_, grads=None) -> torch.Tensor:
    """This rank's local tensor of ``t`` laid out by ``placements_`` on
    ``device_mesh`` (a plain ``t`` counts as replicated): the way a layer
    steps out of DTensor to run its own code on each rank's shard.  The
    gradient comes back in ``grads`` (default ``placements_``), e.g.
    ``Partial`` where a tensor shared by the rows meets split rows."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, device_mesh, [Replicate()] * device_mesh.ndim, run_check=False)
    return _GradInLayout.apply(t.redistribute(device_mesh, placements_).to_local(
        grad_placements=grads))


class _GradInLayout(torch.autograd.Function):
    """Identity whose gradient comes back in the forward tensor's memory
    layout.  ``to_local``'s backward wraps the local gradient under the
    forward DTensor's global strides; a gradient laid out otherwise (a
    transposed view's, from the layer's local code) would claim strides it
    does not have, and a later view of it on DTensor fails."""

    @staticmethod
    def forward(ctx, t):
        ctx.stride = t.stride()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if g.stride() != ctx.stride and 0 not in ctx.stride:
            g = g.new_empty_strided(g.shape, ctx.stride).copy_(g)
        return g


def even_shards(t: DTensor, dims) -> list:
    """``t``'s placements with a ``Shard`` kept only where it splits one of
    ``dims`` evenly (so a result rebuilt with ``DTensor.from_local`` from
    the local shard has the global shape: an uneven split, as a batch of 1
    over 16 ranks, is gathered instead); every other mesh dim
    ``Replicate``."""
    out, split = [], {}
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim in dims:
            n = split.get(p.dim, 1) * t.device_mesh.size(i)
            if t.shape[p.dim] % n == 0:
                split[p.dim] = n
                out.append(p)
                continue
        out.append(Replicate())
    return out


def split_last(x, *dims: int):
    """``x.reshape(*x.shape[:-1], *dims)`` (the last dim cut into heads);
    on a DTensor whose last dim is split over mesh dims that do not divide
    ``dims[0]`` (fewer heads than shards), those mesh dims are gathered
    first: DTensor cannot cut a shard across a head.  The gradient comes
    back in the cut forward's placement (``_PinGrad``)."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-1], *dims)
    last, split, pl = x.dim() - 1, 1, list(x.placements)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == last:
            split *= x.device_mesh.size(i)
            if dims[0] % split:
                pl[i] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return _PinGrad.apply(x.reshape(*x.shape[:-1], *dims), x.dim() - 1)


class _PinGrad(torch.autograd.Function):
    """Identity whose gradient comes back in the forward's placement.  On a
    mesh dim where the forward was a partial sum (which no gradient can
    take) the gradient keeps its own placement, unless that splits one of
    the reshaped dims (``first`` on), which is gathered."""

    @staticmethod
    def forward(ctx, x, first: int):
        ctx.placements, ctx.first = list(x.placements), first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            want = [p if not p.is_partial() else
                    Replicate() if q.is_shard() and q.dim >= ctx.first else q
                    for p, q in zip(ctx.placements, g.placements)]
            if want != list(g.placements):
                g = g.redistribute(g.device_mesh, want)
        return g, None


def merge_last(x, n: int):
    """``x.reshape(*x.shape[:-2], n)`` (heads merged into the last dim); on
    a DTensor a split of the merged dims that is not an even split of the
    heads' dim alone is gathered first, and the gradient is handed back in
    the merged forward's placement, so the backward's unflatten never meets
    a split that cuts a head."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], n)
    heads, pl, split = x.dim() - 2, list(x.placements), 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim >= heads:
            split *= x.device_mesh.size(i)
            if p.dim != heads or x.shape[heads] % split:
                pl[i] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return _PinGrad.apply(x.reshape(*x.shape[:-2], n), x.dim() - 2)


def constrain(x, mesh: Optional[Mesh], spec):
    """The reference's ``constrain``: ``x`` redistributed to ``spec`` on a
    bound mesh (a plain ``x`` first counts as replicated); a no-op without
    one (one device, or the stacked view of one card)."""
    if mesh is None or not mesh.spmd:
        return x
    dm = mesh.device_mesh()
    want = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
    if list(x.placements) == want:
        return x
    return x.redistribute(dm, want)


def shard_tree(tree, spec_tree, mesh: Mesh):
    """A tree of global tensors placed by a spec tree on a bound mesh (every
    rank passes the same values; each keeps its shards)."""
    return tree_map(lambda t, s: NamedSharding(mesh, tuple(s)).place(t), tree, spec_tree)


def full_tree(tree):
    """Every DTensor leaf gathered to its global tensor (a collective: every
    rank calls it); plain leaves pass."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


@contextlib.contextmanager
def sharded_scope(mesh: Optional[Mesh]):
    """Where a bound mesh executes: a plain tensor that meets a DTensor
    counts as replicated (positions, masks, constants made in a forward),
    as in DTensor's ``implicit_replication``, but nested scopes restore the
    outer one's setting (``implicit_replication`` turns it off on leaving,
    and a checkpointed block's recompute in the backward needs it)."""
    if mesh is None or not mesh.spmd:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before
