"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake world
of the production mesh and record its per-device cost, memory and
collectives (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step against 512 placeholder host
devices and reads XLA's analyses of the compiled artifact.  The port has no
compiler artifact.  It builds the arch's params, optimizer state, batch and
cache as fake ``cuda`` tensors (``FakeTensorMode``: nothing is allocated),
places them by the reference's specs (``param_specs``, ``make_state_specs``,
``cache_specs``) as DTensors on a fake world of 256 or 512 ranks
(``launch.mesh``), and runs one step of the path the card runs
(``build_train_step`` with adafactor, ``build_prefill_step`` or
``build_serve_step``) as rank 0 would, under ``roofline.cost.CostTrace``.
That trace succeeding IS the dry-run pass; it also supplies the roofline's
terms.  The stacks are a Python loop, so the trace counts every layer: no
marginal-layer extrapolation, and ``raw_cost`` equals ``cost``.  Kernel ops
on fake tensors launch nothing and record their own cost (``kernels.ops``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \\
        --shape decode_32k --opt mla_absorb --tag hc_mla

Results land in experiments/dryrun_torch/<tag>/<arch>__<shape>__<mesh>.json.
Run it in a process of its own: it makes (and destroys) a fake default
process group, which no other world may share.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_arch, input_specs
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.collectives import GradCompressConfig, resolve_grad_compress
from repro_torch.dist.sharding import (ShardingRules, cache_specs, local_shape_and_offset,
                                       param_specs, placements, resolve_pspec)
from repro_torch.launch.mesh import production_mesh
from repro_torch.models.lm import Runtime, init_cache, init_lm
from repro_torch.models.steps import build_prefill_step, build_serve_step, build_train_step
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.optim.optimizers import adafactor
from repro_torch.roofline.analysis import model_flops, roofline_terms, wire_bytes
from repro_torch.roofline.cost import CostTrace

__all__ = ["run_cell", "trace_step", "trace_device", "param_counts", "fake_params", "main"]

METHOD = "per-device trace of local shards (DTensor over a fake world)"
DEVICE_NOTE = {  # why the trace's fake tensors name that device
    "cuda": "fake cuda tensors: the card's path",
    "cpu": ("fake cpu tensors: a CPU-only torch runs no autograd or advanced indexing over "
            "fake cuda ones; the path is still the card's (kernel ops take their fake "
            "branch first, plain versions refuse fake tensors)"),
}
OUT_DIR = "experiments/dryrun_torch"


def param_counts(params: dict, arch) -> dict:
    """Total, active and routed parameter counts of a param tree (the
    reference's ``_param_counts``: routed = the MoE experts' ``w_in``,
    ``w_gate`` and ``w_out`` leaves; active counts ``top_k`` of them)."""
    total = routed = 0
    for path, leaf in tree_leaves_with_path(params):
        n = math.prod(leaf.shape)
        total += n
        if "moe" in path and any(k in path for k in ("w_in", "w_gate", "w_out")):
            routed += n
    active = total
    for s in arch.stacks:
        if s.moe is not None and routed:
            active = total - routed + routed * s.moe.top_k / s.moe.n_experts
            break
    return {"total": total, "active": active, "routed": routed}


def trace_device() -> str:
    """Where a cell's fake tensors live: ``cuda``, the card's path, on a
    torch built with CUDA.  A CPU-only torch cannot run autograd or
    advanced indexing over fake ``cuda`` tensors (their kernels ask for a
    CUDA device guard), so there the cells trace on fake ``cpu`` tensors;
    the path is still the card's: a kernel op takes its fake branch (its
    cost, no plain version) before it looks at the device, the model's
    one device branch (``nn.ssm._recurrence``) takes the kernel's route on
    fake tensors too, and every plain version refuses a fake tensor
    (``kernels._guard``), so a device branch that sent the trace down the
    CPU's path would fail the cell, not cost it.  The record names the
    device (``costing.device`` / ``device_note``)."""
    return "cuda" if torch.version.cuda else "cpu"


def _moved(device: str):
    """A fake CPU tensor's stand-in on ``device`` (a CPU-only torch cannot
    move even a fake tensor to ``cuda``; the values are never read)."""
    return lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)


def fake_params(arch, opts=frozenset(), kind: str = "train", device: str = "cuda") -> dict:
    """``init_lm``'s tree of ``arch`` as fake tensors on ``device`` (call
    under ``FakeTensorMode``); ``int8_weights`` outside training deploys it
    through the port's ``deploy_params`` (the ``a2q_quantize`` op records
    its cost and launches nothing)."""
    params = tree_map(_moved(device), init_lm(torch.Generator(), arch, device="cpu"))
    if "int8_weights" in opts and kind != "train":
        from repro_torch.serve.engine import deploy_params

        params = deploy_params(params, arch.quant)
    return params


def _place(t: torch.Tensor, spec, mesh) -> DTensor:
    """A fake global tensor as the DTensor ``spec`` lays it out on ``mesh``:
    rank 0's shard, made empty (fake) at its local shape."""
    dm = mesh.device_mesh()
    pl = placements(tuple(spec), mesh)
    local_shape, _ = local_shape_and_offset(t.shape, dm, pl)
    local = torch.empty(local_shape, dtype=t.dtype, device=t.device)
    return DTensor.from_local(local, dm, pl, run_check=False, shape=t.shape, stride=t.stride())


def _place_tree(tree, spec_tree, mesh):
    return tree_map(lambda t, s: _place(t, s, mesh), tree, spec_tree)


def _make_runtime(arch, mesh, opts):
    rules = ShardingRules.default(mesh, arch, fsdp="no_fsdp" not in opts,
                                  seq_shard_extra="seq_shard_extra" in opts,
                                  tp_extra="tp_extra" in opts)
    # tp_extra's vocab over ("model", "data") taken in the mesh's order:
    # DTensor lays one dim over several mesh dims only in that order
    # (``dist.sharding.placements`` refuses the other); the same shard sizes
    vocab = rules.rules["vocab"]
    rules.rules["vocab"] = tuple(a for a in mesh.axis_names if a in vocab)
    ep_axis = None
    if any(s.moe is not None for s in arch.stacks):
        # 'ep_both': experts over (model, data): 1 expert a device serving layout
        ep_axis = ("model", "data") if "ep_both" in opts else "model"
    grad_compress = None
    if "grad_compress" in opts:
        grad_compress = GradCompressConfig(
            bits=8, scale_axis="column" if "grad_compress_column" in opts else "tensor")
    # int8_weights: the deployed int8 tree served on the card's path, the
    # fused W8A8 kernel (int_forward), where the reference dequantizes
    rt = Runtime(mesh=mesh, ep_axis=ep_axis, rules=rules, mla_absorb="mla_absorb" in opts,
                 grad_compress=grad_compress, int_forward="int8_weights" in opts)
    return rules, rt


def trace_step(arch, shape: ShapeSpec, mesh, rules, rt, opts=frozenset(), optimizer=None,
               donate: bool = False, lr_schedule=None) -> dict:
    """Build one cell's inputs on ``mesh`` (a bound mesh of fake or real
    ranks) as fake tensors on the mesh's device type and trace one step under ``CostTrace``:
    ``build_train_step`` with ``optimizer`` (default adafactor), the
    prefill step or the serve step, by ``shape.kind``.  Returns the
    reference's ``_lower_compile`` record (``lower_s`` the build and
    placement, ``compile_s`` the trace, ``hlo_bytes`` 0) and the kernel ops
    the trace recorded (``kernels``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    device = mesh.devices[0].type
    # the inputs are made under the mode; the step runs outside it: a fake
    # tensor carries its mode into every op it meets, while the index
    # tensors DTensor makes for its own bookkeeping stay real (under the
    # mode they would be fake, and DTensor reads them on the host)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = fake_params(arch, opts, shape.kind, device)
        counts = param_counts(params, arch)
        pspecs = param_specs(params, mesh, rules)
        batch_specs = input_specs(arch, shape)

        def bspec(dims):
            # divisibility-aware: long_500k's global batch of 1 replicates
            return resolve_pspec(("batch",) + (None,) * (len(dims) - 1), tuple(dims), mesh, rules)

        batch = {k: _place(torch.zeros(v.shape, dtype=v.dtype, device=device), bspec(v.shape),
                           mesh) for k, v in batch_specs.items()}
        if shape.kind == "train":
            from repro_torch.train.state import init_grad_err, init_state, make_state_specs

            optimizer = optimizer or adafactor()
            gc = resolve_grad_compress(rt.grad_compress, mesh)
            state = init_state(params, optimizer).tree()
            if gc is not None:
                state["grad_err"] = init_grad_err(params, mesh.shape[gc.axis], pspecs=pspecs,
                                                  axis=gc.axis)
            state = _place_tree(state, make_state_specs(params, optimizer, mesh, rules, gc), mesh)
            del params
            step = build_train_step(arch, optimizer, rt, lr_schedule=lr_schedule, donate=donate)
            args = (state, batch)
        elif shape.kind == "prefill":
            params = _place_tree(params, pspecs, mesh)
            step = build_prefill_step(arch, rt)
            args = (params, batch)
        else:  # decode: one new token against a seq_len-deep cache
            cache = tree_map(_moved(device),
                             init_cache(arch, shape.global_batch, shape.seq_len, torch.bfloat16,
                                        device="cpu"))
            cache = _place_tree(cache, cache_specs(cache, mesh, rules), mesh)
            params = _place_tree(params, pspecs, mesh)
            step = build_serve_step(arch, rt)
            args = (params, batch["tokens"], cache, torch.zeros((), dtype=torch.int32,
                                                                device=device))
    lower_s = time.time() - t0
    t1 = time.time()
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad, CostTrace() as trace:
        out = step(*args)
    compile_s = time.time() - t1
    memory = trace.memory_analysis(args, out)
    del out, args
    return {"lower_s": round(lower_s, 2), "compile_s": round(compile_s, 2), "counts": counts,
            "memory_analysis": memory, "cost": trace.cost(), "hlo_bytes": 0,
            "collectives": trace.collectives(), "kernels": dict(trace.kernels)}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, opts: Optional[set] = None,
             out_dir: str = OUT_DIR, tag: str = "baseline", costing: bool = True, *,
             arch=None, shape: Optional[ShapeSpec] = None) -> dict:
    """One cell on a fake production world (made here and destroyed before
    returning): the record the reference writes, with the port's costing.
    ``arch``/``shape`` replace the named config and shape (a cut-down cell;
    the record keeps the names)."""
    opts = set(opts or ())
    arch = arch or get_arch(arch_name)
    if "remat_none" in opts:
        arch = dataclasses.replace(arch, remat="none")
    shape = shape or SHAPES[shape_name]
    with production_mesh(multi_pod=multi_pod, device_type=trace_device()) as mesh:
        rules, rt = _make_runtime(arch, mesh, opts)
        record = {"arch": arch_name, "shape": shape_name,
                  "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": mesh.size,
                  "opts": sorted(opts), "tag": tag}
        full = trace_step(arch, shape, mesh, rules, rt, opts)

        # train cells with grad_compress ON price the compressed-gradient
        # wire: the same cell traced with the opt off, and the two
        # collective records compared (the reference's twin compile)
        grad_compress_cmp = None
        if shape.kind == "train" and "grad_compress" in opts:
            bits = 8
            alt_opts = opts - {"grad_compress"}
            alt_rules, alt_rt = _make_runtime(arch, mesh, alt_opts)
            base_info = trace_step(arch, shape, mesh, alt_rules, alt_rt, alt_opts)
            base, comp = base_info["collectives"], full["collectives"]
            grad_wire = comp["gradient_wire_bytes"]
            fp32_equiv = grad_wire * (32 // bits)
            grad_compress_cmp = {
                "enabled": True,
                "bits": bits,
                "scale_axis": "column" if "grad_compress_column" in opts else "tensor",
                "gradient_wire_bytes": grad_wire,
                "fp32_equivalent_bytes": fp32_equiv,
                "wire_bytes_saved": fp32_equiv - grad_wire,
                "baseline_program_wire": wire_bytes(base),
                "compressed_program_wire": wire_bytes(comp),
                "program_wire_delta": wire_bytes(base) - wire_bytes(comp),
                "baseline_f32_allreduce_bytes": base["bytes_by_kind"]["all-reduce"],
                "compressed_f32_allreduce_bytes": comp["bytes_by_kind"]["all-reduce"],
            }
            record["grad_compress"] = grad_compress_cmp

    record.update(
        lower_s=full["lower_s"],
        compile_s=full["compile_s"],
        memory_analysis=full["memory_analysis"],
        raw_cost=full["cost"],
        raw_collectives=full["collectives"],
        hlo_bytes=full["hlo_bytes"],
        params_total=full["counts"]["total"],
        params_active=full["counts"]["active"],
    )
    # no extrapolation: the trace counts every layer, so the costed record is
    # the raw one (``costing=False``, the reference's compile-only pass, only
    # leaves the ``costing`` block out)
    record["cost"] = dict(full["cost"])
    record["collectives"] = {"total_bytes": full["collectives"]["total_bytes"],
                             "bytes_by_kind": dict(full["collectives"]["bytes_by_kind"])}
    if costing:
        record["costing"] = {"method": METHOD, "device": trace_device(),
                             "device_note": DEVICE_NOTE[trace_device()],
                             "kernels": full["kernels"], "n_variants": 0}
    if grad_compress_cmp is not None:
        record["collectives"]["wire_bytes_saved"] = grad_compress_cmp["wire_bytes_saved"]
        record["collectives"]["gradient_wire_bytes"] = full["collectives"]["gradient_wire_bytes"]

    if shape.kind == "train":
        mf = model_flops(record["params_active"], shape.global_batch * shape.seq_len, "train")
    elif shape.kind == "prefill":
        mf = model_flops(record["params_active"], shape.global_batch * shape.seq_len, "fwd")
    else:
        mf = model_flops(record["params_active"], shape.global_batch, "fwd")
    terms = roofline_terms(flops_per_device=record["cost"]["flops"],
                           bytes_per_device=record["cost"]["bytes accessed"],
                           collective_bytes_per_device=record["collectives"]["total_bytes"],
                           n_chips=record["n_chips"])
    record["roofline"] = terms
    record["model_flops"] = mf
    flops_dev = record["cost"]["flops"]
    record["useful_flops_ratio"] = (mf / record["n_chips"]) / flops_dev if flops_dev else None

    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    fn = os.path.join(out_dir, tag, f"{arch_name}__{shape_name}__{record['mesh']}.json")
    with open(fn, "w") as f:
        json.dump(record, f, indent=1)
    useful = record["useful_flops_ratio"]
    line = (f"[ok] {arch_name:24s} {shape_name:12s} {record['mesh']:8s} "
            f"trace={record['compile_s']}s dominant={terms['dominant']} "
            f"bound={terms['bound_s']:.4f}s")
    if useful is not None:
        line += f" useful={useful:.3f}"
    if grad_compress_cmp is not None:
        line += f" wire_saved={grad_compress_cmp['wire_bytes_saved']:.3g}B"
    print(line, flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="append", default=[], help="hillclimb toggles")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-costing", action="store_true",
                    help="trace-only record (no costing block)")
    args = ap.parse_args(argv)

    cells = []
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        arch = get_arch(a)
        shapes = applicable_shapes(arch) if (args.all or args.shape is None) else [args.shape]
        for s in shapes:
            for m in {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]:
                cells.append((a, s, m))

    failures = []
    for a, s, m in cells:
        t0 = time.time()
        try:
            # the costing block on the single-pod mesh only (the reference's
            # roofline is single-pod); the multi-pod pass is the trace proof
            run_cell(a, s, m, set(args.opt), args.out, args.tag,
                     costing=(not m) and not args.no_costing)
        except Exception:
            failures.append((a, s, "multi" if m else "single"))
            print(f"[FAIL] {a} {s} {'multi' if m else 'single'}", flush=True)
            traceback.print_exc()
        print(f"[cell] {a} {s} {'multi' if m else 'single'} {time.time() - t0:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print(f"all {len(cells)} cells passed")


if __name__ == "__main__":
    main()
