"""The port's dry-run and roofline against the reference, on the CPU.

* **Per-device FLOPs** of a DTensor program on a fake ``(16, 16)`` world: a
  sharded matmul counts the global product / 256, exactly; ``x * 2`` on a
  ``Shard(0)`` DTensor counts its local product only (DTensor's sharding
  propagation runs the op once more on fake tensors of the global shape,
  which is no rank's work).
* **Analysis**: ``model_flops`` and ``wire_bytes`` equal to the reference's
  on ``tests/test_roofline.py``'s cases; ``roofline_terms`` equal to the
  reference's term by term once each is rescaled by the ratio of the two
  packages' hardware figures; the collective record's rules on hand-made op
  records (both c10d forms counted once, ``wait_tensor`` never, 8- and
  16-bit integer gathers and all-to-alls as gradient wire).
* **Configs**: ``input_specs`` shapes and dtypes equal to the reference's
  for every arch x applicable shape; ``params_total`` / ``params_active`` of
  full-size yi-6b and smollm-135m on fake tensors equal to the reference's
  committed dry-run records.
* **Cells**: every arch's reduced config through ``run_cell`` at one
  applicable shape (small batch and sequence) on the fake ``(16, 16)``
  world (two of them deployed, ``int8_weights``), the record written with
  the reference's keys; the kernel ops on
  fake tensors launch nothing and record the kernel's cost.
* **The card's path**: every plain kernel version, and the rwkv6 forms
  outside autograd, refuse fake tensors, so a cell traced on fake ``cpu``
  tensors (a CPU-only torch) cannot cost the CPU's path unnoticed.
* **No world left behind**: after every case, no default process group and
  no ``DeviceMesh`` of a world it made in ``dist.sharding``'s cache.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_arch as jget_arch
from repro.configs import input_specs as jinput_specs
from repro.roofline import hw as jhw
from repro.roofline.analysis import collective_bytes_from_hlo
from repro.roofline.analysis import model_flops as jmodel_flops
from repro.roofline.analysis import roofline_terms as jroofline_terms
from repro.roofline.analysis import wire_bytes as jwire_bytes

from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_arch, input_specs, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh, make_production_mesh, production_mesh
from repro_torch.models.lm import init_lm
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (
    collective_bytes_from_trace,
    link_bytes_per_s,
    model_flops,
    roofline_terms,
    wire_bytes,
)
from repro_torch.roofline.cost import CostTrace

ROOT = Path(__file__).resolve().parents[1]
RECORDS = {"yi-6b": ROOT / "experiments/dryrun/pr3_smoke/yi-6b__decode_32k__16x16.json",
           "smollm-135m": ROOT / "experiments/dryrun/pr3_gc/smollm-135m__train_4k__16x16.json"}
# one applicable kind an arch for the reduced cells (every kind is covered)
CELL_KIND = {"smollm-135m": "train", "yi-6b": "decode", "rwkv6-7b": "decode",
             "hymba-1.5b": "decode", "llava-next-34b": "decode"}
INT8_CELLS = ("command-r-35b", "yi-6b")  # with ``int8_weights``: the deployed tree, int_forward


@pytest.fixture(autouse=True)
def _no_world_left():
    """Every case leaves no default group and no mesh of a world it made
    behind."""
    torch.set_num_threads(1)
    before = set(sharding._DEVICE_MESHES)
    yield
    assert not dist.is_initialized()
    assert set(sharding._DEVICE_MESHES) <= before


def _fake_dtensors(mesh, *specs):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    out = []
    with FakeTensorMode():
        for shape, placements in specs:
            local, _ = sharding.local_shape_and_offset(shape, mesh.device_mesh(), placements)
            out.append(DTensor.from_local(torch.empty(local, device="cpu"), mesh.device_mesh(),
                                          placements, run_check=False))
    return out


def test_sharded_matmul_counts_the_global_product_over_the_mesh():
    """4096x4096 @ 4096x11008 as ``[Shard(0), Replicate()]`` x
    ``[Replicate(), Shard(1)]`` on 16x16: the trace sees the local ``mm``
    (256, 4096) x (4096, 688), exactly 1/256 of ``FlopCounterMode``'s
    global count."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    with production_mesh(device_type="cpu") as mesh:
        a, b = _fake_dtensors(mesh, ((4096, 4096), [Shard(0), Replicate()]),
                              ((4096, 11008), [Replicate(), Shard(1)]))
        with CostTrace() as trace:
            z = a @ b
        with FlopCounterMode(display=False) as fc:
            a @ b
        assert tuple(z.to_local().shape) == (256, 688)
    assert fc.get_total_flops() == 2 * 4096 * 4096 * 11008
    assert trace.flops * 256 == fc.get_total_flops()
    assert trace.ops["aten.mm"] == 1
    assert trace.bytes_accessed == 4 * (256 * 4096 + 4096 * 688 + 256 * 688)


def test_propagation_pass_is_left_out():
    """``x * 2`` on a ``Shard(0)`` DTensor: DTensor's propagation runs one
    ``mul`` on the global (4096, 4096) shape; the trace counts only the
    rank's (256, 4096) product, its bytes in and out."""
    from torch.distributed.tensor import Replicate, Shard

    with production_mesh(device_type="cpu") as mesh:
        (x,) = _fake_dtensors(mesh, ((4096, 4096), [Shard(0), Replicate()]))
        with CostTrace() as trace:
            x * 2
    assert dict(trace.ops) == {"aten.mul": 1}
    assert trace.bytes_accessed == 2 * 4 * 256 * 4096
    assert trace.temp_peak == 4 * 256 * 4096


def test_model_flops_and_wire_bytes_equal_the_reference():
    for n, d in ((1e9, 1e6), (134826258, 256 * 4096), (6063424737, 128)):
        for kind in ("train", "fwd"):
            assert model_flops(n, d, kind) == jmodel_flops(n, d, kind)
    hlo = """
  %ar = f32[100]{0} all-reduce(f32[100]{0} %x)
  %ag = s8[100]{0} all-gather(s8[10]{0} %y), dimensions={0}
  %rs = f32[2,256]{1,0} reduce-scatter(f32[16,256]{1,0} %z), dimensions={0}
    """
    ref = collective_bytes_from_hlo(hlo)
    mine = collective_bytes_from_trace([
        {"op": "_c10d_functional.all_reduce", "tensors": [("float32", 400)]},
        {"op": "c10d.allgather_", "tensors": [("int8", 100)]},
        {"op": "_c10d_functional.reduce_scatter_tensor", "tensors": [("float32", 2048)]},
    ])
    assert mine == ref
    assert wire_bytes(mine) == jwire_bytes(ref) == 2 * 400 + 100 + 2048


@pytest.mark.parametrize("n_chips", [1, 8, 256, 512])
def test_roofline_terms_rescale_to_the_reference(n_chips):
    """The same formula over the port's figures: each term times its
    denominator is the reference's term times the reference's."""
    kw = dict(flops_per_device=3.3e13, bytes_per_device=1.7e11,
              collective_bytes_per_device=2.9e9, n_chips=n_chips)
    t, r = roofline_terms(**kw), jroofline_terms(**kw)
    assert t["compute_s"] * hw.BF16_FLOPS_PER_S == pytest.approx(
        r["compute_s"] * jhw.PEAK_FLOPS_BF16, rel=1e-12)
    assert t["memory_s"] * hw.HBM_BYTES_PER_S == pytest.approx(r["memory_s"] * jhw.HBM_BW,
                                                              rel=1e-12)
    assert t["collective_s"] * link_bytes_per_s(n_chips) == pytest.approx(
        r["collective_s"] * jhw.ICI_LINK_BW * 4, rel=1e-12)
    assert set(t) == set(r) and t["n_chips"] == r["n_chips"] == n_chips
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])
    assert t["dominant"] == max(("compute_s", "memory_s", "collective_s"), key=t.get)
    assert t["roofline_fraction"] == t["compute_s"] / t["bound_s"]
    assert link_bytes_per_s(n_chips) == (hw.NVLINK_BYTES_PER_S if n_chips <= 8
                                         else hw.NIC_BYTES_PER_S)


def test_collective_record_rules():
    """Both forms of a collective count once (functional and in-place c10d),
    a ``wait_tensor`` never; an 8- or 16-bit integer all-gather or
    all-to-all is gradient wire (the ``uint8`` views included), an int8
    all-reduce or an fp32 gather is not."""
    recs = [
        {"op": "_c10d_functional.all_gather_into_tensor.default", "tensors": [("bfloat16", 64)]},
        {"op": "_c10d_functional.wait_tensor.default", "tensors": [("bfloat16", 64)]},
        {"op": "c10d.allgather_.default", "tensors": [("uint8", 32), ("uint8", 32)]},
        {"op": "c10d.alltoall_base_", "tensors": [("int8", 16)]},
        {"op": "_c10d_functional.all_to_all_single", "tensors": [("int16", 8)]},
        {"op": "c10d.allreduce_", "tensors": [("int8", 4)]},
        {"op": "_c10d_functional.all_reduce", "tensors": [("float32", 40)]},
        {"op": "c10d._reduce_scatter_base_", "tensors": [("float32", 12)]},
        {"op": "aten.mm", "tensors": [("float32", 1000)]},
    ]
    r = collective_bytes_from_trace(recs)
    assert r["counts"] == {"all-reduce": 2, "all-gather": 2, "reduce-scatter": 1,
                           "all-to-all": 2, "collective-permute": 0}
    assert r["bytes_by_kind"] == {"all-reduce": 44, "all-gather": 128, "reduce-scatter": 12,
                                  "all-to-all": 24, "collective-permute": 0}
    assert r["total_bytes"] == 208
    assert (r["gradient_wire_bytes"], r["gradient_wire_counts"]) == (64 + 16 + 8, 3)


_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_match_the_reference(name):
    arch, jarch = get_arch(name), jget_arch(name)
    assert applicable_shapes(arch) == japplicable(jarch)
    for shape in applicable_shapes(arch):
        for per_pod in (None, 8):
            mine = input_specs(arch, SHAPES[shape], per_pod_batch=per_pod)
            ref = jinput_specs(jarch, JSHAPES[shape], per_pod_batch=per_pod)
            assert sorted(mine) == sorted(ref), (name, shape)
            for k, v in ref.items():
                assert mine[k].device.type == "meta"
                assert tuple(mine[k].shape) == tuple(v.shape), (name, shape, k)
                assert mine[k].dtype == _DT[v.dtype.type], (name, shape, k)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_param_counts_equal_the_reference_records(name):
    """Full size on fake tensors: nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rec = json.loads(RECORDS[name].read_text())
    with FakeTensorMode():
        counts = dryrun.param_counts(dryrun.fake_params(get_arch(name), device="cpu"),
                                     get_arch(name))
    assert counts["total"] == rec["params_total"]
    assert counts["active"] == rec["params_active"]


def _cell_arch(name):
    """The reduced config; a MoE's 8 experts raised to 16 so the EP axis
    (``model``, 16 ranks) divides them, as the full configs' do."""
    arch = reduced(get_arch(name))
    return dataclasses.replace(arch, stacks=tuple(
        dataclasses.replace(s, moe=dataclasses.replace(s.moe, n_experts=16)) if s.moe else s
        for s in arch.stacks))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_cell_on_the_fake_pod(name, tmp_path):
    """One cell of each arch's reduced config on the fake 16x16 world, by
    ``run_cell``: the record has the reference's keys, ``raw_cost`` equals
    ``cost``, and a prefill records its kernel ops (flash attention, the
    rwkv6 scan; with ``int8_weights`` every linear's ``int_matmul``)
    instead of running their plain versions, which would raise on the fake
    tensors (``kernels._guard``)."""
    arch = _cell_arch(name)
    kind = CELL_KIND.get(name, "prefill")
    shape_name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    shape = ShapeSpec(shape_name, kind, 64, 32)
    opts = {"int8_weights"} if name in INT8_CELLS else set()
    rec = dryrun.run_cell(name, shape_name, False, opts, str(tmp_path), "t", arch=arch,
                          shape=shape)
    ref = json.loads(RECORDS["yi-6b"].read_text())
    on_disk = json.loads((tmp_path / "t" / f"{name}__{shape_name}__16x16.json").read_text())
    assert set(ref) <= set(on_disk) and on_disk["costing"]["method"] == dryrun.METHOD
    assert on_disk["costing"]["device"] == dryrun.trace_device()
    assert on_disk["costing"]["device_note"] == dryrun.DEVICE_NOTE[dryrun.trace_device()]
    assert rec["raw_cost"] == rec["cost"] and rec["hlo_bytes"] == 0 and rec["n_chips"] == 256
    assert rec["cost"]["flops"] > 0 and rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    tree = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    if opts and kind != "train":  # counted as deployed, as the reference counts them
        from repro_torch.serve.engine import deploy_params

        with torch.no_grad():
            tree = deploy_params(tree, arch.quant)
    assert rec["params_total"] == dryrun.param_counts(tree, arch)["total"]
    kernels = rec["costing"]["kernels"]
    if kind == "prefill" and any(s.attn is not None and s.attn.kind == "gqa" and
                                 s.attn.chunk is None for s in arch.stacks):
        assert kernels.get("flash_attention", 0) > 0, kernels
    if name == "rwkv6-7b":
        assert kernels.get("rwkv6_scan", 0) == arch.n_layers, kernels
    if name in INT8_CELLS:  # every deployed linear on the W8A8 kernel: 7 a layer + the head
        assert kernels.get("int_matmul", 0) == 7 * arch.n_layers + 1, kernels


def test_kernel_ops_on_fake_tensors_record_their_cost():
    """On fake tensors an op returns empty outputs of the kernel's shapes
    and dtypes, launches nothing, and adds the kernel's operations and bytes
    (``chip_smoke.py``'s ``bound_ms`` counts) to the trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops

    before = ops.launch_counts()
    with FakeTensorMode():
        x = torch.empty(16, 256, dtype=torch.int8)
        w = torch.empty(256, 64, dtype=torch.int8)
        q = torch.empty(2, 4, 32, 16, dtype=torch.bfloat16)
        kv = torch.empty(2, 2, 32, 16, dtype=torch.bfloat16)
        r = torch.empty(1, 2, 8, 16)
        with CostTrace() as trace:
            y = ops.int_matmul(x, w)
            ys = ops.int_matmul(x, w, scale=0.5)
            o = ops.flash_attention(q, kv, kv, causal=True)
            yr, S = ops.rwkv6_scan(r, r, r, r, torch.empty(2, 16))
    assert (y.dtype, tuple(y.shape), ys.dtype) == (torch.int32, (16, 64), torch.float32)
    assert (o.dtype, tuple(o.shape)) == (torch.bfloat16, (2, 4, 32, 16))
    assert tuple(yr.shape) == (1, 2, 8, 16) and tuple(S.shape) == (1, 2, 16, 16)
    assert dict(trace.kernels) == {"int_matmul": 2, "flash_attention": 1, "rwkv6_scan": 1}
    want = 2 * 2 * 16 * 256 * 64 + 4 * 2 * 4 * 16 * (32 * 33 // 2) + 7 * 2 * 8 * 16 * 16
    assert trace.flops == want
    assert ops.launch_counts() == before


def test_fake_world_meshes_are_dropped_on_close():
    """A fake world's ``DeviceMesh`` is cached under that world only and
    dropped when it closes; a second world of the same layout gets its own;
    ``make_production_mesh``'s world, destroyed by hand, loses its entries
    when the next mesh is made."""
    with fake_mesh("cpu", data=2, model=2) as m1:
        dm1 = m1.device_mesh()
        world = dist.distributed_c10d._get_default_group()
        assert [v for k, v in sharding._DEVICE_MESHES.items() if k[0] is world] == [dm1]
    assert not [k for k in sharding._DEVICE_MESHES if k[0] is world]
    with fake_mesh("cpu", data=2, model=2) as m2:
        assert m2.device_mesh() is not dm1
    # the reference's entry point leaves its world up; the next mesh made
    # drops the dead world's entries
    mesh = make_production_mesh(device_type="cpu")
    world = dist.distributed_c10d._get_default_group()
    assert (mesh.axis_names, mesh.axis_sizes, dist.get_world_size()) == (
        ("data", "model"), (16, 16), 256)
    dist.destroy_process_group()
    with fake_mesh("cpu", data=2):
        assert not [k for k in sharding._DEVICE_MESHES if k[0] is world]
    with pytest.raises(RuntimeError, match="already initialized"):
        with fake_mesh("cpu", data=2):
            with fake_mesh("cpu", data=2):
                pass


def test_heads_cut_from_a_partial_sum_take_their_gradient():
    """``split_last`` / ``merge_last`` of a DTensor that is a partial sum
    over a mesh dim (a linear's output before its reduction, as MLA's
    ``wq_b`` in a sharded train step): the backward hands the gradient back
    in a placement a gradient can take, not the partial sum, which DTensor
    refuses."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with fake_mesh("cpu", data=2, model=2) as mesh:
        dm = mesh.device_mesh()
        local = torch.randn(4, 3, 8, requires_grad=True)
        x = DTensor.from_local(local, dm, [Shard(0), Partial()], run_check=False)
        heads = sharding.split_last(x, 2, 4)
        y = sharding.merge_last(heads * 2, 8)
        assert heads.placements == y.placements == (Shard(0), Partial())
        y.redistribute(dm, [Shard(0), Replicate()]).to_local().sum().backward()
    assert torch.equal(local.grad, torch.full((4, 3, 8), 2.0))


def test_plain_versions_refuse_fake_tensors():
    """A plain kernel version reached with a fake tensor raises (a dry-run
    must cost the card's path, which launches the kernel there); the rwkv6
    forms too, unless autograd records an argument (training runs them on
    the card as well).  Real tensors pass as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.int_matmul import int_matmul_plain
    from repro_torch.kernels.paged_mla_attention import paged_mla_attention_plain
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.nn.ssm import rwkv6_chunked

    r, u, S0 = torch.randn(1, 2, 8, 4), torch.randn(2, 4), torch.zeros(1, 2, 4, 4)
    want, _ = rwkv6_chunked(r, r, r, r.sigmoid(), u, S0, chunk=4)
    with FakeTensorMode():
        x, w = torch.empty(4, 8, dtype=torch.int8), torch.empty(8, 4, dtype=torch.int8)
        q = torch.empty(1, 2, 4, 8)
        fr, fu, fS = torch.empty(1, 2, 8, 4), torch.empty(2, 4), torch.empty(1, 2, 4, 4)
        calls = {
            "int_matmul_plain": lambda: int_matmul_plain(x, w, block_k=8),
            "flash_attention_plain": lambda: flash_attention_plain(q, q, q, causal=True,
                                                                   window=None, scale=1.0),
            "ref_paged_mla_attention": lambda: paged_mla_attention_plain(
                torch.empty(1, 2, 4), torch.empty(1, 2, 2), torch.empty(2, 4, 4),
                torch.empty(2, 4, 2), torch.empty(1, 1, dtype=torch.int32),
                torch.empty(1, dtype=torch.int32), scale=1.0),
            "rwkv6_scan_plain": lambda: rwkv6_scan_plain(fr, fr, fr, fr, fu, out_dtype=torch.float32),
            "rwkv6_chunked": lambda: rwkv6_chunked(fr, fr, fr, fr, fu, fS, chunk=4),
        }
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match=f"^{name}: a plain version reached on fake"):
                call()
        y, _ = rwkv6_chunked(fr, fr, fr, fr, fu.requires_grad_(), fS, chunk=4)
        assert tuple(y.shape) == (1, 2, 8, 4)
    got, _ = rwkv6_chunked(r, r, r, r.sigmoid(), u, S0, chunk=4)
    assert torch.equal(got, want)
