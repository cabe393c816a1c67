"""Training launcher: A2Q training of a token decoder, on one device or
sharded over the ranks ``torchrun`` starts.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 512 [--ckpt-dir DIR --ckpt-every 50] \\
        [--reduced] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --mesh auto --device cpu --reduced --arch yi-6b --steps 6 --batch 8 --seq 32

Port of ``repro.launch.train``: params from the port's
``init_lm`` with a ``torch.Generator`` seeded from ``--seed``, the
``TokenStream`` bigram data, ``build_train_step`` with ``--optimizer`` and a
cosine schedule with warmup peaking at ``--lr``, the ``Trainer`` with
checkpoints (a rerun with the same ``--ckpt-dir`` resumes, printing
``resumed from step N``) and an emergency save on SIGTERM.  Every
``lm``-family arch trains: dense, MoE (deepseek-v3 with its MTP head, whose
``mtp_ce`` is printed beside the loss; llama4-scout), rwkv6 and hymba.  As
the reference's, the launcher trains from ``TokenStream`` alone: llava-next
trains as a text decoder, and hubert (no token embedding) fails.
``--device`` defaults to ``cuda``.  ``--grad-compress-bits`` /
``--grad-compress-scale`` ask for the compressed data-parallel gradient
reduction; without a multi-rank data axis the launcher says so, as the
reference does, and trains uncompressed.

``--mesh auto`` in a world of ``WORLD_SIZE > 1`` ranks (``torchrun`` sets
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and the rendezvous) trains sharded,
as the reference does over its devices: ``plan_mesh`` over the world (the
attention heads as the model axis's divisors), ``ShardingRules.default``,
the state placed by ``train.state.shard_state``, ``ep_axis="model"`` for
MoE stacks, ``grad_err`` placed by the param specs, and the reference's
``mesh: {...}`` line.  Each rank runs on ``cuda:{LOCAL_RANK %
device_count}`` over NCCL, or on the CPU over gloo; rank 0 prints.  A
world of one rank trains unsharded, as the reference does on one device.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist.collectives import GradCompressConfig, resolve_grad_compress
from repro_torch.dist.sharding import Mesh, ShardingRules, param_specs
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.models.steps import build_train_step
from repro_torch.optim.optimizers import adafactor, adamw, sgdm
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train.checkpoint import install_signal_handler
from repro_torch.train.elastic import StragglerWatchdog, plan_mesh
from repro_torch.train.state import (
    init_grad_err,
    init_state,
    make_state_specs,
    shard_state,
    specs_to_shardings,
)
from repro_torch.train.trainer import Trainer

_OPTS = {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-runnable reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", choices=sorted(_OPTS), default="adamw")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["auto", "none"], default="auto")
    ap.add_argument(
        "--grad-compress-bits", type=int, default=0,
        help="int wire width for the data-parallel gradient all-reduce "
             "(0 = off, fp32; 8 = int8 wire with error feedback)",
    )
    ap.add_argument(
        "--grad-compress-scale", choices=["tensor", "column"], default="tensor",
        help="compressed-gradient scale granularity: one scale per leaf, or "
             "one per output column (A2Q+-style)",
    )
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = rules = None
    if args.mesh == "auto" and world > 1:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) %
                               torch.cuda.device_count())
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        plan = plan_mesh(world, model_divisors=[s.attn.heads for s in arch.stacks if s.attn])
        mesh = Mesh.over_ranks(dev.type, **dict(zip(plan["axes"], plan["shape"])))
        rules = ShardingRules.default(mesh, arch)
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if mesh is not None:
        say(f"mesh: {mesh.shape}")
    ep_axis = "model" if mesh is not None and any(s.moe for s in arch.stacks) else None

    params = init_lm(torch.Generator().manual_seed(args.seed), arch, device=dev)
    optimizer = _OPTS[args.optimizer]()
    state = init_state(params, optimizer).tree()

    grad_compress = None
    if args.grad_compress_bits:
        grad_compress = GradCompressConfig(bits=args.grad_compress_bits,
                                           scale_axis=args.grad_compress_scale)
    gc = resolve_grad_compress(grad_compress, mesh)
    if grad_compress is not None and gc is None:
        say("grad-compress requested but no multi-device data axis: running uncompressed")
    shardings = None
    if gc is not None:
        state["grad_err"] = init_grad_err(params, mesh.shape[gc.axis],
                                          pspecs=param_specs(params, mesh, rules), axis=gc.axis)
        say(f"grad-compress: int{gc.bits} wire over '{gc.axis}' ({gc.scale_axis} scale)")
    if mesh is not None:
        shardings = specs_to_shardings(make_state_specs(params, optimizer, mesh, rules, gc), mesh)
        state = shard_state(state, optimizer, mesh, rules, gc)
        del params

    sched = cosine_with_warmup(args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    rt = Runtime(mesh=mesh, rules=rules, ep_axis=ep_axis, grad_compress=grad_compress)
    step_fn = build_train_step(arch, optimizer, rt, lr_schedule=sched)

    stream = TokenStream(vocab=arch.vocab, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed)
    trainer = Trainer(step_fn, stream.batch, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, watchdog=StragglerWatchdog())
    # older checkpoints have no grad_err leaves; residuals restart from zeros
    state, start = trainer.maybe_restore(state, allow_missing=gc is not None,
                                         shardings=shardings)
    if start:
        say(f"resumed from step {start}")
    if args.ckpt_dir:
        install_signal_handler(trainer.emergency_save)

    result = trainer.run(state, args.steps, start_step=start)
    if not lead:
        return result
    for rec in result.history[:3] + result.history[-3:]:
        print({k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()})
    if result.straggler_events:
        print(f"straggler events: {len(result.straggler_events)}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result.history, f, indent=1)
    first, last = result.history[0]["loss"], result.history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f}")
    if "mtp_ce" in result.history[-1]:
        print(f"mtp_ce {result.history[0]['mtp_ce']:.4f} -> {result.history[-1]['mtp_ce']:.4f}")
    return result


if __name__ == "__main__":
    main()
