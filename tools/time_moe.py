"""Time deepseek-v3's MoE layer of one source tree on a CUDA card: the
layer ``chip_smoke.py`` serves (d_model 7168, 256 routed experts of d_ff
2048, top-8, one shared expert of 2048, deployed int8), through the tree's
own ``nn.moe.apply_moe`` with ``int_forward=True``, at a decode tick (8
rows of one token) and at a prefill chunk (one request's 32 tokens).

    python3 tools/time_moe.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so two commits can be timed on one card in one call: unpack
the other commit with ``git archive`` under ``build/`` and run the script
once on each tree, in turns.  The expert codes and scales are random (the
time does not depend on their values), the router and the activations come
from seed 0, so both trees route the same tokens to the same experts.
Times: CUDA events around 10 back-to-back eager calls after 3 warm-up
calls (a form that reads sizes back to the host cannot be captured in a
graph).  Prints one line per shape and, last, a JSON object of the times
under ``--tag``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = {"decode tick (B=8, T=1)": (8, 1), "prefill chunk (B=1, T=32)": (1, 32)}


def events_ms(fn, reps: int = 10, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def moe_params(cfg, d: int, quant, dev) -> dict:
    """Deployed MoE params at full width: random int8 expert codes in
    [-8, 8] with scales near 1/64, the router and the shared expert's
    linears from the tree's own initializers (seed 0)."""
    from repro_torch.core.quantizers import init_act_quant
    from repro_torch.nn.linear import deploy_linear, init_linear
    from repro_torch.nn.module import kaiming

    gen = torch.Generator(device=dev).manual_seed(0)
    E, f = cfg.n_experts, cfg.d_ff
    p = {"router": kaiming(gen, (d, E), fan_in=d),
         "aq": init_act_quant(quant.act_bits, True, device=dev)}
    for name, (din, dout) in (("w_in", (d, f)), ("w_gate", (d, f)), ("w_out", (f, d))):
        q8 = torch.randint(-8, 9, (E, din, dout), generator=gen, device=dev, dtype=torch.int8)
        s8 = torch.rand((E, dout), generator=gen, device=dev) / 32
        p[name] = {"q8": q8, "s8": s8}
    ff = cfg.shared_d_ff or f * cfg.n_shared
    for name, (din, dout) in (("shared_in", (d, ff)), ("shared_gate", (d, ff)),
                              ("shared_out", (ff, d))):
        p[name] = deploy_linear(init_linear(gen, din, dout, quant), quant)
    return p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_moe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.nn.moe import apply_moe

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.tag}: {args.src}; {smi}", flush=True)
    _build.build_all(("int_matmul", "a2q_quantize"))
    arch = get_arch("deepseek-v3-671b")
    cfg, d = arch.stacks[1].moe, arch.d_model
    params = moe_params(cfg, d, arch.quant, dev)
    res = {"tag": args.tag, "card": smi}
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, (B, T) in SHAPES.items():
        x = torch.randn((B, T, d), generator=gen, device=dev).to(torch.bfloat16)

        def call():
            return apply_moe(params, x, cfg, arch.quant, compute_dtype=torch.bfloat16,
                             int_forward=True)

        torch.cuda.reset_peak_memory_stats()
        ms = events_ms(call)
        peak = torch.cuda.max_memory_allocated() / 1e9
        res[label] = {"ms": ms, "peak_gb": peak}
        print(f"{args.tag}: MoE layer, {label}: {ms:.4f} ms a call, peak allocated "
              f"{peak:.2f} GB", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
