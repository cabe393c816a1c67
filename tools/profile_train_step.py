"""Time and profile full-size smollm-135m's A2Q train step on a CUDA card:
the step ``chip_smoke.py``'s phase 4t runs (``build_train_step`` with
``adamw`` and ``cosine_with_warmup``, 8 x 512 tokens of ``TokenStream``,
bf16 compute, fp32 params, ``remat="block"``), from seed 0.

    python3 tools/profile_train_step.py [--steps N]

Prints the card's name and power limit; the mean step time over ``--steps``
steps after 3 warm-up steps (host clock, one sync at the end: the steps
queue back to back as the trainer runs them between two logged steps);
the PyTorch operators one step dispatches (counted with a
``TorchDispatchMode`` on the card's step); and a ``torch.profiler`` trace
of two steps: the device time a step, its share of the unprofiled step
time (1 minus the device's idle share), and the kernels and operators by
device and host time.  No kernel of ``src/repro_torch/csrc`` runs in a
train step, so nothing is built.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.lm import Runtime, init_lm
    from repro_torch.models.steps import build_train_step
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.train.state import init_state
    from repro_torch.train.trainer import _to_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    arch = get_arch("smollm-135m")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
    opt = adamw()
    step = build_train_step(arch, opt, Runtime(), lr_schedule=cosine_with_warmup(3e-3, 5, 100))
    state = init_state(params, opt).tree()
    stream = TokenStream(vocab=arch.vocab, seq_len=512, global_batch=8, seed=0)
    batches = iter(range(10_000))

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _ = step(state, _to_device(stream.batch(next(batches)), dev))

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"train step {step_ms:.1f} ms (mean of {args.steps}), "
          f"{8 * 512 / step_ms * 1e3:.0f} train tok/s", flush=True)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        run(1)
    torch.cuda.synchronize()
    print(f"PyTorch operators a step: {count.n}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ka) / 1e3 / 2
    print(f"profiled 2 steps: device time {dev_ms:.1f} ms a step, {dev_ms / step_ms:.1%} of an "
          f"unprofiled step ({wall / 2 * 1e3:.1f} ms a step under the profiler, whose own host "
          "cost inflates it)", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=20), flush=True)
    print(ka.table(sort_by="self_cpu_time_total", row_limit=12), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
