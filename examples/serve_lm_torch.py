"""Serve a small model with batched requests through the port's
continuous-batching engine, with A2Q int8 deployment.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

The twin of ``examples/serve_lm.py``: reduced h2o-danube-1.8b (sliding-window
attention: ring KV caches), deployed to int8 through the ``a2q_quantize``
kernel, five prompts over three slots of the contiguous ``ServeEngine``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.models.lm import init_lm
from repro_torch.serve.engine import ServeEngine, deploy_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    arch = reduced(get_arch("h2o-danube-1.8b"))  # SWA arch: ring KV caches
    params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
    with torch.no_grad():
        deployed = deploy_params(params, arch.quant)
    print(f"arch {arch.name} (reduced), SWA window={arch.stacks[0].attn.window}, "
          f"A2Q deployed to int8 @ P={arch.quant.acc_bits}")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab, (n,)).astype(np.int32) for n in (6, 9, 4, 7, 5)]
    engine = ServeEngine(arch, deployed, batch=3, max_seq=64, device=dev)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=8)
    dt = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"req {i}: prompt[{len(p)}] -> {o}")
    total = sum(map(len, outs))
    print(f"{total} tokens, {total/dt:.1f} tok/s, 5 requests over 3 slots "
          f"(continuous batching)")
    return outs


if __name__ == "__main__":
    main()
