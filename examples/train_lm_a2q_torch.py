"""End-to-end example on the PyTorch port: train the full smollm-135m config
(135M params, A2Q hidden layers targeting 16-bit accumulators) for a few
hundred steps on the synthetic token stream, with checkpointing and resume.

    PYTHONPATH=src python examples/train_lm_a2q_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_a2q_torch.py --steps 300 --scale 0.25 --device cpu

The twin of ``examples/train_lm_a2q.py`` (``launch/train.py`` pre-configured;
``--scale`` narrows the network, same depth and structure).  After
training, verifies the A2Q invariant over every layer: integer-weight l1
norms within the Eq. 15 budget for P=16.  The compressed data-parallel
gradient reduction is ``python -m repro_torch.launch.train
--grad-compress-bits 8``; ``python -m repro_torch.launch.dryrun`` records
its wire bytes per train cell.
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.a2q import a2q_int_weights
from repro_torch.core.bounds import l1_budget
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.models.steps import build_train_step
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train.trainer import Trainer


def scaled_smollm(scale: float):
    arch = get_arch("smollm-135m")
    if scale >= 1.0:
        return arch
    s = arch.stacks[0]
    heads = max(int(s.attn.heads * scale) // 3 * 3, 3)  # keep kv ratio 3:1
    a = dataclasses.replace(s.attn, heads=heads, kv_heads=heads // 3)
    return dataclasses.replace(
        arch,
        d_model=heads * s.attn.head_dim,
        vocab=max(int(arch.vocab * scale), 1024),
        stacks=(dataclasses.replace(s, attn=a, d_ff=max(int(s.d_ff * scale) // 8 * 8, 64)),),
    )


def a2q_worst_l1(params, q) -> tuple[float, int]:
    """The largest integer-weight column l1 over every A2Q layer of the
    tree, and the number of layers (a stacked leaf counts once)."""
    worst, n_layers = 0.0, 0

    def walk(node):
        nonlocal worst, n_layers
        if isinstance(node, dict):
            if "v" in node and "t" in node and node["v"].ndim >= 2:
                v, t, d = node["v"], node["t"], node["d"]
                lead = v.shape[:-2]
                vs, ts, ds = (x.reshape(-1, *x.shape[len(lead):]) for x in (v, t, d))
                for i in range(vs.shape[0]):
                    qi = a2q_int_weights({"v": vs[i], "t": ts[i], "d": ds[i]}, q.weight_bits,
                                         q.acc_bits, q.act_bits, True)[0]
                    worst = max(worst, float(qi.abs().sum(-2).max()))
                n_layers += 1
            else:
                for vv in node.values():
                    walk(vv)

    with torch.no_grad():
        walk(params)
    return worst, n_layers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "a2q_lm_ckpt_torch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = scaled_smollm(args.scale)
    n_params_est = arch.n_layers * (4 * arch.d_model**2 + 3 * arch.d_model * arch.stacks[0].d_ff)
    print(f"arch: {arch.name} x{args.scale} d={arch.d_model} L={arch.n_layers} "
          f"(~{(n_params_est + arch.vocab*arch.d_model)/1e6:.0f}M params), "
          f"A2Q P={arch.quant.acc_bits}")

    params = init_lm(torch.Generator(device=dev).manual_seed(0), arch, device=dev)
    opt = adamw(weight_decay=1e-5)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    sched = cosine_with_warmup(3e-4, warmup=args.steps // 10, total=args.steps)
    step_fn = build_train_step(arch, opt, Runtime(), lr_schedule=sched)
    stream = TokenStream(vocab=arch.vocab, seq_len=args.seq, global_batch=args.batch)

    trainer = Trainer(step_fn, stream.batch, ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20)
    state, start = trainer.maybe_restore(state)
    res = trainer.run(state, args.steps, start_step=start)
    print(f"loss: {res.history[0]['loss']:.3f} -> {res.history[-1]['loss']:.3f}")

    # verify the guarantee over the trained model
    q = arch.quant
    budget = l1_budget(q.acc_bits, q.act_bits, True)
    worst, n_layers = a2q_worst_l1(res.state["params"], q)
    ok = worst <= budget + 1e-6
    print(f"A2Q invariant over {n_layers} trained layers: worst |w|_1 = {worst:.2f} "
          f"<= budget {budget:.2f}: {'OK' if ok else 'VIOLATED'}")
    assert ok
    return res


if __name__ == "__main__":
    main()
