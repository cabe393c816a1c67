"""A2Q training of the paper's vision networks at full width on one CUDA
card: from each network's own A2Q init, against from a float model
(``requantize_from_float``, the paper's App. B protocol), to show which
start learns in ``chip_smoke.py`` phase 4i's 20 steps.

    python3 tools/vision_from_init.py

MobileNetV1 and ResNet18 (width 1.0) on ``ImageClassStream(global_batch=64,
seed=0)``: A2Q (M=N=6, P=16) from init with adamw at 5e-3, 2e-2 and 5e-2
and sgdm (momentum 0.9) at 1e-2, then 20 float adamw steps at 5e-3
requantized into A2Q and trained 20 A2Q adamw steps at 5e-3.  Prints each
run's first and last-5 mean training loss and its accuracy on the held-out
batch (step 10,000); then ESPCN's share of nonzero outputs on a held-out
``SuperResStream`` batch from its A2Q init.  Needs a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("vision_from_init: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.configs.base import QuantConfig
    from repro_torch.data.synthetic import ImageClassStream, SuperResStream
    from repro_torch.models import vision
    from repro_torch.optim.optimizers import adamw, sgdm

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    q = QuantConfig(mode="a2q", weight_bits=6, act_bits=6, acc_bits=16)
    qf = QuantConfig(mode="none")
    stream = ImageClassStream(global_batch=64, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in stream.batch(i).items()}
               for i in range(2 * STEPS)]
    held = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(10_000).items()}

    def train(model, cfg, params, opt, lr, steps):
        state = opt.init(params)
        step = vision.build_vision_train_step(model, cfg, opt, lr)
        losses = []
        for batch in steps:
            params, state, loss = step(params, state, batch)
            losses.append(loss)
        return params, torch.stack(losses).cpu().numpy()

    def report(model, tag, params, cfg, losses):
        with torch.no_grad():
            logits = vision.VISION_MODELS[model][1](params, held["x"], cfg)
        acc = (logits.argmax(-1) == held["y"]).float().mean().item()
        print(f"{model} {tag}: loss first {losses[0]:.4f} last-5 mean {losses[-5:].mean():.4f}; "
              f"held-out accuracy {acc:.3f}", flush=True)

    for model in ("mobilenetv1", "resnet18"):
        init = vision.VISION_MODELS[model][0]
        for name, make, lr in (("adamw", adamw, 5e-3), ("adamw", adamw, 2e-2),
                               ("adamw", adamw, 5e-2), ("sgdm", lambda: sgdm(momentum=0.9), 1e-2)):
            p = init(torch.Generator(device=dev).manual_seed(0), q, device=dev)
            p, losses = train(model, q, p, make(), lr, batches[:STEPS])
            report(model, f"A2Q from init, {name} lr {lr}", p, q, losses)
        gen = torch.Generator(device=dev).manual_seed(0)
        flt, f_losses = train(model, qf, init(gen, qf, device=dev), adamw(), 5e-3,
                              batches[:STEPS])
        report(model, "float, adamw lr 0.005", flt, qf, f_losses)
        p = vision.requantize_from_float(init(gen, q, device=dev), flt, q)
        p, losses = train(model, q, p, adamw(), 5e-3, batches[STEPS:])
        report(model, "A2Q from the float model, adamw lr 0.005", p, q, losses)

    sr = SuperResStream(global_batch=16, hr=48, seed=0).batch(10_000)
    p = vision.init_espcn(torch.Generator(device=dev).manual_seed(0), q, device=dev)
    with torch.no_grad():
        y = vision.apply_espcn(p, torch.as_tensor(sr["lr"], device=dev), q)
    print(f"espcn A2Q init: nonzero outputs {(y != 0).float().mean().item():.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
