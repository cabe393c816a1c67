"""Quickstart on the PyTorch port: the A2Q guarantee in 40 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The twin of ``examples/quickstart.py``: one A2Q-quantized layer for a 12-bit
accumulator, deployed through the ``a2q_quantize`` kernel (on the CPU its
plain version), and the paper's core property: the integer weights satisfy
the Eq. 15 l1 budget, so a 12-bit accumulator provably never overflows:
wraparound, saturation, and ideal wide accumulation all agree, in every MAC
order.
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import QuantConfig
from repro_torch.core.bounds import l1_budget, min_accumulator_bits_data_type
from repro_torch.core.integer import accumulate_dot, mac_order_audit
from repro_torch.nn.linear import deploy_linear, init_linear

K, C_OUT, P = 512, 16, 12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    q = QuantConfig(mode="a2q", weight_bits=8, act_bits=8, acc_bits=P)

    params = init_linear(torch.Generator(device=dev).manual_seed(0), K, C_OUT, q,
                         input_signed=False)
    with torch.no_grad():
        deployed = deploy_linear(params, q, input_signed=False)
    w_int = deployed["q8"].cpu().numpy().astype(np.int64)  # (K, C_OUT) integer weights

    budget = l1_budget(P, q.act_bits, signed_input=False)
    l1 = np.abs(w_int).sum(0)
    print(f"target accumulator: {P} bits  (data-type bound would need "
          f"{min_accumulator_bits_data_type(K, 8, 8, False)} bits)")
    print(f"per-channel |w|_1: max {l1.max()}  budget {budget:.2f}  ->  "
          f"{'WITHIN BUDGET' if (l1 <= budget).all() else 'VIOLATION'}")
    print(f"weight sparsity from the l1 constraint: {(w_int == 0).mean():.1%}")

    # worst-case 8-bit unsigned inputs, every accumulator semantics, random orders
    x = np.random.default_rng(0).integers(0, 256, (64, K))
    exact = accumulate_dot(x, w_int, 64, "exact")
    wrap = accumulate_dot(x, w_int, P, "wrap")
    audit = mac_order_audit(x, w_int, P, n_orders=8)
    print(f"exact == {P}-bit wraparound: {bool((exact == wrap).all())}")
    print(f"order-invariant under {P}-bit saturation: {audit['order_invariant']}, "
          f"matches exact: {audit['matches_exact']}")
    return {"w_int": w_int, "exact": exact}


if __name__ == "__main__":
    main()
