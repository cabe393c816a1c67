"""Analytical FINN-style LUT cost model (paper Sec. 5.3, Fig. 6/7): the
port's own copy of ``repro.core.lut``, with the same constants and
arithmetic (pure Python, no tensors).

The paper evaluates HW-SW co-design by generating FINN streaming accelerators
and reading LUT utilization estimates.  No FPGA toolchain exists offline, so
this module reimplements the published FINN-R matrix-vector-activation-unit
(MVAU) cost relations as an analytical model.  It reproduces the *structure* of
the paper's resource accounting:

* **compute LUTs** — MAC cost grows with weight width M, input width N, and the
  accumulator width P (the adder chain and register are P bits wide),
* **weight-memory LUTs** — distributed LUTRAM storing M-bit weights,
* **threshold-memory LUTs** — FINN lowers quantized activations to threshold
  comparisons; storage grows with the number of thresholds ``2**N_out - 1``
  *and* their width, which is the accumulator width P (Sec. 5.3.1: "their
  resource utilization exponentially grows with the precision of the
  accumulator and output activations").

Constants are calibrated to FINN-R's published LUT-per-op figures; absolute
numbers are estimates, but the model preserves the orderings the paper's
Pareto analysis depends on (P ↓ ⇒ LUT ↓, monotone in M and N).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

__all__ = ["LayerGeometry", "mvau_luts", "model_luts"]

# Calibration constants (LUT6 counts), from FINN-R-style cost relations.
_LUT_PER_MAC_BITPRODUCT = 1.1  # multiplier LUTs ~ M*N bit-partial-products
_LUT_PER_ADDER_BIT = 0.65  # carry-chain adder + accumulator register
_LUTRAM_BITS = 64.0  # one LUT6 provides 64 bits of distributed RAM
_THRESHOLD_OVERHEAD = 1.0  # comparator tree per threshold bit


@dataclass(frozen=True)
class LayerGeometry:
    """One matmul/conv layer as FINN sees it: C_out accumulators of length K."""

    k: int  # dot-product length (C_in * kernel_h * kernel_w)
    c_out: int
    macs: int  # total MACs per inference (k * c_out * spatial positions)
    weight_bits: int  # M
    input_bits: int  # N (of this layer's input activations)
    output_bits: int  # N of the activation it feeds (threshold count driver)
    acc_bits: int  # P
    sparsity: float = 0.0  # fraction of zero integer weights (A2Q payoff)
    pe: int = 1  # processing elements (output parallelism)
    simd: int = 1  # SIMD lanes (input parallelism)


def mvau_luts(g: LayerGeometry, exploit_sparsity: bool = False) -> dict:
    """LUT estimate for one MVAU instantiation, split compute vs memory."""
    units = g.pe * g.simd
    mult = _LUT_PER_MAC_BITPRODUCT * g.weight_bits * g.input_bits
    adder = _LUT_PER_ADDER_BIT * g.acc_bits
    compute = units * (mult + adder)

    weight_bits_total = g.k * g.c_out * g.weight_bits
    if exploit_sparsity:
        # CSR-ish packing: values + small index overhead on surviving weights.
        density = max(1.0 - g.sparsity, 0.0)
        weight_bits_total = g.k * g.c_out * density * (g.weight_bits + 4)
    weight_mem = weight_bits_total / _LUTRAM_BITS

    n_thresholds = (2**g.output_bits - 1) if g.output_bits > 0 else 0
    thresh_bits = g.c_out * n_thresholds * g.acc_bits
    thresh_mem = thresh_bits / _LUTRAM_BITS + _THRESHOLD_OVERHEAD * n_thresholds * g.acc_bits / 8.0

    return {
        "compute": compute,
        "weight_mem": weight_mem,
        "threshold_mem": thresh_mem,
        "total": compute + weight_mem + thresh_mem,
    }


def model_luts(
    layers: Sequence[LayerGeometry],
    exploit_sparsity: bool = False,
) -> dict:
    """Aggregate the per-layer MVAU estimates for a whole QNN."""
    agg = {"compute": 0.0, "weight_mem": 0.0, "threshold_mem": 0.0, "total": 0.0}
    per_layer = []
    for g in layers:
        r = mvau_luts(g, exploit_sparsity=exploit_sparsity)
        per_layer.append(r)
        for k in agg:
            agg[k] += r[k]
    agg["per_layer"] = per_layer
    return agg
