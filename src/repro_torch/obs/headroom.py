"""Accumulator-headroom telemetry: the paper's overflow guarantee as a
runtime observable (port of ``repro.obs.headroom``).

A2Q proves overflow avoidance *statically* — the deployed integer weights'
per-channel l1 norms fit the Eq. 15 budget for the target accumulator width
``P``.  This module turns that proof into gauges:

* :func:`static_headroom_report` — walks a deployed param tree (``q8``/``s8``
  leaves from ``serve.engine.deploy_params``) and computes each layer's
  worst-case bound utilization ``||q8||_1 * 2**(N - 1_signed) / (2**(P-1)-1)``
  (``core.bounds.headroom_utilization``, the ratio form of Eq. 11).
  Utilization < 1.0 on every layer *is* the guarantee.
* :func:`observed_headroom` — runs one eager forward through the fused W8A8
  path inside ``nn.linear.acc_probe_scope`` and samples the actual integer
  operands' worst partial-sum magnitude ``max(|x_codes| @ |q8|)`` per call —
  at most the static bound when the guarantee holds, so ``observed >
  bound`` is a hard violation.
* :func:`engine_headroom` — fills an engine's metrics registry
  (``acc_headroom_utilization{site=...}``, ``acc_observed_max{site=...}``,
  ``acc_bound{site=...}``, ``acc_headroom_util_max``,
  ``acc_observed_frac_max``, ``acc_headroom_violations``) and returns a
  summary dict.

Where the probe records differs from the reference.  The reference's layer
stacks run under ``lax.scan``, whose body traces abstract operands, so its
eager probe records only the sites outside a stack (the untied ``head``).
The port's stacks are a Python loop, so every deployed call of the forward
records, one record a layer a site (the site names are the chain report's:
``attn.wq`` for every layer's query projection).  Each record the reference
yields has an equal one in the port's list; the port's list is longer.  The
``acc_observed_max`` / ``acc_bound`` gauges of a site name hold the largest
of its records.  The static report covers every deployed layer in both
(stacked leaves reduce per-channel l1 over all stack members).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.bounds import headroom_utilization, l1_budget

__all__ = ["static_headroom_report", "observed_headroom", "engine_headroom"]


def _deployed_signed(path: tuple) -> bool:
    # as serve.engine.deploy_params decides it: rwkv6's channel-mix wv takes
    # unsigned (post-relu^2) activations; everything else is signed
    return not (len(path) >= 2 and path[-2] == "cm" and path[-1] == "wv")


def static_headroom_report(params: dict, quant) -> list:
    """Per-layer worst-case accumulator utilization for a deployed tree.

    One record per ``q8`` leaf (stacked leaves collapse to their worst
    channel across all stack members)::

        {"site", "utilization", "l1_max", "l1_budget", "acc_bits",
         "in_bits", "in_signed"}
    """
    P = quant.acc_bits if quant.mode == "a2q" else 32
    N = quant.act_bits
    out: list = []

    def walk(node, path=()):
        if not isinstance(node, dict):
            return
        if "q8" in node and "s8" in node:
            signed = _deployed_signed(path)
            # weights are (..., K, C): channels (accumulators) on the last
            # axis, so per-channel l1 reduces the K axis
            l1 = node["q8"].to(torch.int64).abs().sum(dim=-2)
            l1_max = float(l1.max()) if l1.numel() else 0.0
            out.append({
                "site": ".".join(path),
                "utilization": float(headroom_utilization(l1_max, N, signed, P)),
                "l1_max": l1_max,
                "l1_budget": l1_budget(P, N, signed),
                "acc_bits": P,
                "in_bits": N,
                "in_signed": signed,
            })
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(params)
    return out


def _device(params: dict) -> torch.device:
    node = params
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


def observed_headroom(
    arch,
    params: dict,
    *,
    rt=None,
    tokens: Optional[np.ndarray] = None,
    batch: int = 1,
    seq: int = 8,
    seed: int = 0,
) -> list:
    """Sample observed accumulator magnitudes from one eager forward of
    ``tokens (batch, seq)`` (drawn from a ``torch.Generator`` seeded by
    ``seed`` on the params' device when not given).

    Returns the probe records of :func:`nn.linear.acc_probe_scope` — empty
    when ``rt.int_forward`` is off (the fused path never runs)."""
    from repro_torch.models.lm import apply_lm
    from repro_torch.nn.linear import acc_probe_scope

    dev = _device(params)
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(0, arch.vocab, (batch, seq), generator=gen, device=dev,
                             dtype=torch.int32)
    else:
        toks = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)
    samples: list = []
    with acc_probe_scope(samples):
        apply_lm(params, arch, tokens=toks, rt=rt)
    return samples


def engine_headroom(engine, *, seq: int = 8, seed: int = 0) -> dict:
    """Fill an engine's metrics registry with the headroom gauges.

    Static gauges cover every deployed layer; observed gauges every fused
    call of one eager forward of ``seq`` tokens.  ``acc_headroom_violations``
    counts static utilizations > 1.0 plus observed samples above their bound
    — zero whenever the A2Q constraint held at deployment.

    ``seq`` is rounded up to whole chunks of every recurrent stack, whose
    cacheless forward takes the chunked form (64 tokens for rwkv6-7b and
    hymba-1.5b).  The rounding is the port's own: the reference probes
    ``seq`` tokens as given, and its chunked forms refuse them."""
    for s in engine.arch.stacks:
        if s.ssm is not None:
            seq = -(-seq // s.ssm.chunk) * s.ssm.chunk
    m = engine.obs.metrics
    static = static_headroom_report(engine.params, engine.arch.quant)
    observed = observed_headroom(engine.arch, engine.params, rt=engine.rt, seq=seq, seed=seed)
    violations = 0
    util_max = 0.0
    for rec in static:
        m.gauge("acc_headroom_utilization", {"site": rec["site"]}).set(rec["utilization"])
        util_max = max(util_max, rec["utilization"])
        if rec["utilization"] > 1.0:
            violations += 1
    obs_max = 0.0
    site_max: dict = {}
    for rec in observed:
        site = rec["site"] or "<unlabeled>"
        acc, bound = site_max.get(site, (0, rec["bound"]))
        site_max[site] = (max(acc, rec["acc_max"]), bound)
        if rec["bound"] > 0:
            obs_max = max(obs_max, rec["acc_max"] / rec["bound"])
        if rec["acc_max"] > rec["bound"]:
            violations += 1
    for site, (acc, bound) in site_max.items():
        m.gauge("acc_observed_max", {"site": site}).set(acc)
        m.gauge("acc_bound", {"site": site}).set(bound)
    m.gauge("acc_headroom_util_max").set(util_max)
    m.gauge("acc_observed_frac_max").set(obs_max)
    m.counter("acc_headroom_violations").set(violations)
    return {
        "layers": len(static),
        "observed_sites": len(observed),
        "util_max": util_max,
        "observed_frac_max": obs_max,
        "violations": violations,
    }
