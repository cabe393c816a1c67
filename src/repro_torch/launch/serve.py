"""Serving launcher: the paged or the contiguous engine on random A2Q weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --paged --int-chain --kv-int8 [--kv-bits 4] --decode-kernel \\
        --requests 8 --prompt-len 64 --max-new 32 --batch 8 [--reduced] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --paged --int-chain --decode-steps 8 [--eos-id N] --requests 8 \\
        --prompt-len 64 --max-new 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --paged --deploy-int8 --parity-check [--eos-auto] --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --paged --int-forward --prefix-share --shared-prefix 64 [--pin-prompt 32] \\
        [--spec-k 4 [--spec-draft self-int8|<config>]] --requests 8 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --paged --int-chain --decode-kernel --decode-steps 8 --sample topk \
        --temperature 0.8 --top-k 40 --trace trace.json --metrics-json metrics.json

Port of ``repro.launch.serve``: ``--paged`` serves through
``PagedServeEngine``, otherwise through the contiguous ``ServeEngine`` (which
honors ``--int-forward``/``--int-chain`` too).  ``--deploy-int8`` swaps the
A2Q params for int8 weights + scales, ``--int-forward`` (implies it) runs
the deployed linears through the fused W8A8 kernel, ``--int-chain``
(implies ``--int-forward``) folds their act-quant into the kernel's
prologue, ``--kv-int8`` keeps the paged KV as int8 codes with per-slot
scales (``--kv-bits 4``: two codes a byte), ``--decode-kernel`` reads the
paged KV pools through the paged-attention kernel, ``--decode-steps N``
fuses N decode ticks into one window (the megastep; one CUDA-graph replay
on the card), ``--eos-id`` ends a request the step it emits that token and
``--eos-auto`` takes that id from a greedy contiguous probe (request 0's
token halfway through its budget).  ``--prefix-share`` dedups common prompt
prefixes through the radix prompt cache (refcounted copy-on-write blocks,
LRU/cost eviction); ``--shared-prefix N`` prepends an N-token common prefix
to every request, and ``--pin-prompt N`` prefills an N-token system
preamble once before traffic and pins it (never evicted; prepended ahead
of the shared prefix; needs ``--prefix-share``).  ``--spec-k K`` serves
through ``SpecServeEngine``: K tokens drafted a round by ``--spec-draft``
(``self-int8``, the same weights on the integer path, or a config name for a
separate draft model, e.g. ``smollm-135m``, its weights from ``--seed`` + 1)
and verified in one call, greedy output token-identical to plain decode;
an arch with ring or recurrent state serves plain.  ``--parity-check`` serves the same
prompts on both engines — the contiguous one on the float path (dequant
matmuls, float cache; recurrent stacks in lockstep groups of ``--batch``),
the paged one as asked, greedy and with the decode kernel off — and fails
unless their greedy tokens agree: exactly on float KV, under
``parity_up_to_ties`` at ``--parity-eps`` (0.05) on integer KV.  An
attention-free model (rwkv6) keeps a recurrent state per slot instead of
KV, sliding-window and chunk-local layers a ring a slot, hymba both; their
bytes a slot are printed beside the KV bytes a token.  ``--sample temperature|topk``
(``--temperature``, ``--top-k``; paged engine only, not with ``--spec-k``)
samples on the device from a generator seeded by ``--seed``;
``--parity-check`` forces greedy.  ``--trace PATH`` records the engine's
request spans and writes them as Chrome trace-event JSON (Perfetto);
``--metrics-json PATH`` writes the engine's metrics snapshot (stats, cache
counters, chain report, CUDA-graph captures, latency histograms, and the
headroom gauges).  Every ``--int-forward`` run prints the accumulator
headroom: each deployed layer's worst-case utilization of its P-bit
accumulator (A2Q's static bound) and the largest partial sum one probed
eager forward reaches against it, with the violations (0 when the
guarantee holds).  ``--device`` defaults to ``cuda``.  Throughput is
reported split into prefill and decode.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.obs import Obs
from repro_torch.obs.headroom import engine_headroom
from repro_torch.serve.engine import (
    PagedServeEngine,
    ServeEngine,
    deploy_params,
    parity_up_to_ties,
)
from repro_torch.serve.sampling import SampleConfig
from repro_torch.serve.spec import ModelDrafter, SpecServeEngine


def _spec_report(engine) -> dict:
    """Speculative-decoding stats block (``active`` False: plain fallback)."""
    out = {
        "active": engine.spec_active() or engine.spec_stats["rounds"] > 0,
        "supported": engine.spec_supported,
        "k": engine.spec_k,
        "acceptance_rate": engine.acceptance_rate(),
        **engine.spec_stats,
    }
    tag = "speculative" if out["supported"] else "speculative UNSUPPORTED (plain fallback)"
    print(f"[{tag}] k={out['k']} rounds={out['rounds']} "
          f"acceptance={out['acceptance_rate']:.2f} bonus={out['bonus']} "
          f"fallback_rounds={out['fallback_rounds']}")
    return out


def _report(tag: str, engine) -> dict:
    tp = engine.throughput()
    print(
        f"[{tag}] prefill: {tp['prefill_tokens']} tok in {tp['prefill_s']:.2f}s "
        f"({tp['prefill_tok_s']:.1f} tok/s) | decode: {tp['decode_tokens']} tok in "
        f"{tp['decode_s']:.2f}s ({tp['decode_tok_s']:.1f} tok/s, "
        f"{tp['decode_dispatches']} dispatches = "
        f"{tp['dispatches_per_token']:.3f}/tok) | overall {tp['tok_s']:.1f} tok/s"
    )
    if "int_chain_requant_dispatches" in tp:
        print(f"[{tag}] chain report (calls of the last forward): {tp['int_chain_folded']} "
              f"folded, {tp['int_chain_chained']} chained, "
              f"{tp['int_chain_requant_dispatches']} standalone act-quant, "
              f"{tp['int_chain_fallback']} fallback")
    return tp


def main(argv=None):
    """Serve as the flags ask; returns each request's generated tokens."""
    return run(argv)["outs"]


def run(argv=None) -> dict:
    """``main``'s run, returning its generated tokens (``outs``), its report
    and the engines it served on (``engines``: ``"paged"`` and/or
    ``"contiguous"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--paged", action="store_true", help="serve via PagedServeEngine")
    ap.add_argument("--deploy-int8", action="store_true")
    ap.add_argument("--int-forward", action="store_true",
                    help="fused W8A8 integer matmuls for deployed layers (implies --deploy-int8)")
    ap.add_argument("--int-chain", action="store_true",
                    help="fold activation quantization into the W8A8 kernel's prologue, so "
                         "deployed layers pay no standalone act-quant (implies --int-forward)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="integer paged KV blocks with per-slot scales")
    ap.add_argument("--kv-bits", type=int, choices=(8, 4), default=8,
                    help="KV code width with --kv-int8 (4 packs two codes per byte)")
    ap.add_argument("--decode-kernel", action="store_true",
                    help="route paged decode through the paged-attention kernel")
    ap.add_argument("--decode-steps", type=int, default=1,
                    help="paged decode ticks fused per window (the megastep, one CUDA-graph "
                         "replay on the card; 1 = per-tick decode)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="end-of-sequence token id: requests finish the step they emit it "
                         "instead of decoding to --max-new")
    ap.add_argument("--eos-auto", action="store_true",
                    help="probe a greedy contiguous run and use the token request 0 emits "
                         "halfway through its budget as the EOS id")
    ap.add_argument("--prefix-share", action="store_true",
                    help="dedup common prompt prefixes via the radix prompt cache")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend an N-token common prefix to every request")
    ap.add_argument("--pin-prompt", type=int, default=0,
                    help="prefill an N-token system preamble once and pin it in the prompt "
                         "cache (prepended to every request; requires --prefix-share)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens per round (0 = off)")
    ap.add_argument("--spec-draft", default="self-int8",
                    help="drafter: 'self-int8' (same weights, integer fast path) or a config "
                         "name for a small draft model")
    ap.add_argument("--sample", choices=("greedy", "temperature", "topk"), default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--parity-check", action="store_true",
                    help="run paged AND contiguous engines; fail on any token mismatch")
    ap.add_argument("--parity-eps", type=float, default=None,
                    help="greedy-margin tie tolerance for --parity-check with --kv-int8 "
                         "(default 0.05; float KV always compares exactly)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record request-span traces and write Chrome trace-event JSON here "
                         "(load in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics snapshot (engine + cache + chain + headroom) here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16, help="paged KV tokens per block")
    ap.add_argument("--prefill-chunk", type=int, default=32, help="prompt tokens per prefill call")
    ap.add_argument("--num-blocks", type=int, default=None, help="paged KV pool size (blocks)")
    ap.add_argument("--json", default=None, help="write the stats report to this path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not args.paged and not args.parity_check:
        wanted = [flag for flag, on in (
            ("--sample", args.sample != "greedy"), ("--top-k", args.top_k != 0),
            ("--decode-kernel", args.decode_kernel), ("--kv-int8", args.kv_int8),
            ("--num-blocks", args.num_blocks is not None),
            ("--spec-k", args.spec_k > 0), ("--prefix-share", args.prefix_share),
            ("--shared-prefix", args.shared_prefix > 0), ("--pin-prompt", args.pin_prompt > 0),
            ("--decode-steps", args.decode_steps != 1)) if on]
        if wanted:
            ap.error(f"{', '.join(wanted)} only affect the paged engine; add --paged")
    if args.eos_auto and args.eos_id is not None:
        ap.error("--eos-auto derives the EOS id; drop --eos-id")
    if args.decode_steps < 1:
        ap.error(f"--decode-steps must be >= 1, got {args.decode_steps}")
    if args.pin_prompt > 0 and not args.prefix_share:
        ap.error("--pin-prompt pins into the prompt cache; add --prefix-share")
    if args.kv_bits != 8 and not args.kv_int8:
        ap.error("--kv-bits only affects integer KV blocks; add --kv-int8")
    if args.spec_draft != "self-int8" and args.spec_k == 0:
        ap.error("--spec-draft only affects speculative decoding; add --spec-k")
    if args.spec_k > 0 and args.sample != "greedy":
        ap.error("--spec-k is lossless for greedy decoding only")

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_lm(gen, arch, device=args.device)
    if args.int_chain:
        args.int_forward = True  # chaining is a mode of the integer fast path
    if args.int_forward:
        args.deploy_int8 = True  # the W8A8 path consumes the deployed artifact
    if args.deploy_int8:
        params = deploy_params(params, arch.quant)
        print("serving deployed int8 weights (A2Q-guaranteed accumulator safety)")
    if args.int_chain:
        print("int-chain: activation quantization folded into the W8A8 kernel's prologue")
    elif args.int_forward:
        print("int-forward: deployed linears run the fused W8A8 integer kernel")

    rng = np.random.default_rng(args.seed)
    # common material goes ahead of each request's prompt_len tail: a pinned
    # preamble first (prefilled once, never evicted), then a shared prefix
    # (cached from the first request that donates it)
    preamble = (rng.integers(0, arch.vocab, (args.pin_prompt,)).astype(np.int32)
                if args.pin_prompt > 0 else None)
    common = (rng.integers(0, arch.vocab, (args.shared_prefix,)).astype(np.int32)
              if args.shared_prefix > 0 else None)
    head = [p for p in (preamble, common) if p is not None]
    prompts = [np.concatenate(head + [rng.integers(0, arch.vocab, (args.prompt_len,))
                                      .astype(np.int32)])
               if head else rng.integers(0, arch.vocab, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]
    sample = SampleConfig(method=args.sample, temperature=args.temperature, top_k=args.top_k)
    decode_kernel = args.decode_kernel
    if args.parity_check and (args.sample != "greedy" or decode_kernel):
        # the contiguous baseline is greedy on the gathered-view arithmetic;
        # the paged side compares on the same
        print("parity-check forces greedy sampling on the gathered-view decode path")
        sample = SampleConfig()
        decode_kernel = False
    if args.eos_auto:
        # a greedy contiguous probe: the token request 0 emits halfway through
        # its budget becomes the EOS id, so at least that request ends early
        # in every engine under test
        probe = ServeEngine(arch, params, batch=args.batch, max_seq=args.max_seq,
                            device=args.device)
        ptoks = probe.generate(prompts[:1], max_new=args.max_new)[0]
        args.eos_id = int(ptoks[len(ptoks) // 2])
        print(f"eos-auto: eos_id={args.eos_id} (request 0's token at step {len(ptoks) // 2})")

    obs = Obs(trace=bool(args.trace))

    def paged_engine():
        kw = dict(
            batch=args.batch, max_seq=args.max_seq, block_size=args.block_size,
            prefill_chunk=args.prefill_chunk, num_blocks=args.num_blocks, device=args.device,
            kv_quant=args.kv_int8, kv_bits=args.kv_bits, eos_id=args.eos_id,
            decode_steps=args.decode_steps, prefix_share=args.prefix_share, sample=sample,
            seed=args.seed, obs=obs,
            rt=Runtime(decode_kernel=decode_kernel, int_forward=args.int_forward,
                       int_chain=args.int_chain),
        )
        if args.spec_k > 0:
            drafter = None
            if args.spec_draft != "self-int8":
                darch = get_arch(args.spec_draft)
                if args.reduced:
                    darch = reduced(darch)
                if darch.vocab != arch.vocab:
                    raise SystemExit(f"draft config {args.spec_draft} vocab {darch.vocab} != "
                                     f"target vocab {arch.vocab}")
                dparams = init_lm(torch.Generator().manual_seed(args.seed + 1), darch,
                                  device=args.device)
                drafter = ModelDrafter(darch, dparams, slots=args.batch, max_seq=args.max_seq,
                                       spec_k=args.spec_k, block_size=args.block_size,
                                       prefill_chunk=args.prefill_chunk, device=args.device)
            e = SpecServeEngine(arch, params, spec_k=args.spec_k, drafter=drafter, **kw)
        else:
            e = PagedServeEngine(arch, params, **kw)
        if preamble is not None:
            pinned = e.pin_prompt(preamble)
            print(f"pinned system preamble: {pinned} of {len(preamble)} tokens "
                  f"({pinned // e.cache.block_size} blocks, never evicted)")
        return e

    report = {"arch": args.arch, "paged": bool(args.paged or args.parity_check),
              "int_forward": args.int_forward, "int_chain": args.int_chain,
              "kv_int8": args.kv_int8, "kv_bits": args.kv_bits if args.kv_int8 else None,
              "decode_kernel": decode_kernel, "device": args.device,
              "spec_k": args.spec_k, "prefix_share": args.prefix_share,
              "shared_prefix": args.shared_prefix, "pin_prompt": args.pin_prompt,
              "decode_steps": args.decode_steps, "eos_id": args.eos_id}
    if args.parity_check:
        # the baseline stays on the float path: dequant matmuls (the default
        # Runtime) over the float contiguous cache, so parity with
        # --int-forward / --kv-int8 gates the whole integer path against it
        contig = ServeEngine(arch, params, batch=args.batch, max_seq=args.max_seq,
                             eos_id=args.eos_id, device=args.device)
        reqs_c: list = []
        if contig.recurrent:  # one lockstep group of at most --batch prompts at a time
            outs_c = []
            for lo in range(0, len(prompts), args.batch):
                outs_c += contig.generate(prompts[lo:lo + args.batch], max_new=args.max_new)
                reqs_c += contig.last_requests
        else:
            outs_c = contig.generate(prompts, max_new=args.max_new)
            reqs_c = contig.last_requests
        engine = paged_engine()
        engines = {"contiguous": contig, "paged": engine}
        outs = engine.generate(prompts, max_new=args.max_new)
        report["contiguous"] = _report("contiguous", contig)
        report["paged_engine"] = _report("paged", engine)
        if args.kv_int8:
            # integer KV is lossy: token parity holds up to quantization ties
            eps = 0.05 if args.parity_eps is None else args.parity_eps
            ok, ties, detail = parity_up_to_ties(reqs_c, outs, eps)
            report["parity_eps"] = eps
            report["parity_sub_margin_ties"] = ties
            if not ok:
                raise SystemExit(f"parity FAILED (integer KV, eps={eps}): {detail}")
            print(f"parity OK (integer KV): {len(outs)} requests token-identical up to {ties} "
                  f"sub-margin ties (eps={eps})")
        else:
            if outs_c != outs:
                raise SystemExit(f"parity FAILED: contiguous {outs_c} != paged {outs}")
            print(f"parity OK: {len(outs)} requests token-identical across engines")
        if report["paged_engine"]["decode_tok_s"] <= 0:
            raise SystemExit("parity-check measured no paged decode throughput")
    elif args.paged:
        engine = paged_engine()
        engines = {"paged": engine}
        outs = engine.generate(prompts, max_new=args.max_new)
        report["paged_engine"] = _report("paged", engine)
    else:
        # the contiguous engine honors --int-forward / --int-chain as well
        engine = ServeEngine(arch, params, batch=args.batch, max_seq=args.max_seq,
                             rt=Runtime(int_forward=args.int_forward, int_chain=args.int_chain),
                             eos_id=args.eos_id, device=args.device, obs=obs)
        engines = {"contiguous": engine}
        outs = engine.generate(prompts, max_new=args.max_new)
        report["contiguous"] = _report("contiguous", engine)
    if report["paged"]:
        cache = engine.cache
        print(f"paged KV: peak {cache.peak_blocks} blocks "
              f"({cache.peak_blocks * cache.block_size} tokens) of {cache.num_blocks - 1} "
              f"(block_size={cache.block_size}); {cache.kv_bytes_per_token()} KV bytes/token; "
              f"{cache.state_bytes_per_slot()} recurrent state bytes a slot (rings included)")
        report["paged_peak_blocks"] = cache.peak_blocks
        report["kv_bytes_per_token"] = cache.kv_bytes_per_token()
        report["state_bytes_per_slot"] = cache.state_bytes_per_slot()
        if args.prefix_share:
            print(f"prefix sharing: {cache.prefix_hits} hits, {cache.prefix_hit_tokens} prompt "
                  f"tokens served from shared blocks, {cache.cow_copies} CoW copies")
            report.update({k: cache.counters()[k]
                           for k in ("prefix_hits", "prefix_hit_tokens", "cow_copies")})
        if args.spec_k > 0:
            report["spec"] = _spec_report(engine)
    if args.eos_id is not None:
        report["eos_terminated"] = sum(1 for o in outs if o and o[-1] == args.eos_id)
        print(f"eos: {report['eos_terminated']} of {len(outs)} requests terminated on "
              f"eos_id={args.eos_id}")
    if args.int_forward:
        # accumulator headroom: each deployed layer's static utilization (the
        # paper's Eq. 11 ratio) and the partial sums one probed eager
        # forward reaches
        hr = engine_headroom(engine)
        report["headroom"] = hr
        print(f"acc headroom: {hr['layers']} deployed layers, max static utilization "
              f"{hr['util_max']:.4f}, max observed |acc|/bound {hr['observed_frac_max']:.4f} "
              f"over {hr['observed_sites']} probed calls, {hr['violations']} violations")
    for i, o in enumerate(outs):
        print(f"req {i}: {o}")
    if args.trace:
        engine.obs.trace.export(args.trace)
        print(f"wrote trace ({len(engine.obs.trace.events)} events) to {args.trace}")
    if args.metrics_json:
        snap = engine.metrics_snapshot()
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        print(f"wrote {len(snap)} metrics to {args.metrics_json}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return {"outs": outs, "report": report, "engines": engines}


if __name__ == "__main__":
    main()
