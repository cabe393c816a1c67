"""Serving launcher: the paged or the contiguous engine on random A2Q weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --paged --int-chain --kv-int8 [--kv-bits 4] --decode-kernel \\
        --requests 8 --prompt-len 64 --max-new 32 --batch 8 [--reduced] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --paged --int-chain --decode-steps 8 [--eos-id N] --requests 8 \\
        --prompt-len 64 --max-new 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --paged --deploy-int8 --parity-check [--eos-auto] --device cpu

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
token halfway through its budget).  ``--parity-check`` serves the same
prompts on both engines — the contiguous one on the float path (dequant
matmuls, float cache; recurrent stacks in lockstep groups of ``--batch``),
the paged one as asked, greedy and with the decode kernel off — and fails
unless their greedy tokens agree: exactly on float KV, under
``parity_up_to_ties`` at ``--parity-eps`` (0.05) on integer KV.  An
attention-free model (rwkv6) keeps a recurrent state per slot instead of
KV, and sliding-window layers a ring a slot; their bytes a slot are
printed beside the KV bytes a token.  ``--device`` defaults to ``cuda``.
Throughput is reported split into prefill and decode.  The reference's
other flags are refused as not ported yet (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.serve.engine import (
    PagedServeEngine,
    ServeEngine,
    deploy_params,
    parity_up_to_ties,
)

NOT_PORTED = (
    "--prefix-share", "--shared-prefix", "--pin-prompt", "--spec-k", "--spec-draft",
    "--sample", "--temperature", "--top-k", "--trace", "--metrics-json",
)


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
    ap.add_argument("--parity-check", action="store_true",
                    help="run paged AND contiguous engines; fail on any token mismatch")
    ap.add_argument("--parity-eps", type=float, default=None,
                    help="greedy-margin tie tolerance for --parity-check with --kv-int8 "
                         "(default 0.05; float KV always compares exactly)")
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
    given = list(sys.argv[1:] if argv is None else argv)
    for flag in NOT_PORTED:
        if any(a == flag or a.startswith(flag + "=") for a in given):
            ap.error(f"{flag} is not ported yet (ROADMAP.md queue 1)")
    args = ap.parse_args(given)
    if not args.paged and not args.parity_check:
        wanted = [flag for flag, on in (
            ("--decode-kernel", args.decode_kernel), ("--kv-int8", args.kv_int8),
            ("--num-blocks", args.num_blocks is not None),
            ("--decode-steps", args.decode_steps != 1)) if on]
        if wanted:
            ap.error(f"{', '.join(wanted)} only affect the paged engine; add --paged")
    if args.eos_auto and args.eos_id is not None:
        ap.error("--eos-auto derives the EOS id; drop --eos-id")
    if args.decode_steps < 1:
        ap.error(f"--decode-steps must be >= 1, got {args.decode_steps}")
    if args.kv_bits != 8 and not args.kv_int8:
        ap.error("--kv-bits only affects integer KV blocks; add --kv-int8")

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
    prompts = [rng.integers(0, arch.vocab, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]
    decode_kernel = args.decode_kernel
    if args.parity_check and decode_kernel:
        # the contiguous baseline is greedy on the gathered-view arithmetic;
        # the paged side compares on the same
        print("parity-check forces greedy sampling on the gathered-view decode path")
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

    def paged_engine():
        return PagedServeEngine(
            arch, params, batch=args.batch, max_seq=args.max_seq, block_size=args.block_size,
            prefill_chunk=args.prefill_chunk, num_blocks=args.num_blocks, device=args.device,
            kv_quant=args.kv_int8, kv_bits=args.kv_bits, eos_id=args.eos_id,
            decode_steps=args.decode_steps,
            rt=Runtime(decode_kernel=decode_kernel, int_forward=args.int_forward,
                       int_chain=args.int_chain),
        )

    report = {"arch": args.arch, "paged": bool(args.paged or args.parity_check),
              "int_forward": args.int_forward, "int_chain": args.int_chain,
              "kv_int8": args.kv_int8, "kv_bits": args.kv_bits if args.kv_int8 else None,
              "decode_kernel": decode_kernel, "device": args.device,
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
                             eos_id=args.eos_id, device=args.device)
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
    if args.eos_id is not None:
        report["eos_terminated"] = sum(1 for o in outs if o and o[-1] == args.eos_id)
        print(f"eos: {report['eos_terminated']} of {len(outs)} requests terminated on "
              f"eos_id={args.eos_id}")
    for i, o in enumerate(outs):
        print(f"req {i}: {o}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    return {"outs": outs, "report": report, "engines": engines}


if __name__ == "__main__":
    main()
