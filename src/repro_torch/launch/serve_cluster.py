"""Disaggregated serving-cluster launcher: router + N engine replicas.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --arch yi-6b \\
        [--reduced] [--device cpu] [--replicas 2 | --disagg P:D] \\
        [--policy least-loaded|weighted-latency] [--transport inproc|subproc] \\
        [--fault-rate 0.25] [--requests 8 --prompt-len 12 --long-every 4 --max-new 8] \\
        [--kv-int8 [--kv-bits 4]] [--int-forward] [--prefix-share] \\
        [--decode-steps 8] [--spec-k 4] [--parity-check] [--json PATH]

Port of ``repro.launch.serve_cluster``, with the same flags, report keys and
printed lines, plus ``--device`` (default ``cuda``).  Builds a fleet of
``PagedServeEngine`` replicas behind the cluster ``Router``
(``serve/cluster/``) and drives a skewed, bursty arrival wave through it:
every request submitted up front, most prompts short and every
``--long-every``-th one 3x long.  ``--disagg P:D`` splits the fleet into
prefill-role and decode-role replicas; prompts run on a prefill replica,
whose finished KV blocks migrate to a decode replica over the paged-pool
wire format (no prompt recompute).

The in-process fleet (``--transport inproc``) shares one raw param tree,
drawn from a CPU generator seeded with ``--seed`` (as ``launch/serve.py``
draws it); each replica deploys its own copy.  Spawned replicas
(``--transport subproc``) draw the same tree in their own process; on a
CUDA device the kernels are built here first, so the children load them
instead of each compiling them again.  The wave starts once every child
has said hello (``await_fleet``), so it spreads over the whole fleet and
not over the first child up.

``--fault-rate R`` kills ``floor(R * replicas)`` replicas (at least one if
R > 0; never the last one) once a quarter of the wave has completed, then
asserts every request still finishes through the router's requeue path.

``--parity-check`` runs a single engine with the identical flags on the same
workload and fails unless the routed cluster's greedy output is
token-identical (up to quantization ties at ``--parity-eps`` with
``--kv-int8``): routing, failover and KV migration must be invisible in the
token stream.

Aggregate throughput is reported as **capacity**: total tokens produced by
the fleet over the *busiest replica's* engine-measured busy time
(prefill_s + decode_s), the makespan of a deployment where each replica owns
its hardware.  On one host (or one card) the replicas interleave, so this
measures routing balance, not wall-clock scaling.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from repro_torch.configs import get_arch, reduced


def build_workload(rng, requests: int, prompt_len: int, long_every: int, vocab: int):
    """Skewed burst: short prompts with every ``long_every``-th 3x long."""
    prompts = []
    for i in range(requests):
        n = prompt_len * 3 if long_every and (i % long_every == long_every - 1) else prompt_len
        # jitter short lengths so the wave isn't one lockstep shape
        n = max(2, n + int(rng.integers(-2, 3)))
        prompts.append(rng.integers(1, vocab, size=n).astype(np.int32))
    return prompts


def make_fault_hook(router, n_kill: int, total: int):
    """Kill ``n_kill`` busiest replicas once a quarter of the wave is done."""
    state = {"killed": []}

    def hook(r, step):
        if len(state["killed"]) >= n_kill:
            return
        done = sum(1 for q in r.reqs.values() if q.done)
        if done < max(1, total // 4):
            return
        alive = [st for st in r.states.values() if st.alive]
        victims = sorted(alive, key=lambda st: (-len(st.inflight), st.name))
        for st in victims[: n_kill - len(state["killed"])]:
            if sum(1 for s in r.states.values() if s.alive) <= 1:
                break  # never kill the last replica
            r.kill(st.name)
            state["killed"].append(st.name)

    return hook, state


def await_fleet(router, timeout_s: float) -> None:
    """Step ``router`` until every replica has sent its hello (a spawned
    child sends it once its engine is built); a replica that dies first, or
    a fleet not up within ``timeout_s``, raises."""
    deadline = time.monotonic() + timeout_s
    while True:
        router.step()
        dead = [n for n, st in router.states.items() if not st.alive]
        if dead:
            raise RuntimeError(f"replicas {dead} died before the wave")
        waiting = [n for n, st in router.states.items() if st.hello is None]
        if not waiting:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"replicas {waiting} sent no hello in {timeout_s:.0f} s")
        time.sleep(0.01)


def aggregate_capacity(stats: dict) -> dict:
    """Fleet capacity from per-replica engine stats: total tokens over the
    busiest replica's busy seconds (the multi-host makespan; see the module
    docstring)."""
    toks = sum(s["throughput"]["prefill_tokens"] + s["throughput"]["decode_tokens"]
               for s in stats.values())
    busy = {n: s["throughput"]["prefill_s"] + s["throughput"]["decode_s"]
            for n, s in stats.items()}
    makespan = max(busy.values()) if busy else 0.0
    return {
        "total_tokens": toks,
        "busy_s": busy,
        "makespan_s": makespan,
        "agg_tok_s": toks / makespan if makespan > 0 else 0.0,
    }


def main(argv=None):
    """Serve the wave as the flags ask; returns the report."""
    return run(argv)["report"]


def run(argv=None) -> dict:
    """``main``'s run, returning its report, each request's routed tokens
    (``outs``), the router, the in-process replicas' engines by name
    (``engines``; empty for spawned replicas) and the parity engine
    (``single``, None without ``--parity-check``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--disagg", default=None, help="P:D prefill/decode replica split")
    ap.add_argument("--policy", choices=("least-loaded", "weighted-latency"),
                    default="least-loaded")
    ap.add_argument("--transport", choices=("inproc", "subproc"), default="inproc")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="fraction of replicas to kill mid-wave (requeue drill)")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="seconds of replica silence before failover "
                         "(default: 5 inproc, 300 subproc: a cold subprocess "
                         "replica builds its engine before its first event)")
    ap.add_argument("--no-sticky", action="store_true",
                    help="disable sticky shared-prefix routing")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--long-every", type=int, default=4,
                    help="every Nth request gets a 3x prompt (0 = uniform)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--deploy-int8", action="store_true")
    ap.add_argument("--int-forward", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--kv-bits", type=int, choices=(8, 4), default=8)
    ap.add_argument("--prefix-share", action="store_true")
    ap.add_argument("--decode-steps", type=int, default=1)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--parity-check", action="store_true",
                    help="routed output must be token-identical to one engine")
    ap.add_argument("--parity-eps", type=float, default=0.05)
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the merged fleet metrics view (per-replica "
                         "snapshots + cluster aggregate) to this path")
    ap.add_argument("--json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.kv_bits != 8 and not args.kv_int8:
        ap.error("--kv-bits only affects integer KV blocks; add --kv-int8")
    if not 0.0 <= args.fault_rate < 1.0:
        ap.error("--fault-rate must be in [0, 1)")

    from repro_torch import resolve_device
    from repro_torch.serve.cluster import (
        InProcessReplica, ReplicaConfig, Router, SubprocessReplica,
        make_cluster_configs, parse_disagg,
    )
    from repro_torch.serve.cluster.replica import build_engine, init_params

    dev = resolve_device(args.device)  # a CUDA device without a card raises here
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    base = ReplicaConfig(
        arch=args.arch, reduced=args.reduced, seed=args.seed,
        batch=args.batch, max_seq=args.max_seq, block_size=args.block_size,
        prefill_chunk=args.prefill_chunk, num_blocks=args.num_blocks,
        kv_quant=args.kv_int8, kv_bits=args.kv_bits,
        prefix_share=args.prefix_share, decode_steps=args.decode_steps,
        eos_id=args.eos_id, deploy_int8=args.deploy_int8,
        int_forward=args.int_forward, spec_k=args.spec_k, device=args.device,
    )
    disagg = parse_disagg(args.disagg) if args.disagg else None
    cfgs = make_cluster_configs(base, replicas=args.replicas, disagg=disagg)
    n_replicas = len(cfgs)
    n_kill = min(math.floor(args.fault_rate * n_replicas) or (1 if args.fault_rate > 0 else 0),
                 n_replicas - 1)

    rng = np.random.default_rng(args.seed)
    prompts = build_workload(rng, args.requests, args.prompt_len,
                             args.long_every, min(arch.vocab, 50))

    params = None
    if args.transport == "inproc":
        # share one raw params copy across replicas (and the parity engine)
        params = init_params(base, arch)
        handles = [InProcessReplica(c, params=params) for c in cfgs]
    else:
        if dev.type == "cuda":
            # build once here: each spawned child loads the built libraries
            from repro_torch.kernels import _build

            _build.build_all()
        handles = [SubprocessReplica(c) for c in cfgs]
    hb = args.heartbeat_timeout
    if hb is None:
        hb = 5.0 if args.transport == "inproc" else 300.0
    router = Router(handles, policy=args.policy, sticky=not args.no_sticky,
                    heartbeat_timeout=hb)

    roles = {c.name: c.role for c in cfgs}
    print(f"cluster: {n_replicas} replicas {roles} policy={args.policy} "
          f"transport={args.transport} fault_kills={n_kill}")
    try:
        if args.transport == "subproc":
            await_fleet(router, hb)
        rids = [router.submit(p, max_new=args.max_new, eos_id=args.eos_id)
                for p in prompts]
        hook, chaos = (None, {"killed": []})
        if n_kill:
            hook, chaos = make_fault_hook(router, n_kill, len(rids))
        res = router.drain(on_step=hook)
        outs = [res[r] for r in rids]
        incomplete = [r for r in rids
                      if not router.reqs[r].done or not router.reqs[r].emitted]
        assert not incomplete, f"requests never completed: {incomplete}"

        stats = router.collect_stats()
        agg = aggregate_capacity(stats)
        fleet = router.fleet_metrics(stats)
        dispatched = {n: st.dispatched for n, st in router.states.items()}
        migrated = sum(s["migrated_blocks_in"] for s in stats.values())
        report = {
            "replicas": n_replicas, "roles": roles, "policy": args.policy,
            "transport": args.transport, "requests": args.requests,
            "dispatched": dispatched,
            "completed": sum(1 for q in router.reqs.values() if q.done),
            "requeues": router.requeues, "deaths": router.deaths,
            "killed": chaos["killed"],
            "migrated_blocks": migrated,
            "per_replica": {n: s["throughput"] for n, s in stats.items()},
            "served": {n: s["served"] for n, s in stats.items()},
            **agg,
        }
        report["latency"] = {k: fleet[k] for k in
                             ("p50_latency_s", "p99_latency_s", "p50_ttft_s", "p99_ttft_s")}
        report["fleet_requests_completed"] = fleet["requests_completed"]
        print(f"fleet: {agg['total_tokens']} tokens, makespan {agg['makespan_s']:.2f}s "
              f"busiest-replica busy time -> {agg['agg_tok_s']:.1f} tok/s capacity")
        print(f"dispatched per replica: {dispatched} | requeues={router.requeues} "
              f"deaths={router.deaths} migrated_blocks={migrated}")
        print(f"fleet latency: p50 {fleet['p50_latency_s']:.3f}s "
              f"p99 {fleet['p99_latency_s']:.3f}s | ttft p50 {fleet['p50_ttft_s']:.3f}s "
              f"p99 {fleet['p99_ttft_s']:.3f}s "
              f"({fleet['requests_completed']} completions merged from "
              f"{len(fleet['per_replica'])} replicas)")
        if args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump(fleet, f, indent=2, sort_keys=True)
            print(f"wrote fleet metrics to {args.metrics_json}")

        single = None
        if args.parity_check:
            from repro_torch.serve.engine import parity_up_to_ties

            single = build_engine(base, params=params)
            ref_out = single.generate([p.tolist() for p in prompts], max_new=args.max_new)
            if args.kv_int8:
                ok, ties, detail = parity_up_to_ties(single.last_requests, outs,
                                                     args.parity_eps)
                report["parity_sub_margin_ties"] = ties
                if not ok:
                    raise SystemExit(f"cluster parity FAILED (int8 KV): {detail}")
                print(f"parity OK (int8 KV): {len(outs)} routed requests "
                      f"token-identical up to {ties} sub-margin ties")
            else:
                if outs != ref_out:
                    bad = [i for i, (a, b) in enumerate(zip(outs, ref_out)) if a != b]
                    raise SystemExit(f"cluster parity FAILED on requests {bad}: "
                                     f"{outs[bad[0]]} != {ref_out[bad[0]]}")
                print(f"parity OK: {len(outs)} routed requests token-identical "
                      f"to the single engine")
            report["parity"] = True
    finally:
        router.close()

    for r in rids[: min(4, len(rids))]:
        print(f"req {r}: {res[r]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")
    engines = {h.name: h.replica.engine for h in handles if h.transport == "inproc"}
    return {"report": report, "outs": outs, "router": router, "engines": engines,
            "single": single, "prompts": prompts}


if __name__ == "__main__":
    main()
