"""Whether gloo moves DTensor's collectives for CUDA tensors of ranks that
share one card.

    python3 tools/probe_gloo_cuda.py [--ranks 4]

For each collective in turn, spawns ``--ranks`` processes on ``cuda:0``
over a gloo group on a ``(data=2, model=ranks/2)`` mesh and runs it on a
CUDA tensor: the redistributions DTensor's sharded step needs, all-gather
(``Shard -> Replicate``), reduce-scatter (``Partial -> Shard``),
all-reduce (``Partial -> Replicate``), all-to-all (``Shard(0) ->
Shard(1)``), and the compressed wire's own ``all_to_all_single`` and
``all_gather`` on bytes.  A world that does not answer within
``--timeout`` seconds is killed and its collective reported as hanging.
Prints one line a collective (``ok`` with the result checked against the
plain arithmetic, the error, or ``hangs``) and a JSON summary last.  Exits
1 without a card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, op: str, q) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    x = torch.randn(8, 8, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    try:
        if op == "init_device_mesh":
            init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
            got, want = x, x
        elif op in ("all_to_all_single_bytes", "all_gather_bytes"):
            if op == "all_to_all_single_bytes":
                sent = (torch.arange(world * 4, dtype=torch.int8, device="cuda")
                        .reshape(world, 4) + rank)
                recv = torch.empty_like(sent)
                dist.all_to_all_single(recv.view(torch.uint8), sent.view(torch.uint8))
                got = recv.float()
                want = torch.stack([torch.arange(4, device="cuda") + 4 * rank + r
                                    for r in range(world)]).float()
            else:
                parts = torch.empty(world, 3, dtype=torch.int8, device="cuda")
                dist.all_gather(list(parts.view(torch.uint8)),
                                torch.full((3,), rank, dtype=torch.int8, device="cuda")
                                .view(torch.uint8))
                got = parts.float()
                want = torch.arange(world, device="cuda")[:, None].expand(world, 3).float()
        else:
            dm = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "model"))
            part = DTensor.from_local(x, dm, [Partial(), Partial()], run_check=False)
            if op == "all_gather":
                sh = distribute_tensor(x, dm, [Shard(0), Shard(1)])
                got, want = sh.redistribute(dm, [Replicate(), Replicate()]).to_local(), x
            elif op == "reduce_scatter":
                got = part.redistribute(dm, [Shard(0), Shard(1)]).to_local()
                want = (x * world).chunk(2, 0)[dm.get_local_rank("data")].chunk(
                    world // 2, 1)[dm.get_local_rank("model")]
            elif op == "all_reduce":
                got, want = part.redistribute(dm, [Replicate(), Replicate()]).to_local(), x * world
            else:  # all_to_all
                s0 = distribute_tensor(x, dm, [Shard(0), Replicate()])
                got = s0.redistribute(dm, [Shard(1), Replicate()]).to_local()
                want = x.chunk(2, 1)[dm.get_local_rank("data")]
        torch.cuda.synchronize()
        res = "ok" if torch.allclose(got, want, atol=1e-5) else "wrong values"
    except Exception as e:  # a probe: every failure is the answer
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    q.put((rank, res))
    dist.destroy_process_group()


OPS = ("init_device_mesh", "all_gather", "all_reduce", "reduce_scatter", "all_to_all",
       "all_to_all_single_bytes", "all_gather_bytes")


def _world(ctx, op: str, ranks: int, timeout: float) -> dict:
    """One world of ``ranks`` processes running ``op``: ``{rank: result}``,
    ``hangs`` for each rank that did not answer in time (then killed)."""
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, ranks, port, op, q)) for r in range(ranks)]
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + timeout
    while len(results) < ranks and time.monotonic() < end:
        try:
            r, res = q.get(timeout=max(0.1, end - time.monotonic()))
            results[r] = res
        except queue.Empty:
            break
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    return {r: results.get(r, "hangs") for r in range(ranks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=30.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    ctx = mp.get_context("spawn")
    summary = {}
    for op in OPS:
        t0 = time.perf_counter()
        res = _world(ctx, op, args.ranks, args.timeout)
        summary[op] = all(v == "ok" for v in res.values())
        print(f"{op} ({time.perf_counter() - t0:.1f} s): "
              + "; ".join(f"rank {r} {v}" for r, v in sorted(res.items())), flush=True)
    print(json.dumps({"gloo_cuda_shared_card": summary, "ranks": args.ranks,
                      "all_ok": all(summary.values())}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
