"""Cluster replica: one serving engine behind a mailbox.

Port of ``repro.serve.cluster.replica``.  A :class:`Replica` wraps one
:class:`~repro_torch.serve.engine.PagedServeEngine` (any flag combination:
``--int-forward``, ``--kv-int8``, ``--decode-steps``, ``--prefix-share``,
speculative) and speaks a small message protocol with the router.  The same
replica code runs two transports:

* **in-process** (:class:`InProcessReplica`): commands and events move
  through a pair of deques and the router drives ``pump()`` directly; fully
  deterministic.  Every replica's engine keeps its own wall-clock ``stats``,
  so capacity is measured per replica even though one host (and, on one
  card, one device) interleaves them;
* **subprocess** (:class:`SubprocessReplica`): the replica owns a real
  process (``spawn`` context: CUDA does not survive a fork) and the same
  messages cross a ``multiprocessing.Pipe``.  The child rebuilds its engine
  from the picklable :class:`ReplicaConfig`: params drawn from a CPU
  ``torch.Generator`` seeded with ``seed`` (as ``launch/serve.py`` draws
  them), so every replica and the router-side parity engine serve the same
  weights.  On a CUDA device a child loads the kernels the parent built
  (``kernels._build`` keys each library by its source's hash); a child that
  finds no card raises, it never builds on the CPU.

Protocol (plain dicts, picklable; numpy arrays in handoff payloads):

    router -> replica
      {"op": "submit",  "rid", "prompt", "max_new", "eos_id"}   full lifecycle
      {"op": "prefill", "rid", "prompt", "max_new", "eos_id"}   prefill role:
                        run the prompt, export KV, reply with a handoff event
      {"op": "adopt",   "rid", "prompt", "max_new", "eos_id", "payload"}
                        decode role: import migrated KV, decode from it
      {"op": "reset_stats"} | {"op": "stats"} | {"op": "shutdown"}

    replica -> router
      {"type": "hello", "name", "role", "num_blocks", "block_size", "batch"}
      {"type": "heartbeat", ...}      queue depth, free blocks, tok/s EWMAs, p50/p99
      {"type": "progress", "rid", "tokens", "done"}   full generated-so-far list
                        (the router appends only the unseen suffix: the
                        at-most-once emission guarantee lives router-side)
      {"type": "handoff", "rid", "payload"}           exported KV + first token
      {"type": "reject", "rid", "reason"}             request can never fit here
      {"type": "stats", ...}                          throughput + migration counters,
                        the kernel launch counts of the replica's process
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.configs import get_arch, reduced

__all__ = [
    "ReplicaConfig", "Replica", "InProcessReplica", "SubprocessReplica",
    "build_engine",
]

# EWMA smoothing for the per-replica tok/s health signals: ~3-step memory,
# fast enough to follow a load shift, slow enough to ride out one odd step
_EWMA_ALPHA = 0.3


@dataclasses.dataclass
class ReplicaConfig:
    """Everything needed to rebuild a replica's engine in another process.
    Only names and scalars: params are drawn again from ``seed`` (and
    optionally deployed to int8), never shipped.  ``device`` is where the
    engine runs (``"cuda"`` unless the caller asks for the CPU)."""

    name: str = "r0"
    arch: str = "yi-6b"
    reduced: bool = True
    role: str = "both"  # both | prefill | decode
    seed: int = 0
    batch: int = 2
    max_seq: int = 128
    block_size: int = 16
    prefill_chunk: int = 32
    num_blocks: Optional[int] = None
    kv_quant: bool = False
    kv_bits: int = 8
    prefix_share: bool = False
    decode_steps: int = 1
    eos_id: Optional[int] = None
    deploy_int8: bool = False
    int_forward: bool = False
    spec_k: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown replica role {self.role!r}")


def init_params(cfg: ReplicaConfig, arch) -> dict:
    """Raw (un-deployed) params of ``arch`` from a CPU generator seeded with
    ``cfg.seed``, placed on ``cfg.device``: the same weights whatever the
    device or process."""
    import torch

    from repro_torch.models.lm import init_lm

    return init_lm(torch.Generator().manual_seed(cfg.seed), arch, device=cfg.device)


def build_engine(cfg: ReplicaConfig, params=None):
    """Construct the engine a :class:`ReplicaConfig` describes.  ``params``
    (raw, un-deployed, on ``cfg.device``) may be passed to share one copy
    across in-process replicas; subprocesses draw them from the seed."""
    from repro_torch.models.lm import Runtime
    from repro_torch.serve.engine import PagedServeEngine, deploy_params

    arch = get_arch(cfg.arch)  # resolved in this module: a caller may swap in a config
    if cfg.reduced:
        arch = reduced(arch)
    if params is None:
        params = init_params(cfg, arch)
    if cfg.deploy_int8 or cfg.int_forward:
        params = deploy_params(params, arch.quant)
    kw = dict(
        batch=cfg.batch, max_seq=cfg.max_seq, block_size=cfg.block_size,
        prefill_chunk=cfg.prefill_chunk, num_blocks=cfg.num_blocks,
        kv_quant=cfg.kv_quant, kv_bits=cfg.kv_bits,
        prefix_share=cfg.prefix_share, eos_id=cfg.eos_id,
        decode_steps=cfg.decode_steps, seed=cfg.seed, device=cfg.device,
        rt=Runtime(int_forward=cfg.int_forward),
    )
    if cfg.spec_k > 0:
        from repro_torch.serve.spec import SpecServeEngine

        return SpecServeEngine(arch, params, spec_k=cfg.spec_k, **kw)
    return PagedServeEngine(arch, params, **kw)


class LocalMailbox:
    """In-process transport: two deques, zero copies, deterministic order."""

    def __init__(self):
        self._to_replica: deque = deque()
        self._to_router: deque = deque()

    # replica side
    def recv_commands(self) -> list:
        out = list(self._to_replica)
        self._to_replica.clear()
        return out

    def send_event(self, ev: dict) -> None:
        self._to_router.append(ev)

    # router side
    def send_command(self, cmd: dict) -> None:
        self._to_replica.append(cmd)

    def recv_events(self) -> list:
        out = list(self._to_router)
        self._to_router.clear()
        return out


class PipeMailbox:
    """Replica side of a ``multiprocessing.Pipe`` connection."""

    def __init__(self, conn):
        self.conn = conn

    def recv_commands(self) -> list:
        out = []
        try:
            while self.conn.poll():
                out.append(self.conn.recv())
        except (EOFError, OSError):
            out.append({"op": "shutdown"})  # router went away
        return out

    def send_event(self, ev: dict) -> None:
        try:
            self.conn.send(ev)
        except (BrokenPipeError, OSError):
            pass


class Replica:
    """One engine + protocol state.  ``pump()`` is the whole replica loop:
    drain commands, run one pending prefill handoff, advance the engine one
    step, report progress, heartbeat.  ``stats_extra``: fields every stats
    event carries as they stand when it is sent (a harness's own counts of
    the replica's process)."""

    def __init__(self, cfg: ReplicaConfig, box, engine=None, stats_extra=None):
        self.cfg = cfg
        self.box = box
        self.stats_extra = stats_extra or {}
        self.engine = engine if engine is not None else build_engine(cfg)
        self._track: dict = {}  # rid -> (Request, tokens already reported)
        self._pending_prefills: deque = deque()
        self._prev = dict(self.engine.stats)
        self._ewma = {"prefill_tok_s": 0.0, "decode_tok_s": 0.0}
        self.served = 0
        self.shutdown = False
        self.dead = False  # fault injection: a dead replica goes silent
        cache = self.engine.cache
        self.box.send_event({
            "type": "hello", "name": cfg.name, "role": cfg.role,
            "num_blocks": cache.num_blocks, "block_size": cache.block_size,
            "batch": self.engine.batch,
        })

    # -- command handling ---------------------------------------------------

    def _mk_request(self, cmd):
        from repro_torch.serve.engine import Request

        return Request(
            uid=int(cmd["rid"]),
            prompt=np.asarray(cmd["prompt"], np.int32),
            max_new=int(cmd["max_new"]),
            eos_id=cmd.get("eos_id"),
        )

    def _handle(self, cmd: dict) -> None:
        op = cmd["op"]
        if op == "submit":
            if self.cfg.role == "prefill":
                raise RuntimeError(f"{self.cfg.name}: prefill-role replica got a full submit")
            req = self._mk_request(cmd)
            try:
                self.engine.submit(req)
            except ValueError as e:
                self.box.send_event({"type": "reject", "rid": req.uid, "reason": str(e)})
                return
            self._track[req.uid] = (req, 0)
        elif op == "prefill":
            self._pending_prefills.append(self._mk_request(cmd))
        elif op == "adopt":
            if self.cfg.role == "prefill":
                raise RuntimeError(f"{self.cfg.name}: prefill-role replica got an adopt")
            req = self._mk_request(cmd)
            try:
                self.engine.submit_handoff(req, cmd["payload"])
            except ValueError as e:
                self.box.send_event({"type": "reject", "rid": req.uid, "reason": str(e)})
                return
            self._track[req.uid] = (req, 0)
        elif op == "reset_stats":
            # one reset path: engine stats, obs and the cache's counters
            self.engine.reset_stats()
            self._prev = dict(self.engine.stats)
            self._ewma = {"prefill_tok_s": 0.0, "decode_tok_s": 0.0}
            self.served = 0
        elif op == "stats":
            from repro_torch.kernels.ops import launch_counts

            cc = self.engine.cache.counters()
            self.box.send_event({
                "type": "stats", "name": self.cfg.name, "served": self.served,
                "throughput": self.engine.throughput(),
                **{k: cc[k] for k in ("migrated_blocks_in", "migrated_blocks_out",
                                      "migration_bytes_in", "migration_bytes_out",
                                      "prefix_hits")},
                # the full snapshot rides along: the router merges these into
                # the fleet view (merge_snapshots)
                "metrics": self.engine.metrics_snapshot(),
                # this process's kernel launches (a spawned replica's are its
                # own; in-process replicas share the router's process)
                "launches": launch_counts(),
                **self.stats_extra,
            })
        elif op == "shutdown":
            self.shutdown = True
        else:
            raise ValueError(f"unknown op {op!r}")

    # -- loop body ----------------------------------------------------------

    def pump(self) -> bool:
        """One replica turn; returns True if engine work happened (the
        subprocess loop waits briefly on the pipe on False)."""
        if self.dead or self.shutdown:
            return False
        for cmd in self.box.recv_commands():
            self._handle(cmd)
            if self.dead or self.shutdown:
                return False
        worked = False
        # prefill-handoff service: one prompt a pump keeps the replica
        # responsive to kills and heartbeats between prompts
        if self._pending_prefills:
            req = self._pending_prefills[0]
            if self.engine.can_prefill_handoff(req):
                self._pending_prefills.popleft()
                payload = self.engine.prefill_handoff(req)
                self.box.send_event({"type": "handoff", "rid": req.uid, "payload": payload})
                self.served += 1
                worked = True
        if not self.engine.sched.idle():
            self.engine.step()
            worked = True
        self._report_progress()
        self._update_ewma()
        self.box.send_event(self._heartbeat())
        return worked

    def _report_progress(self) -> None:
        done = []
        for rid, (req, sent) in self._track.items():
            if len(req.generated) > sent or (req.done and sent == 0):
                self.box.send_event({
                    "type": "progress", "rid": rid,
                    "tokens": list(req.generated), "done": req.done,
                })
                self._track[rid] = (req, len(req.generated))
            if req.done:
                done.append(rid)
                self.served += 1
        for rid in done:
            del self._track[rid]

    def _update_ewma(self) -> None:
        cur = self.engine.stats
        for phase in ("prefill", "decode"):
            dt = cur[f"{phase}_s"] - self._prev[f"{phase}_s"]
            dtok = cur[f"{phase}_tokens"] - self._prev[f"{phase}_tokens"]
            if dt > 0 and dtok > 0:
                inst = dtok / dt
                old = self._ewma[f"{phase}_tok_s"]
                self._ewma[f"{phase}_tok_s"] = (
                    inst if old == 0.0 else (1 - _EWMA_ALPHA) * old + _EWMA_ALPHA * inst
                )
        self._prev = dict(cur)

    def _heartbeat(self) -> dict:
        cache = self.engine.cache
        # completed-request latencies from the engine's obs histogram
        # (recorded at Scheduler.record_token), nearest-rank percentiles
        lat = self.engine.obs.metrics.histogram("request_latency_s")
        return {
            "type": "heartbeat", "name": self.cfg.name,
            "queued": len(self.engine.sched.queue) + len(self._pending_prefills),
            "live": len(self.engine.sched.live),
            "free_blocks": cache.free_blocks,
            "reclaimable_blocks": cache.reclaimable_blocks(),
            "ewma_prefill_tok_s": self._ewma["prefill_tok_s"],
            "ewma_decode_tok_s": self._ewma["decode_tok_s"],
            "p99_s": lat.percentile(99),
            "p50_s": lat.percentile(50),
            "served": self.served,
        }


def _replica_main(cfg: ReplicaConfig, conn, stats_extra=None) -> None:
    box = PipeMailbox(conn)
    rep = Replica(cfg, box, stats_extra=stats_extra)
    while not rep.shutdown:
        if not rep.pump() and not rep.dead:
            # idle: block briefly on the pipe instead of spinning
            conn.poll(0.002)


class InProcessReplica:
    """Deterministic handle: the router's ``step()`` drives ``pump()``."""

    transport = "inproc"

    def __init__(self, cfg: ReplicaConfig, engine=None, params=None):
        self.cfg = cfg
        self.name = cfg.name
        self.box = LocalMailbox()
        if engine is None and params is not None:
            engine = build_engine(cfg, params=params)
        self.replica = Replica(cfg, self.box, engine=engine)

    def send(self, cmd: dict) -> None:
        self.box.send_command(cmd)

    def poll(self) -> list:
        return self.box.recv_events()

    def pump(self) -> bool:
        if self.replica.dead:
            return False
        return self.replica.pump()

    def alive(self) -> bool:
        return not self.replica.dead

    def kill(self) -> None:
        """Fault injection: the replica goes silent mid-flight (its in-flight
        requests stranded until the router requeues them)."""
        self.replica.dead = True

    def close(self) -> None:
        self.replica.shutdown = True


class SubprocessReplica:
    """Real-process handle over a spawn-context pipe."""

    transport = "subproc"

    def __init__(self, cfg: ReplicaConfig):
        self.cfg = cfg
        self.name = cfg.name
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_replica_main, args=(cfg, child), daemon=True)
        self.proc.start()
        child.close()

    def send(self, cmd: dict) -> None:
        try:
            self.conn.send(cmd)
        except (BrokenPipeError, OSError):
            pass

    def poll(self) -> list:
        out = []
        try:
            while self.conn.poll():
                out.append(self.conn.recv())
        except (EOFError, OSError):
            pass
        return out

    def pump(self) -> bool:
        return False  # the child process pumps itself

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        self.proc.terminate()

    def close(self) -> None:
        if self.proc.is_alive():
            self.send({"op": "shutdown"})
            # keep draining: a child blocked sending heartbeats into a full
            # pipe would never read the shutdown
            deadline = time.monotonic() + 30
            while self.proc.is_alive() and time.monotonic() < deadline:
                self.poll()
                self.proc.join(timeout=0.01)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)

    def __del__(self):
        try:
            if self.proc.is_alive():
                self.proc.terminate()
        except Exception:
            pass
