"""Cluster router: admission routing, backpressure, stickiness, failover.

Port of ``repro.serve.cluster.router``: host logic only (no tensor touches
it), copied with its semantics, so the same scripted replica events drive
both routers to the same commands.  The router owns the client-facing
request queue and drives N replica handles
(:mod:`repro_torch.serve.cluster.replica`).  Design rules:

* **Backpressure by block budget.**  The router keeps its own commitment
  ledger per replica — the worst-case blocks of every dispatched-but-
  unfinished request — and never dispatches past a replica's pool capacity.
  Excess traffic waits *here* (where it can still be re-routed or requeued),
  not in a replica's queue.  Admission order is strict FIFO, matching the
  engine scheduler's no-starvation rule: if the head request fits nowhere,
  nothing behind it jumps ahead.
* **Policies.**  ``least-loaded`` picks the replica with the fewest committed
  blocks; ``weighted-latency`` scores replicas by expected drain time
  (committed tokens / heartbeat decode-tok/s EWMA) so a faster engine —
  e.g. a megastep replica next to a per-tick one — absorbs more of the wave.
* **Sticky prefixes.**  Requests whose first prompt block matches an earlier
  request are routed to the replica that served it (when it has room), so
  radix-prompt-cache hits stay warm on one replica instead of spraying cold
  misses across the fleet.
* **Failover.**  A replica is dead when its process/flag says so or when no
  event has arrived for ``heartbeat_timeout`` seconds (injectable clock).
  Its in-flight requests are requeued at the *front* of the queue in
  original order.  Request ids make the retry idempotent; the router emits
  each client token **at most once** by appending only the unseen suffix of
  every progress report — a restarted (greedy, deterministic) request
  regenerates the same prefix and the client stream just continues.
* **Disaggregation.**  With prefill-role replicas present, prompts are
  dispatched to a prefill replica first; its handoff event (exported KV
  blocks + first token, :meth:`PagedKVCache.export_blocks`) is then
  dispatched to a decode-role replica that imports the blocks and decodes
  without recomputing the prompt.  The handoff payload lives at the router
  until completion, so a decode-replica death re-dispatches the *same* KV
  — prefill work is never repeated on failover.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

__all__ = ["Router", "ClusterRequest"]

POLICIES = ("least-loaded", "weighted-latency")


@dataclasses.dataclass
class ClusterRequest:
    rid: int
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int]
    emitted: list = dataclasses.field(default_factory=list)
    done: bool = False
    stage: str = "queued"  # queued | prefill | await_decode | decode | done
    replica: Optional[str] = None
    attempts: int = 0
    handoff: Optional[dict] = None  # exported-KV payload (disagg path)
    submitted_at: Optional[float] = None
    finished_at: Optional[float] = None


class _ReplicaState:
    def __init__(self, handle):
        self.handle = handle
        self.name = handle.name
        self.role = handle.cfg.role
        self.alive = True
        self.hello: Optional[dict] = None
        self.hb: dict = {}
        self.last_seen: Optional[float] = None
        self.inflight: dict = {}  # rid -> committed blocks
        self.committed = 0
        self.dispatched = 0
        self.stats: Optional[dict] = None

    @property
    def capacity(self) -> int:
        return self.hello["num_blocks"] - 1  # block 0 is the trash block

    @property
    def block_size(self) -> int:
        return self.hello["block_size"]


class Router:
    def __init__(
        self,
        handles,
        *,
        policy: str = "least-loaded",
        sticky: bool = True,
        heartbeat_timeout: float = 5.0,
        clock=time.monotonic,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; pick from {POLICIES}")
        if not handles:
            raise ValueError("router needs at least one replica handle")
        self.policy = policy
        self.sticky = sticky
        self.heartbeat_timeout = heartbeat_timeout
        self.clock = clock
        self.states = {h.name: _ReplicaState(h) for h in handles}
        if len(self.states) != len(handles):
            raise ValueError("replica names must be unique")
        self.reqs: dict = {}
        self.queue: deque = deque()  # ClusterRequests awaiting (pre)fill dispatch
        self.pending_adopts: deque = deque()  # handoffs awaiting decode capacity
        self._sticky: dict = {}  # first-block token key -> replica name
        self._next_rid = 0
        self.requeues = 0
        self.deaths = 0

    # -- client API ---------------------------------------------------------

    def submit(self, prompt, max_new: int = 16, eos_id: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        creq = ClusterRequest(
            rid=rid, prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new=int(max_new), eos_id=eos_id,
            submitted_at=self.clock(),
        )
        self.reqs[rid] = creq
        self.queue.append(creq)
        return rid

    def outstanding(self) -> int:
        return sum(1 for r in self.reqs.values() if not r.done)

    def results(self) -> dict:
        return {rid: list(r.emitted) for rid, r in self.reqs.items()}

    def step(self, now: Optional[float] = None) -> int:
        """One router turn: pump in-process replicas, ingest their events,
        fail over dead replicas, dispatch what fits.  Returns the number of
        events ingested (0 = externally idle; drivers of subprocess
        clusters sleep briefly on it)."""
        now = self.clock() if now is None else now
        for st in self.states.values():
            if st.alive:
                st.handle.pump()
        n_events = self._drain_events(now)
        self._check_health(now)
        self._dispatch()
        return n_events

    def drain(self, *, max_steps: int = 200_000, idle_timeout_s: float = 300.0,
              on_step=None) -> dict:
        """Step until every submitted request completes.  ``on_step(router,
        step_idx)`` is the fault-injection hook.  ``idle_timeout_s`` bounds
        wall time with no observable progress (covers a hung subprocess) —
        generous by default because a cold replica's first prompt pays its
        kernel builds and first-call set-up."""
        steps = 0
        last_progress = time.monotonic()
        progress_mark = (0, 0)
        while self.outstanding():
            n = self.step()
            if on_step is not None:
                on_step(self, steps)
            steps += 1
            mark = (sum(len(r.emitted) for r in self.reqs.values()), self.requeues)
            if n or mark != progress_mark:
                progress_mark = mark
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > idle_timeout_s:
                raise RuntimeError(
                    f"cluster made no progress for {idle_timeout_s:.0f}s "
                    f"({self.outstanding()} requests outstanding)"
                )
            if steps > max_steps:
                raise RuntimeError(f"cluster drain exceeded {max_steps} steps")
            if n == 0 and all(
                st.handle.transport != "inproc" for st in self.states.values()
            ):
                time.sleep(0.002)
        return self.results()

    def close(self) -> None:
        for st in self.states.values():
            st.handle.close()

    # -- fleet management ---------------------------------------------------

    def reset_stats(self) -> None:
        for st in self.states.values():
            if st.alive:
                st.handle.send({"op": "reset_stats"})

    def collect_stats(self, timeout_s: float = 60.0) -> dict:
        """Synchronous stats sweep of the live fleet."""
        want = [st for st in self.states.values() if st.alive]
        for st in want:
            st.stats = None
            st.handle.send({"op": "stats"})
        deadline = time.monotonic() + timeout_s
        while any(st.stats is None for st in want):
            self.step()
            if time.monotonic() > deadline:
                missing = [st.name for st in want if st.stats is None]
                raise RuntimeError(f"stats timeout: no reply from {missing}")
        return {st.name: st.stats for st in want}

    def fleet_metrics(self, stats: Optional[dict] = None) -> dict:
        """Fleet-wide observability view over the replicas' unified metric
        snapshots (the ``metrics`` field each stats event now carries).

        Snapshots merge with :func:`repro_torch.obs.merge_snapshots` — counters
        add, gauges max, histograms concat — which is associative and
        commutative, so ``replica ⊕ replica == fleet`` no matter how the
        sweep ordered the replies.  Aggregate latency percentiles are then
        *exact* over the fleet's completed requests (raw-sample histograms),
        not an average of per-replica percentiles.  Router-side counters
        (requeues, deaths) ride along since no replica can see them.
        """
        from repro_torch.obs import merge_snapshots, percentile

        if stats is None:
            stats = self.collect_stats()
        per_replica = {name: ev.get("metrics", {}) for name, ev in stats.items()}
        fleet = merge_snapshots(*per_replica.values())
        lat = fleet.get("request_latency_s", {}).get("values", [])
        ttft = fleet.get("request_ttft_s", {}).get("values", [])
        return {
            "replicas": sorted(stats),
            "fleet": fleet,
            "per_replica": per_replica,
            "requests_completed": len(lat),
            "p50_latency_s": percentile(lat, 50),
            "p99_latency_s": percentile(lat, 99),
            "p50_ttft_s": percentile(ttft, 50),
            "p99_ttft_s": percentile(ttft, 99),
            "busy_s": {
                name: ev["throughput"]["prefill_s"] + ev["throughput"]["decode_s"]
                for name, ev in stats.items()
            },
            "requeues": self.requeues,
            "deaths": self.deaths,
        }

    def kill(self, name: str) -> None:
        """Fault injection: silence a replica (the router discovers the
        death through its liveness/heartbeat machinery, not through this
        call)."""
        self.states[name].handle.kill()

    # -- event ingestion ----------------------------------------------------

    def _drain_events(self, now: float) -> int:
        n = 0
        for st in self.states.values():
            for ev in st.handle.poll():
                n += 1
                st.last_seen = now
                kind = ev["type"]
                if kind == "hello":
                    st.hello = ev
                elif kind == "heartbeat":
                    st.hb = ev
                elif kind == "stats":
                    st.stats = ev
                elif kind == "progress":
                    self._on_progress(st, ev, now)
                elif kind == "handoff":
                    self._on_handoff(st, ev, now)
                elif kind == "reject":
                    # the router pre-validates block budgets, so a reject
                    # means a config skew worth failing loudly on
                    raise RuntimeError(
                        f"replica {st.name} rejected rid {ev['rid']}: {ev['reason']}"
                    )
                else:
                    raise RuntimeError(f"unknown event {kind!r} from {st.name}")
        return n

    def _on_progress(self, st: _ReplicaState, ev: dict, now: float) -> None:
        creq = self.reqs[ev["rid"]]
        if creq.done or creq.replica != st.name:
            return  # stale report from a replica this rid was requeued off
        new = ev["tokens"][len(creq.emitted):]
        creq.emitted.extend(int(t) for t in new)
        if ev["done"]:
            self._complete(st, creq, now)

    def _on_handoff(self, st: _ReplicaState, ev: dict, now: float) -> None:
        creq = self.reqs[ev["rid"]]
        if creq.done or creq.replica != st.name:
            return
        self._uncommit(st, creq.rid)
        payload = ev["payload"]
        creq.handoff = payload
        creq.replica = None
        if not creq.emitted:
            # the prefill dispatch sampled the first token; emit it now so a
            # decode replica's later report dedups against it
            creq.emitted.append(int(payload["first_token"]))
        if len(creq.emitted) >= creq.max_new or (
            creq.eos_id is not None and creq.emitted[-1] == creq.eos_id
        ):
            self._complete(None, creq, now)  # finished at the first token
        else:
            creq.stage = "await_decode"
            self.pending_adopts.append(creq)

    def _complete(self, st: Optional[_ReplicaState], creq: ClusterRequest,
                  now: float) -> None:
        creq.done = True
        creq.stage = "done"
        creq.finished_at = now
        if st is not None:
            self._uncommit(st, creq.rid)
        creq.replica = None
        creq.handoff = None

    def _uncommit(self, st: _ReplicaState, rid: int) -> None:
        st.committed -= st.inflight.pop(rid, 0)

    # -- health -------------------------------------------------------------

    def _check_health(self, now: float) -> None:
        for st in self.states.values():
            if not st.alive:
                continue
            stale = (
                st.last_seen is not None
                and now - st.last_seen > self.heartbeat_timeout
            )
            if not st.handle.alive() or stale:
                self._mark_dead(st)

    def _mark_dead(self, st: _ReplicaState) -> None:
        st.alive = False
        self.deaths += 1
        # requeue the dead replica's in-flight work at the queue front, in
        # original submission order; the emitted-suffix dedup makes the
        # retry at-most-once for the client stream
        for rid in sorted(st.inflight, reverse=True):
            creq = self.reqs[rid]
            if creq.done:
                continue
            creq.attempts += 1
            creq.replica = None
            self.requeues += 1
            if creq.handoff is not None:
                creq.stage = "await_decode"
                self.pending_adopts.appendleft(creq)
            else:
                creq.stage = "queued"
                self.queue.appendleft(creq)
        st.inflight.clear()
        st.committed = 0
        self._sticky = {k: v for k, v in self._sticky.items() if v != st.name}

    # -- dispatch -----------------------------------------------------------

    def _blocks(self, st: _ReplicaState, creq: ClusterRequest, full: bool) -> int:
        toks = len(creq.prompt) + (creq.max_new if full else 0)
        return -(-toks // st.block_size)

    def _eligible(self, roles) -> list:
        return [
            st for st in self.states.values()
            if st.alive and st.hello is not None and st.role in roles
        ]

    def _score(self, st: _ReplicaState) -> tuple:
        if self.policy == "weighted-latency":
            ew = st.hb.get("ewma_decode_tok_s", 0.0)
            if ew > 0:
                # expected drain: committed tokens at the replica's measured
                # decode rate (cold replicas fall through to least-loaded)
                return (st.committed * st.block_size / ew, len(st.inflight), st.name)
        return (float(st.committed), len(st.inflight), st.name)

    def _pick(self, candidates: list, creq: ClusterRequest, full: bool):
        if not candidates:
            return None
        fits_anywhere = False
        with_room = []
        for st in candidates:
            need = self._blocks(st, creq, full)
            if need <= st.capacity:
                fits_anywhere = True
            if st.committed + need <= st.capacity:
                with_room.append(st)
        if not fits_anywhere:
            raise RuntimeError(
                f"rid {creq.rid} needs more blocks than any eligible replica's "
                f"whole pool — it can never be served"
            )
        if not with_room:
            return None  # backpressure: wait for commitments to drain
        if self.sticky:
            key = self._sticky_key(creq)
            name = self._sticky.get(key)
            for st in with_room:
                if st.name == name:
                    return st
        return min(with_room, key=self._score)

    def _sticky_key(self, creq: ClusterRequest):
        bs = next(st.block_size for st in self.states.values() if st.hello)
        return tuple(int(t) for t in creq.prompt[:bs])

    def _commit(self, st: _ReplicaState, creq: ClusterRequest, full: bool) -> None:
        need = self._blocks(st, creq, full)
        st.inflight[creq.rid] = need
        st.committed += need
        st.dispatched += 1
        creq.replica = st.name

    def _dispatch(self) -> None:
        # handoffs first: their prefill work is sunk cost holding router
        # memory, and adopting frees the pipeline for the next prompt
        while self.pending_adopts:
            creq = self.pending_adopts[0]
            st = self._pick(self._eligible(("both", "decode")), creq, full=True)
            if st is None:
                break
            self.pending_adopts.popleft()
            self._commit(st, creq, full=True)
            creq.stage = "decode"
            st.handle.send({
                "op": "adopt", "rid": creq.rid,
                "prompt": [int(t) for t in creq.prompt],
                "max_new": creq.max_new, "eos_id": creq.eos_id,
                "payload": creq.handoff,
            })
        while self.queue:
            creq = self.queue[0]
            prefillers = self._eligible(("prefill",))
            if prefillers:
                st = self._pick(prefillers, creq, full=False)
                if st is None:
                    break
                self.queue.popleft()
                self._commit(st, creq, full=False)
                creq.stage = "prefill"
                op = "prefill"
            else:
                st = self._pick(self._eligible(("both", "decode")), creq, full=True)
                if st is None:
                    break
                self.queue.popleft()
                self._commit(st, creq, full=True)
                creq.stage = "decode"
                op = "submit"
            if self.sticky:
                self._sticky.setdefault(self._sticky_key(creq), st.name)
            st.handle.send({
                "op": op, "rid": creq.rid,
                "prompt": [int(t) for t in creq.prompt],
                "max_new": creq.max_new, "eos_id": creq.eos_id,
            })
