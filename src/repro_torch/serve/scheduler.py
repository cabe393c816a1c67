"""Serving scheduler: admission queue, chunked prefill plans, slot recycling.

Pure host-side policy, a copy of ``repro.serve.scheduler`` with its
tracing and metrics hooks.  The engine owns execution (prefill / decode
steps, the paged cache); the scheduler owns *which* request occupies *which*
slot *when*:

* **continuous mode** (default): any freed slot is immediately refilled from
  the FIFO queue, so long requests never stall short ones behind them.
  Prefill is per-slot and isolated (the engine runs it on a B=1 cache view),
  which is also what makes continuous batching sound for recurrent stacks —
  admitting into a live batch never touches other rows' states.
* **lockstep mode** (the conservative fallback for recurrent stacks, and the
  batched-prefill fast path): requests are admitted in equal-prompt-length
  groups into an *empty* engine, prefilled together in one batched chunked
  pass, and decoded until the whole group drains.

Requests also carry their latency bookkeeping (submit / first-token / finish
timestamps) so the benchmark derives p50/p99 without instrumenting engines.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ServeRequest", "Scheduler"]


@dataclasses.dataclass
class ServeRequest:
    uid: int
    prompt: np.ndarray  # (T,) int32, non-empty (engine normalizes)
    max_new: int = 16
    # end-of-sequence token: the request finishes as soon as it *emits* this
    # id (the EOS token is appended to ``generated``, then the slot and its
    # cache blocks release immediately — no decoding past end-of-sequence,
    # no blocks burned on garbage).  ``None`` defers to the engine's default
    # (``eos_id=`` engine kwarg), which may itself be None (length-only stop).
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    # greedy decision margins: top-2 logit gap at the step that produced
    # generated[t] — what the int8-KV parity bound reads (a mismatch only
    # counts where the float baseline's margin exceeds the quantization-noise
    # bound; below it the decision is a tie).  Engines append one entry per
    # generated token; empty when the engine does not track margins.
    margins: list = dataclasses.field(default_factory=list)
    done: bool = False
    prefilled: int = 0  # prompt tokens already in the cache
    last_token: int = -1  # most recent sampled token (next decode input)
    # speculative-decoding bookkeeping (SpecServeEngine): draft tokens
    # proposed for / accepted by this request — per-request acceptance rate
    spec_proposed: int = 0
    spec_accepted: int = 0
    # latency timestamps: ``None`` until the event happens.  They used to
    # default to 0.0, so reading ``ttft``/``latency`` on an in-flight request
    # returned epoch-scale *negative* values (now - 0.0 negated) that a
    # percentile aggregation would silently swallow; the properties now
    # refuse instead of lying.
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def latency(self) -> float:
        if self.submitted_at is None or self.finished_at is None:
            raise RuntimeError(
                f"request {self.uid}: latency read before completion "
                f"(submitted={self.submitted_at}, finished={self.finished_at})"
            )
        return self.finished_at - self.submitted_at

    @property
    def ttft(self) -> float:
        if self.submitted_at is None or self.first_token_at is None:
            raise RuntimeError(
                f"request {self.uid}: ttft read before the first token "
                f"(submitted={self.submitted_at}, first_token={self.first_token_at})"
            )
        return self.first_token_at - self.submitted_at


class Scheduler:
    def __init__(self, n_slots: int, *, prefill_chunk: int = 32, lockstep: bool = False,
                 obs=None):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.lockstep = lockstep
        # the observability bundle (``repro_torch.obs.Obs``) shared with the
        # owning engine: requests enter and complete here, so the submit /
        # emit instants and the per-request latency histograms are recorded
        # here rather than in an engine
        self.obs = obs
        self.queue: deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * n_slots

    # -- state --------------------------------------------------------------

    @property
    def live(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def idle(self) -> bool:
        return not self.queue and not self.live

    # -- admission ----------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        req.submitted_at = time.perf_counter()
        self.queue.append(req)
        if self.obs is not None:
            self.obs.trace.instant("submit", {"uid": req.uid, "prompt": len(req.prompt)})

    def admissions(self, can_admit: Callable[[ServeRequest], bool]) -> List[Tuple[int, "ServeRequest"]]:
        """Assign queued requests to slots; returns the new (slot, request)
        pairs.  ``can_admit`` gates on engine capacity (free KV blocks).

        FIFO is strict: if the head of the queue does not fit, nothing behind
        it is admitted either (no starvation of large requests).
        """
        if self.lockstep:
            return self._admit_lockstep(can_admit)
        out = []
        free = (i for i, r in enumerate(self.slots) if r is None)
        for slot in free:
            if not self.queue or not can_admit(self.queue[0]):
                break
            req = self.queue.popleft()
            self.slots[slot] = req
            out.append((slot, req))
        return out

    def _admit_lockstep(self, can_admit) -> List[Tuple[int, "ServeRequest"]]:
        """Equal-length group into an empty engine (recurrent-stack fallback:
        every row advances through identical positions, so a batched prefill
        never desynchronizes the non-positional states)."""
        if self.live or not self.queue:
            return []
        group_len = len(self.queue[0].prompt)
        out = []
        for slot in range(self.n_slots):
            if not self.queue or len(self.queue[0].prompt) != group_len:
                break
            if not can_admit(self.queue[0]):
                break
            req = self.queue.popleft()
            self.slots[slot] = req
            out.append((slot, req))
        return out

    # -- prefill ------------------------------------------------------------

    def prefill_plan(self, slot: int) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield ``(tokens, start)`` chunks remaining for this slot's prompt;
        consuming a chunk marks it prefilled."""
        req = self.slots[slot]
        while req.prefilled < len(req.prompt):
            lo = req.prefilled
            hi = min(lo + self.prefill_chunk, len(req.prompt))
            req.prefilled = hi
            yield req.prompt[lo:hi], lo

    # -- decode bookkeeping -------------------------------------------------

    def record_token(self, slot: int, token: int) -> bool:
        """Append a sampled token; returns True (and frees the slot) when the
        request just completed — either ``max_new`` tokens emitted or the
        token *is* the request's ``eos_id`` (the EOS token itself is recorded,
        then the request stops; nothing decodes past end-of-sequence).  The
        engine releases cache blocks on True."""
        req = self.slots[slot]
        if not req.generated:
            req.first_token_at = time.perf_counter()
        req.generated.append(token)
        req.last_token = token
        if len(req.generated) >= req.max_new or (
            req.eos_id is not None and token == req.eos_id
        ):
            req.done = True
            req.finished_at = time.perf_counter()
            self.slots[slot] = None
            if self.obs is not None:
                m = self.obs.metrics
                m.counter("requests_completed").inc()
                if req.submitted_at is not None:
                    m.histogram("request_latency_s").observe(req.latency)
                    if req.first_token_at is not None:
                        m.histogram("request_ttft_s").observe(req.ttft)
                self.obs.trace.instant("emit", {"uid": req.uid, "tokens": len(req.generated)})
            return True
        return False
