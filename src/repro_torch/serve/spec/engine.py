"""SpecServeEngine: speculative decoding on the paged serving stack.

Port of ``repro.serve.spec.engine``.  A round replaces k + 1 plain decode
ticks with a draft and a verify:

1. **draft** — the drafter proposes k greedy tokens a live row;
2. **verify** — one ``apply_lm`` call scores ``[x0, d1..dk]`` (``T = k + 1``)
   under the engine's own runtime, accepts the longest matching draft
   prefix and emits the verifier's argmax as the correction (first
   mismatch) or the bonus (full acceptance).

The output is token-identical to plain greedy decode of the same engine
configuration (``verify.py``).  Before the round, ``ensure_writable``
declares its write span ``[lens, lens + k + 1)`` (copy-on-write of any
prefix-shared block, the watermark recorded); after it, ``rollback`` rewinds
the write position past the rejected tail.  The span never leaves the
request's admission reservation (``_slot_tokens`` adds ``spec_k`` of
headroom), so block ownership does not change from round to round.

Only fully paged, non-recurrent, non-lockstep engines speculate (ring and
recurrent state advance destructively and cannot roll back): elsewhere the
engine refuses under ``strict`` and otherwise serves plain
(``spec_supported`` False).  Acceptance rides on each request
(``spec_proposed`` / ``spec_accepted``) and sums into ``spec_stats``; when
the acceptance EMA drops below ``min_accept`` the engine serves plain rounds
through the parent's ``_advance`` (the megastep with ``decode_steps > 1``)
and probes speculation again every ``probe_interval`` rounds.  Draft and
verify run eagerly; ``decode_dispatches`` books a round as 2, as the
reference does.  A traced engine records the reference's ``spec_round``
span around a round, with its ``cow_preflight``, ``spec_draft`` and
``spec_verify`` inside; ``metrics_snapshot()`` adds the ``spec_<k>``
counters of ``spec_stats`` and the ``spec_acceptance_rate`` gauge.
Sampling stays greedy: the engine refuses any other method, as the
reference does.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.lm import Runtime
from repro_torch.serve.engine import PagedServeEngine
from repro_torch.serve.spec.drafter import ModelDrafter, SelfDrafter
from repro_torch.serve.spec.verify import accept_prefix, make_verify_step

__all__ = ["SpecServeEngine"]


def _fresh_spec_stats() -> dict:
    return {"rounds": 0, "fallback_rounds": 0, "proposed": 0, "accepted": 0, "emitted": 0,
            "bonus": 0}


class SpecServeEngine(PagedServeEngine):
    """Paged serving engine with precision-staged speculative decoding.  The
    default drafter is the engine's own weights under
    ``Runtime(int_forward=True, decode_kernel=rt.decode_kernel)``."""

    def __init__(
        self,
        arch,
        params,
        *,
        spec_k: int = 4,
        drafter=None,
        draft_rt: Optional[Runtime] = None,
        min_accept: float = 0.1,
        probe_interval: int = 8,
        strict: bool = False,
        **kw,
    ):
        sample = kw.get("sample")
        if sample is not None and sample.method != "greedy":
            raise ValueError("speculative decoding is lossless for greedy sampling only; "
                             f"got sample method {sample.method!r}")
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1 (use PagedServeEngine for plain decode)")
        super().__init__(arch, params, **kw)
        self.spec_k = spec_k
        self.min_accept = min_accept
        self.probe_interval = probe_interval
        self.spec_supported = (self.cache.fully_paged and not self.recurrent
                               and not self.sched.lockstep)
        if not self.spec_supported:
            if strict:
                raise ValueError(
                    f"{arch.name}: speculative decoding needs a fully paged, non-recurrent, "
                    "non-lockstep configuration (ring/recurrent state cannot unwind rejected "
                    "drafts); serving falls back to plain decode unless strict")
            self.drafter = None
        else:
            self.drafter = drafter or SelfDrafter(
                arch, draft_rt or Runtime(int_forward=True, decode_kernel=self.rt.decode_kernel))
            if isinstance(self.drafter, ModelDrafter) and self.drafter.arch.vocab != arch.vocab:
                raise ValueError(f"draft vocab {self.drafter.arch.vocab} != target vocab "
                                 f"{arch.vocab}")
        self._verify = make_verify_step(arch, self.rt)
        self._accept_ema = 1.0
        self._plain_rounds = 0
        self.spec_stats = _fresh_spec_stats()

    # -- bookkeeping --------------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the spec tallies with the throughput stats (after a warm-up
        pass, so the acceptance rate does not count it)."""
        super().reset_stats()
        self.spec_stats = _fresh_spec_stats()

    def acceptance_rate(self) -> float:
        """Accepted draft tokens / proposed draft tokens, engine lifetime."""
        return self.spec_stats["accepted"] / max(self.spec_stats["proposed"], 1)

    def _sync_metrics(self) -> None:
        super()._sync_metrics()
        m = self.obs.metrics
        for k, v in self.spec_stats.items():
            m.counter(f"spec_{k}").set(v)
        m.gauge("spec_acceptance_rate").set(self.acceptance_rate())

    def spec_active(self) -> bool:
        return self.spec_supported and self._accept_ema >= self.min_accept

    def _slot_tokens(self, req) -> int:
        # a round writes up to spec_k positions past the emitted stream before
        # its rollback: reserve that headroom at admission
        return super()._slot_tokens(req) + (self.spec_k if self.spec_supported else 0)

    def _release_slot(self, slot: int) -> None:
        if self.drafter is not None:
            self.drafter.release(slot)
        super()._release_slot(slot)

    def _on_admitted(self, slot: int, req) -> None:
        if self.drafter is not None and self.sched.slots[slot] is req:
            self.drafter.admit(slot, req.prompt, req.max_new)

    # -- the speculative round ------------------------------------------------------

    def _advance(self) -> int:
        if not self.sched.live:
            return 0
        if self.spec_active():
            return self.spec_round()
        if self.spec_supported:
            # acceptance collapsed: plain rounds, probing again periodically
            # (the probe's own rate replaces the stale EMA)
            self._plain_rounds += 1
            if self._plain_rounds >= self.probe_interval:
                self._plain_rounds = 0
                return self.spec_round(probe=True)
        self.spec_stats["fallback_rounds"] += 1
        return super()._advance()

    def spec_round(self, probe: bool = False) -> int:
        """Draft k, verify in one batched call, accept-prefix, roll back."""
        live = self.sched.live
        if not live:
            return 0
        k = self.spec_k
        tr = self.obs.trace
        t0 = time.perf_counter()
        with tr.span("spec_round", {"live": len(live), "k": k, "probe": probe}):
            lens0 = self.cache.lens.copy()
            with tr.span("cow_preflight", {"live": len(live)}):
                for i in live:
                    # the round writes [lens, lens + k + 1): draft inputs, then
                    # the verify span; shared blocks copy up front and the
                    # watermark records how far garbage may reach on rejection
                    self.cache.allocate(i, int(lens0[i]) + k + 1)
                    self.cache.ensure_writable(i, int(lens0[i]), int(lens0[i]) + k + 1)
            tok_in = np.zeros((self.batch,), np.int32)
            for i in live:
                tok_in[i] = self.sched.slots[i].last_token
            with tr.span("spec_draft", {"live": len(live), "k": k}):
                proposals = self.drafter.propose(self, live, tok_in, k)  # (B, k)
            tokens = np.zeros((self.batch, k + 1), np.int32)
            tokens[live] = np.concatenate([tok_in[live, None], proposals[live]], axis=1)
            is_live = np.zeros((self.batch,), bool)
            is_live[live] = True
            dev = self.device
            with tr.span("spec_verify", {"live": len(live)}):
                am, mg = self._verify(self.params, torch.as_tensor(tokens, device=dev),
                                      self.cache.pools, self.cache.bt(),
                                      torch.as_tensor(lens0, device=dev),
                                      torch.as_tensor(is_live, device=dev))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_dispatches"] += 2  # draft + batched verify, as booked by the reference

        emitted_total = 0
        round_accepted = 0
        for i in live:
            req = self.sched.slots[i]
            a, emitted = accept_prefix(proposals[i], am[i])
            req.spec_proposed += k
            req.spec_accepted += a
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += a
            if a == k:
                self.spec_stats["bonus"] += 1
            round_accepted += a
            done = False
            for j, t in enumerate(emitted):
                req.margins.append(float(mg[i, j]))
                emitted_total += 1
                if self.sched.record_token(i, int(t)):
                    done = True
                    break
            if done:
                self._release_slot(i)
            else:
                # keep the consumed prefix [x0, d1..da] and rewind past the
                # rejected tail, lens only: the reservation stays owned
                new_len = int(lens0[i]) + 1 + a
                self.cache.rollback(i, new_len)
                if self.drafter is not None:
                    self.drafter.sync(i, new_len, [int(proposals[i, -1])] if a == k else [])
        self.stats["decode_tokens"] += emitted_total
        self.spec_stats["rounds"] += 1
        self.spec_stats["emitted"] += emitted_total
        rate = round_accepted / max(k * len(live), 1)
        self._accept_ema = rate if probe else 0.8 * self._accept_ema + 0.2 * rate
        return len(live)
