"""Serving engines: continuous batching over contiguous or paged KV caches.

Port of ``repro.serve.engine``.  Two engines share the scheduler's request
type and the stats contract:

* ``ServeEngine`` — the reference's measured baseline and parity oracle: one
  contiguous ``max_seq`` cache lane a slot (a ring for sliding-window
  layers), prompts prefilled one token a forward into the slot's lane,
  logits read back to the host for the argmax and the top-2 margin every
  tick.  Recurrent stacks (rwkv6, hymba) run in lockstep: equal-length groups
  prefilled together into a cache rebuilt per group.  Eager.
* ``PagedServeEngine`` — scheduler-driven continuous batching over
  block-table pools: chunked prefill of each admitted request on an
  isolated one-row view of the block tables and of the per-slot leaves
  (rings and recurrent state, emptied at admission), and a full-batch
  decode step per tick whose dead rows write into the trash block (their
  per-slot rows advance and are emptied on the slot's next admission).
  ``lockstep=True`` admits equal-length groups into an empty engine and
  prefills them together (``_admit_group``), the scheduler's fallback
  mode.  The forward runs eagerly; the pools and per-slot leaves are
  updated in place.

``deploy_params`` swaps trained A2Q params for int8 weights + per-channel
scales — the artifact whose l1 norms provably fit the target accumulator —
and ``Runtime(int_forward=True, decode_kernel=True)`` serves it through the
fused W8A8 kernel and the paged-attention kernel (for MLA models with
``mla_absorb=True`` too, through the MLA latent-attention kernel);
``Runtime(int_chain=True)`` folds every act-quant into the W8A8 kernel's
prologue.  ``kv_quant=True`` keeps the KV pools as int8 codes, or with
``kv_bits=4`` packed int4, beside fp32 scale pools.

``decode_steps=N > 1`` fuses N decode ticks into one window (the
reference's megastep, ``_megastep_fn``): position advance and the EOS /
``max_new`` finish mask run on the device, finished rows coast in the trash
block, and the host uploads one block of inputs and reads back ``(B, N)``
tokens, margins and emitted flags once a window.  On the CPU the window
runs eagerly; on a CUDA device it is captured once per engine into a
``torch.cuda.CUDAGraph`` and every window is one replay (``_capture``).

``prefix_share=True`` (fully paged caches only) adopts the longest cached
prompt prefix from the cache's radix prompt cache at admission and resumes
prefill at the chunk-aligned offset below it; every write into a shared
block copies it first (``ensure_writable``: per prefill chunk, per tick, and
once a window over the window's span, before the window's inputs are
staged, so a captured graph sees the new tables), in place.  ``pin_prompt``
prefills a system preamble once and pins its blocks.  The speculative engine
(``serve.spec.SpecServeEngine``) subclasses ``PagedServeEngine`` through the
``_slot_tokens`` / ``_release_slot`` / ``_on_admitted`` / ``_advance``
hooks.

Both engines keep the reference's ``stats`` = {prefill_tokens,
decode_tokens, prefill_s, decode_s, decode_dispatches} and ``throughput()``
contract (first generated token booked under prefill; one decode dispatch a
tick or a window; adopted prompt tokens are not counted as prefilled), plus
``graph_replays``; the cache keeps the reference's counters
(``cache.counters()``: ``prefix_hits``, ``cow_copies`` ...).
``parity_up_to_ties`` is the reference's gate between two engines' greedy
streams.

Sampling (``PagedServeEngine(sample=..., seed=...)``): greedy by default;
temperature and top-k draw from one ``torch.Generator`` the engine owns on
its device, seeded by ``seed`` (every prefill, tick and window draws from
it, inside the captured window too; ``_capture``).  ``ServeEngine`` is
greedy, as in the reference.

Observability (``obs=``, a ``repro_torch.obs.Obs``; default untraced): the
reference's trace spans and instants around host code — ``submit``,
``admit``, ``prefill_slot``, ``decode_tick`` and ``emit`` in
``ServeEngine``; ``admit``, ``radix_lookup``, ``block_alloc``,
``prefill_chunk``, ``cow_preflight``, ``admit_group``, ``decode_tick`` and
``decode_megastep`` in ``PagedServeEngine`` (and ``prefill_handoff``,
``kv_export`` and ``kv_import`` around the disaggregated handoff) — never
inside the window the graph holds, and with no device synchronization of
their own; and the metrics contract: ``metrics_snapshot()`` folds ``stats``,
the chain report, ``cache.counters()`` (the ``migrat*`` counters included)
and the CUDA-graph captures into the registry, beside the per-request
latency histograms the scheduler records.

Prefill/decode disaggregation (``serve.cluster``): a prefill-role engine runs
a prompt on a borrowed slot and exports its KV blocks
(``prefill_handoff``); a decode-role engine queues the request with that
payload (``submit_handoff``) and ``_admit`` imports the blocks in place
instead of recomputing the prompt (``_admit_handoff``), per tick and on the
megastep alike.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.kernels.ops import launch_counts, set_launch_counts
from repro_torch.models.lm import Runtime, apply_lm, init_cache
from repro_torch.nn.linear import deploy_linear
from repro_torch.nn.transformer import COMPUTE_DTYPES
from repro_torch.obs import Obs
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.sampling import SampleConfig, sample_tokens
from repro_torch.serve.scheduler import Scheduler, ServeRequest

__all__ = ["ServeEngine", "PagedServeEngine", "Request", "deploy_params",
           "parity_up_to_ties"]

Request = ServeRequest


def deploy_params(params: dict, q: QuantConfig) -> dict:
    """Convert every quantized linear's ``(v, t, d)`` / ``(w, wq)`` into
    ``{q8, s8}`` (stacked leaves — layers, and experts ``(count, E, K, N)`` —
    one 2-D weight at a time), passing ``aq``/``b`` through.  Sound because
    A2Q guarantees the P-bit accumulator for the resulting integer
    weights."""

    def one(node, signed):
        keys = ("v", "t", "d") if "v" in node else ("w", "wq")
        w = node[keys[0]]
        lead = w.shape[:-2]
        n = int(np.prod(lead)) if lead else 1

        def layer(i):
            sub = {}
            for k in keys:
                leaf = node[k]
                if isinstance(leaf, dict):  # wq = {"log2_scale": (..., C)}
                    sub[k] = {kk: vv.reshape(n, *vv.shape[len(lead):])[i] for kk, vv in leaf.items()}
                else:
                    sub[k] = leaf.reshape(n, *leaf.shape[len(lead):])[i]
            return deploy_linear(sub, q, input_signed=signed)

        outs = [layer(i) for i in range(n)]
        out = {k: torch.stack([o[k] for o in outs]).reshape(*lead, *outs[0][k].shape)
               for k in ("q8", "s8")}
        for passthrough in ("aq", "b"):
            if passthrough in node:
                out[passthrough] = node[passthrough]
        return out

    def walk(node, path=()):
        if isinstance(node, dict):
            keys = set(node)
            if {"v", "t", "d"} <= keys or {"w", "wq"} <= keys:
                signed = not (len(path) >= 2 and path[-2] == "cm" and path[-1] == "wv")
                return one(node, signed)
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params)


def parity_up_to_ties(ref_reqs, outs_test, eps: float):
    """Token-parity bound: compare each request's generated prefix against
    the reference's and fail on any mismatch at a step where the reference's
    greedy top-2 logit margin exceeds ``eps``.  A mismatch below the margin
    is a tie within the compared paths' numerical difference, and the
    prefixes legitimately diverge from there, so comparison for that request
    stops.  With ``eps == 0`` this is exact token parity.

    ``ref_reqs`` are the reference engine's driven requests
    (``engine.last_requests``): tokens and margins index-aligned.  Returns
    ``(ok, n_ties, detail)``."""
    ties = 0
    for r, req in enumerate(ref_reqs):
        for t, (x, y) in enumerate(zip(req.generated, outs_test[r])):
            if x != y:
                if req.margins[t] > eps:
                    return False, ties, (
                        f"req {r} step {t}: {x} != {y} with reference margin "
                        f"{req.margins[t]:.4f} > eps {eps}"
                    )
                ties += 1
                break
    return True, ties, None


def _normalize_prompt(prompt, bos_id: int) -> np.ndarray:
    """Empty prompts become one BOS token (prefill needs one position)."""
    arr = np.asarray(prompt, np.int32).reshape(-1)
    if arr.size == 0:
        arr = np.asarray([bos_id], np.int32)
    return arr


def _fresh_stats() -> dict:
    return {
        "prefill_tokens": 0, "decode_tokens": 0, "prefill_s": 0.0, "decode_s": 0.0,
        "decode_dispatches": 0, "graph_replays": 0,
    }


def _greedy_margin(logits: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


class _StatsMixin:
    """The engines' shared ``stats`` and metrics contract."""

    def reset_stats(self) -> None:
        """Zero the throughput counters (after a warm-up pass, so first-call
        set-up stays out of steady-state numbers).  This is the one reset
        path: engine stats, collected spans, live metrics and (in the paged
        engine) the cache's counters clear together."""
        self.stats = _fresh_stats()
        self.obs.reset()

    def throughput(self) -> dict:
        """Derived tok/s split (prefill vs decode) from ``stats``, and the
        chain report of the last forward when the integer path runs."""
        st = self.stats
        total_s = st["prefill_s"] + st["decode_s"]
        total_tok = st["prefill_tokens"] + st["decode_tokens"]
        out = {
            **st,
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"] if st["prefill_s"] > 0 else 0.0,
            "decode_tok_s": st["decode_tokens"] / st["decode_s"] if st["decode_s"] > 0 else 0.0,
            "tok_s": total_tok / total_s if total_s > 0 else 0.0,
            "dispatches_per_token": (
                st["decode_dispatches"] / st["decode_tokens"] if st["decode_tokens"] > 0 else 0.0
            ),
        }
        if self.rt.int_forward:
            rep = self.rt.chain_report
            out["int_chain_requant_dispatches"] = len(rep.get("standalone", ()))
            out["int_chain_folded"] = len(rep.get("folded", ()))
            out["int_chain_chained"] = len(rep.get("chained", ()))
            out["int_chain_fallback"] = len(rep.get("fallback", ()))
        return out

    # -- the metrics contract ---------------------------------------------------

    def _graph_counts(self) -> dict:
        """CUDA graphs captured per step function, the port's counterpart of
        the reference's jit compile counts (``jit_cache_size{fn=...}``)."""
        return {}

    def _sync_metrics(self) -> None:
        """Fold the engine's runtime state — stats, derived throughput, chain
        report, graph captures — into the registry.  Called at snapshot time:
        nothing on the dispatch path touches a metric object (the
        per-request histograms are recorded at completion)."""
        m = self.obs.metrics
        tp = self.throughput()
        for k in ("prefill_tokens", "decode_tokens", "decode_dispatches",
                  "prefill_s", "decode_s"):
            m.counter(f"serve_{k}").set(tp[k])
        for k in ("prefill_tok_s", "decode_tok_s", "tok_s", "dispatches_per_token"):
            m.gauge(f"serve_{k}").set(tp[k])
        for k in ("int_chain_requant_dispatches", "int_chain_folded",
                  "int_chain_chained", "int_chain_fallback"):
            if k in tp:
                m.gauge(k).set(tp[k])
        for name, n in self._graph_counts().items():
            m.gauge("jit_cache_size", {"fn": name}).set(n)

    def metrics_snapshot(self) -> dict:
        """The one ``snapshot()`` contract: sync the engine's state into the
        registry and return the JSON-able view (``--metrics-json``)."""
        self._sync_metrics()
        return self.obs.metrics.snapshot()


class ServeEngine(_StatsMixin):
    """Contiguous-cache baseline: per-token prefill into the slot's lane and a
    host-side argmax every tick (the reference's parity oracle).

    ``params`` must already live on ``device`` (default ``"cuda"``; a CUDA
    device without a usable card raises).  The cache (``models.lm.init_cache``,
    rings for sliding-window layers) is written in place.  Every forward
    feeds all ``batch`` rows: rows other than the one being prefilled, and
    free rows, take token 0 at their current position, and their own next
    real token overwrites that write before it is ever attended (a free
    row's write is clamped into its lane as the reference's
    ``dynamic_update_slice`` clamps it).  Recurrent stacks advance every
    row's state on every call, so they serve in lockstep: equal-length
    groups of at most ``batch`` prompts, the cache rebuilt per group."""

    def __init__(
        self,
        arch: ArchConfig,
        params: dict,
        *,
        batch: int = 4,
        max_seq: int = 512,
        rt: Optional[Runtime] = None,
        bos_id: int = 0,
        eos_id: Optional[int] = None,
        device="cuda",
        obs: Optional[Obs] = None,
    ):
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.arch = arch
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.rt = rt or Runtime()
        self.obs = obs or Obs()
        self.bos_id = bos_id
        self.eos_id = eos_id  # default for requests that do not set their own
        self.cache = self._fresh_cache()
        self.pos = np.zeros((batch,), np.int32)  # each slot's next position
        self.slots: list[Optional[Request]] = [None] * batch
        self.recurrent = any(s.kind in ("rwkv6", "hymba") for s in arch.stacks)
        self.stats = _fresh_stats()
        self.last_requests: list = []

    def _graph_counts(self) -> dict:
        return {"decode": 0}  # eager: no graph is captured

    def _fresh_cache(self) -> dict:
        return init_cache(self.arch, self.batch, self.max_seq,
                          dtype=COMPUTE_DTYPES[self.arch.compute_dtype], device=self.device)

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One cached forward of ``tokens (B, 1)`` at every row's position;
        the ``(B, V)`` logits, on the device (read back only where a token is
        taken from them)."""
        logits, _ = apply_lm(self.params, self.arch,
                             tokens=torch.as_tensor(tokens, device=self.device),
                             cache=self.cache,
                             start_pos=torch.as_tensor(self.pos, device=self.device), rt=self.rt)
        return logits[:, 0]

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        return logits.to(torch.float32).cpu().numpy()

    def admit(self, req: Request) -> bool:
        req.prompt = _normalize_prompt(req.prompt, self.bos_id)
        if req.eos_id is None:
            req.eos_id = self.eos_id
        self.obs.trace.instant("submit", {"uid": req.uid, "prompt": len(req.prompt)})
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                with self.obs.trace.span("admit", {"uid": req.uid, "slot": i}):
                    self._prefill_slot(i, req)
                return True
        return False

    def _emit_token(self, slot: int, req: Request, logits_row: np.ndarray) -> bool:
        """Host argmax and top-2 margin of one fresh token; True (and the slot
        freed) when the request just completed (``max_new`` reached, or the
        token is its ``eos_id``)."""
        nxt = int(np.argmax(logits_row))
        top2 = np.partition(logits_row.astype(np.float32), -2)[-2:]
        req.margins.append(float(top2[1] - top2[0]))
        if not req.generated:
            req.first_token_at = time.perf_counter()
        req.generated.append(nxt)
        req.last_token = nxt
        if len(req.generated) >= req.max_new or (req.eos_id is not None and nxt == req.eos_id):
            req.done = True
            req.finished_at = time.perf_counter()
            self.slots[slot] = None
            m = self.obs.metrics
            m.counter("requests_completed").inc()
            if req.submitted_at is not None:
                m.histogram("request_latency_s").observe(req.latency)
                if req.first_token_at is not None:
                    m.histogram("request_ttft_s").observe(req.ttft)
            self.obs.trace.instant("emit", {"uid": req.uid, "tokens": len(req.generated)})
            return True
        return False

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt one token a forward into this slot's lane; the last
        step's logits give the first generated token, booked under prefill."""
        t0 = time.perf_counter()
        with self.obs.trace.span("prefill_slot", {"uid": req.uid, "tokens": len(req.prompt)}):
            self.pos[slot] = 0
            for t in req.prompt:
                tok = np.zeros((self.batch, 1), np.int32)
                tok[slot, 0] = t
                logits = self._decode(tok)
                self.pos[slot] += 1
            last = self._host(logits[slot])
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += len(req.prompt)
        self._emit_token(slot, req, last)

    def tick(self) -> int:
        """Advance every live slot one token at its own position; returns the
        number of live slots."""
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return 0
        t0 = time.perf_counter()
        with self.obs.trace.span("decode_tick", {"live": len(live)}):
            tok = np.zeros((self.batch, 1), np.int32)
            for i in live:
                tok[i, 0] = self.slots[i].last_token
            logits = self._host(self._decode(tok))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += len(live)
        self.stats["decode_dispatches"] += 1
        for i in live:
            req = self.slots[i]
            self.pos[i] += 1
            self._emit_token(i, req, logits[i])
        return len(live)

    def generate(self, prompts: list, max_new: int = 16) -> list[list[int]]:
        """Admit all, tick until drained (recurrent stacks: one lockstep
        group)."""
        reqs = [Request(uid=i, prompt=_normalize_prompt(p, self.bos_id), max_new=max_new,
                        submitted_at=time.perf_counter())
                for i, p in enumerate(prompts)]
        self.last_requests = reqs  # parity gates read tokens + margins here
        if self.recurrent:
            return self._generate_lockstep(reqs)
        pending = list(reqs)
        while pending or any(s is not None for s in self.slots):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            if self.tick() == 0 and not pending:
                break
        return [r.generated for r in reqs]

    def _generate_lockstep(self, reqs: list) -> list[list[int]]:
        """One equal-length group of at most ``batch`` prompts, prefilled
        together from a fresh cache (whatever state the previous group's
        drain left is dropped), then decoded until it drains."""
        if len(reqs) > self.batch:
            raise ValueError(f"lockstep serves one group of at most {self.batch} requests")
        lens = {len(r.prompt) for r in reqs}
        if len(lens) != 1:
            raise ValueError("recurrent stacks need equal-length prompt groups")
        for r in reqs:
            if r.eos_id is None:
                r.eos_id = self.eos_id
        T = lens.pop()
        t0 = time.perf_counter()
        self.cache = self._fresh_cache()
        self.pos[:] = 0
        for i, r in enumerate(reqs):
            self.slots[i] = r
        for t in range(T):
            tok = np.zeros((self.batch, 1), np.int32)
            for i, r in enumerate(reqs):
                tok[i, 0] = r.prompt[t]
            logits = self._decode(tok)
            self.pos[: len(reqs)] += 1
        logits = self._host(logits)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += T * len(reqs)
        for i, r in enumerate(reqs):
            self._emit_token(i, r, logits[i])
        while any(s is not None for s in self.slots):
            self.tick()
        return [r.generated for r in reqs]


class PagedServeEngine(_StatsMixin):
    """Paged-KV serving engine: scheduler-driven continuous batching, chunked
    prefill on isolated one-row views, on-device sampling (only token ids and
    greedy margins reach the host).  ``sample`` picks greedy (the default),
    temperature or top-k; the random methods draw from the engine's own
    ``torch.Generator`` on its device, seeded by ``seed``, so a run
    reproduces from ``seed`` through the same sequence of calls.

    ``params`` must already live on ``device`` (default ``"cuda"``; a CUDA
    device without a usable card raises).  ``num_blocks`` bounds KV memory
    (default: every slot at ``max_seq``); admission stalls, never crashes,
    when blocks run out.  ``lockstep=True`` admits equal-length groups into
    an empty engine and prefills them together (the scheduler's fallback
    mode); the default admits continuously.  ``kv_quant`` stores the KV pools as integer codes
    (``kv_bits`` 8, or 4 packed two a byte) with per-slot fp32 scales.  The KV
    pools are updated in place.  ``prefix_share=True`` dedups common prompt
    prefixes through the cache's radix prompt cache (refcounted,
    copy-on-write blocks); it takes effect only when ``cache.fully_paged``.

    ``decode_steps > 1`` advances the live slots ``decode_steps`` ticks a
    round in one fused window (``megastep``); 1 keeps the per-tick path.  On
    a CUDA device the window is a CUDA graph captured at the first
    ``step()``; ``graph_info`` then holds the capture's seconds, the graph
    pool's bytes and the kernel launches one window replays."""

    def __init__(
        self,
        arch: ArchConfig,
        params: dict,
        *,
        batch: int = 4,
        max_seq: int = 512,
        block_size: int = 16,
        prefill_chunk: int = 32,
        num_blocks: Optional[int] = None,
        rt: Optional[Runtime] = None,
        sample: Optional[SampleConfig] = None,
        lockstep: Optional[bool] = None,
        bos_id: int = 0,
        eos_id: Optional[int] = None,
        decode_steps: int = 1,
        kv_quant: bool = False,
        kv_bits: int = 8,
        prefix_share: bool = False,
        seed: int = 0,
        device="cuda",
        obs: Optional[Obs] = None,
    ):
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        self.decode_steps = int(decode_steps)
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.arch = arch
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.rt = rt or Runtime()
        self.obs = obs or Obs()
        self.sample_cfg = sample or SampleConfig()
        # the reference's _next_key: every prefill, tick and window draws from it
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.recurrent = any(s.kind in ("rwkv6", "hymba") for s in arch.stacks)
        self.cache = PagedKVCache(
            arch, batch, block_size=block_size, num_blocks=num_blocks, max_seq=max_seq,
            dtype=COMPUTE_DTYPES[arch.compute_dtype], device=self.device, kv_quant=kv_quant,
            kv_bits=kv_bits,
        )
        self.prefix_share = prefix_share and self.cache.fully_paged
        self.sched = Scheduler(batch, prefill_chunk=prefill_chunk, lockstep=bool(lockstep),
                               obs=self.obs)
        self.stats = _fresh_stats()
        self.last_requests: list = []
        self._graph: Optional[dict] = None  # the captured window (CUDA, decode_steps > 1)
        self._captures = 0
        self.graph_info: dict = {}
        # disaggregation: uid -> exported-KV payload awaiting adoption
        # (submit_handoff queues the request; _admit consumes the payload)
        self._handoffs: dict = {}

    def reset_stats(self) -> None:
        """Zero the throughput counters, spans, metrics and the cache's
        counters together."""
        super().reset_stats()
        self.cache.reset_counters()

    def _graph_counts(self) -> dict:
        """``megadecode``: the window's captures, 1 once ``_capture`` ran (a
        value above 1 would be a recapture, the bug class the reference's
        jit compile-count gauge catches).  Prefill and the per-tick decode
        run eagerly: 0."""
        return {"prefill": 0, "decode": 0, "megadecode": self._captures}

    def _sync_metrics(self) -> None:
        super()._sync_metrics()
        m = self.obs.metrics
        cc = self.cache.counters()
        # peak_blocks is a watermark (a fleet merge takes the max); the rest
        # are monotone event counts
        m.gauge("kv_peak_blocks").set(cc.pop("peak_blocks"))
        for k, v in cc.items():
            m.counter(f"kv_{k}").set(v)
        m.gauge("kv_free_blocks").set(self.cache.free_blocks)

    # -- steps (sampling on device: only ids and margins reach the host) ------

    def _forward(self, tokens: torch.Tensor, pools: dict, bt: torch.Tensor, start, last: int):
        cache = {**pools, "_paged": {"bt": bt}}
        logits, _ = apply_lm(self.params, self.arch, tokens=tokens, cache=cache,
                             start_pos=start, rt=self.rt)
        row = logits[:, last]
        tok = sample_tokens(row, self.sample_cfg, self._gen)
        return tok.cpu().numpy(), _greedy_margin(row).cpu().numpy()

    def _prefill_fn(self, tokens: torch.Tensor, pools: dict, bt: torch.Tensor, start: int):
        return self._forward(tokens, pools, bt, start, -1)

    def _decode_fn(self, tokens: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor):
        return self._forward(tokens, self.cache.pools, bt, pos, 0)

    def _megastep_fn(self, tok0, bt, lens, active, rem, eos):
        """``decode_steps`` decode ticks fused into one window (the
        reference's ``lax.scan``; here a Python loop, captured whole into one
        CUDA graph on the card).  All bookkeeping the per-tick path does on
        the host runs on the device instead:

        * position advance — each row's ``pos`` advances while it is active,
          and its sampled token feeds the next tick's forward without a host
          round-trip;
        * finish masking — a row goes inactive the tick it emits its ``eos``
          id (``-1`` = no EOS for that row) or exhausts ``rem`` (remaining
          ``max_new`` budget), exactly mirroring ``Scheduler.record_token``.
          Inactive rows coast: their block table is swapped for the all-trash
          table (``where(act, bt, 0)``), so their KV writes land in the trash
          block and their real cache is never touched, and they ride as the
          per-tick path's dead rows do, token 0 at position 0 — the MoE router
          sees every row, so a coasting row fed anything else could take a
          live row's expert capacity and the window would drift from the
          per-tick path.  Per-slot recurrent leaves keep advancing for
          coasting rows, harmless because ``reset_slot`` zeroes them on the
          slot's next admission.

        Returns ``(B, N)`` token ids (int32), greedy margins (fp32) and
        emitted flags: ``emitted[i, j]`` is True iff row i was active entering
        tick j; the host replays exactly those flags through
        ``record_token``, so greedy output is token-identical to the per-tick
        path."""
        tok, pos, act, remaining = tok0, lens, active, rem
        toks, margs, emitted = [], [], []
        for _ in range(self.decode_steps):
            zero = torch.zeros_like(tok)
            bte = torch.where(act[:, None], bt, torch.zeros_like(bt))
            cache = {**self.cache.pools, "_paged": {"bt": bte}}
            logits, _ = apply_lm(self.params, self.arch,
                                 tokens=torch.where(act, tok, zero)[:, None], cache=cache,
                                 start_pos=torch.where(act, pos, zero), rt=self.rt)
            row = logits[:, 0]
            nxt = sample_tokens(row, self.sample_cfg, self._gen)
            toks.append(nxt)
            margs.append(_greedy_margin(row))
            emitted.append(act)
            adv = act.to(torch.int32)
            pos = pos + adv
            remaining = remaining - adv
            act = act & (nxt != eos) & (remaining > 0)
            tok = nxt
        return torch.stack(toks, 1), torch.stack(margs, 1), torch.stack(emitted, 1)

    def _window(self, inp: torch.Tensor) -> torch.Tensor:
        """One megastep window on the packed inputs ``inp (B, 5 + MB)`` int32
        (columns: last token, length, active, remaining budget, eos id, then
        the block table), returning the packed ``(3, B, N)`` int32 outputs:
        token ids, the margins' fp32 bits, emitted flags."""
        toks, margs, emitted = self._megastep_fn(
            inp[:, 0], inp[:, 5:], inp[:, 1], inp[:, 2] != 0, inp[:, 3], inp[:, 4])
        return torch.stack([toks, margs.view(torch.int32), emitted.to(torch.int32)])

    def _capture(self) -> None:
        """Capture the megastep window into a CUDA graph, once per engine, at
        the first ``step()``: before any admission, so every row is
        inactive, every KV write lands in the trash block and the recurrent
        rows that move belong to empty slots (zeroed at admission).  One
        eager warm-up window first, on the capture's stream, fills what is
        filled at first use (kernel builds, the kept u8 column sums, library
        handles and workspaces); then the window is captured on the same
        static input buffer.  The pools, the recurrent leaves and the params
        are the tensors the graph reads and writes: every write to them is in
        place, so their addresses hold across the prefills between windows.
        The kernel wrappers count their launches at capture: those counts are
        taken back (the capture ran nothing) and each replay adds them.  A
        failed capture raises; there is no eager fallback on the card.

        Sampling: the window's ``decode_steps`` draws come from the engine's
        generator, which is registered with the graph before the capture
        (``CUDAGraph.register_generator_state``, which the PyTorch 2.11 of
        the H100 runs in PERF.md has), so each replay advances its Philox
        offset by the window's draws and every window draws fresh noise.
        The warm-up window draws from the generator too: a run
        reproduces from ``seed`` through the same sequence of calls, not bit
        for bit with the per-tick path (the reference's windows split their
        key apart from its per-tick stream as well).  Greedy windows draw
        nothing and register nothing."""
        dev = self.device
        B, MB, N = self.batch, self.cache.max_blocks_per_seq, self.decode_steps
        stage = torch.zeros((B, 5 + MB), dtype=torch.int32).pin_memory()
        host_out = torch.empty((3, B, N), dtype=torch.int32).pin_memory()
        inp = torch.zeros((B, 5 + MB), dtype=torch.int32, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._window(inp)  # warm-up: every row inactive
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # so the reserved bytes below grow by the graph's pool alone
        reserved = torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        if not self.sample_cfg.greedy:
            graph.register_generator_state(self._gen)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
            out = self._window(inp)
        torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t0
        self._captures += 1
        after = launch_counts()
        set_launch_counts(before)
        self._graph = {"graph": graph, "inp": inp, "out": out, "stage": stage,
                       "host_out": host_out,
                       "launches": {k: v - before[k] for k, v in after.items() if v != before[k]}}
        self.graph_info = {
            "capture_s": capture_s,
            "pool_bytes": torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0)
            - reserved,
            "launches": dict(self._graph["launches"]),
        }

    def _window_inputs(self, live: list) -> np.ndarray:
        """The packed window inputs (``_window``) of the ``live`` slots: last
        token, length, active, remaining ``max_new`` budget and EOS id (-1:
        none; token ids are >= 0) per row, then the block tables; every other
        row inactive."""
        inp = np.zeros((self.batch, 5 + self.cache.max_blocks_per_seq), np.int32)
        inp[:, 4] = -1
        for i in live:
            req = self.sched.slots[i]
            inp[i, :4] = (req.last_token, self.cache.lens[i], 1, req.max_new - len(req.generated))
            if req.eos_id is not None:
                inp[i, 4] = req.eos_id
        inp[:, 5:] = self.cache.tables
        return inp

    def _run_window(self, inp: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The window on the host's packed inputs: eager on the CPU; on a CUDA
        device one upload through the pinned staging tensor, one replay of
        the captured graph, one read-back.  Returns ``(B, N)`` token ids,
        margins and emitted flags as numpy (on a CUDA device views of the
        pinned read-back buffer, which the next window overwrites)."""
        if self.device.type != "cuda":
            out = self._window(torch.from_numpy(inp)).numpy()
        else:
            if self._graph is None:
                raise RuntimeError("the megastep's CUDA graph is captured at the first step(), "
                                   "before any slot is live")
            g = self._graph
            g["stage"].numpy()[...] = inp
            g["inp"].copy_(g["stage"], non_blocking=True)
            g["graph"].replay()
            g["host_out"].copy_(g["out"], non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            set_launch_counts({k: v + g["launches"][k] for k, v in launch_counts().items()
                               if k in g["launches"]})
            self.stats["graph_replays"] += 1
            out = g["host_out"].numpy()
        return out[0], out[1].view(np.float32), out[2] != 0

    # -- request lifecycle ----------------------------------------------------

    def _slot_tokens(self, req: Request) -> int:
        """Worst-case cache positions a request may write (subclasses add
        headroom: the speculative engine's rejected-draft span)."""
        return len(req.prompt) + req.max_new

    def _release_slot(self, slot: int) -> None:
        """Finished-request teardown (subclasses add drafter state)."""
        self.cache.release(slot)

    def _on_admitted(self, slot: int, req: Request) -> None:
        """Post-prefill hook for subclasses (drafter admission)."""

    def submit(self, req: Request) -> None:
        req.prompt = _normalize_prompt(req.prompt, self.bos_id)
        if req.eos_id is None:
            req.eos_id = self.eos_id
        total = self._slot_tokens(req)
        if total > self.max_seq:
            raise ValueError(f"request needs {total} positions > max_seq={self.max_seq}")
        if self.cache.blocks_needed(total) > self.cache.num_blocks - 1:
            raise ValueError("request exceeds the paged cache's total block budget")
        self.sched.submit(req)

    # -- prefill/decode disaggregation -----------------------------------------

    def can_prefill_handoff(self, req: Request) -> bool:
        """Capacity probe for a prefill-role replica: a free slot to borrow
        and enough blocks for the prompt only (decode headroom is the decode
        replica's budget)."""
        return (
            any(r is None for r in self.sched.slots)
            and self.cache.blocks_needed(len(req.prompt))
            <= self.cache.free_blocks + self.cache.reclaimable_blocks()
        )

    def prefill_handoff(self, req: Request) -> dict:
        """Prefill-role entry point of the disaggregated cluster: run the
        prompt through the isolated chunked prefill on a borrowed free slot,
        export the written KV blocks at wire width, release the slot (also
        when the prefill raised) and return the migration payload; the
        request never enters this engine's decode loop.  The payload carries
        the prefill's sampled first token and its greedy margin, so the
        decode replica adopts at the state a local admission reaches:

            {"kv": <export_blocks payload>, "first_token": int, "margin": float}
        """
        req.prompt = _normalize_prompt(req.prompt, self.bos_id)
        if req.eos_id is None:
            req.eos_id = self.eos_id
        if len(req.prompt) > self.max_seq:
            raise ValueError(f"prompt of {len(req.prompt)} tokens > max_seq={self.max_seq}")
        free = [i for i, r in enumerate(self.sched.slots) if r is None]
        if not free:
            raise RuntimeError("prefill_handoff needs a free slot")
        slot = free[0]
        tr = self.obs.trace
        self.cache.reset_slot(slot)
        self.cache.allocate(slot, len(req.prompt))
        self.sched.slots[slot] = req  # prefill_plan reads the slot binding
        try:
            with tr.span("prefill_handoff", {"uid": req.uid}):
                first, margin = self._prefill_chunks(slot, req, preflight_span=False)
                with tr.span("kv_export", {"uid": req.uid}):
                    payload = {"kv": self.cache.export_blocks(slot), "first_token": first,
                               "margin": margin}
        finally:
            self.sched.slots[slot] = None
            req.prefilled = 0  # a requeued copy must be able to prefill again
            self.cache.release(slot)
        return payload

    def submit_handoff(self, req: Request, payload: dict) -> None:
        """Decode-role entry point: queue a request whose prompt KV arrives as
        a migrated block payload.  Admission goes through the scheduler and
        the block gate (the prompt + ``max_new`` reservation), but ``_admit``
        imports the payload's blocks instead of recomputing the prompt: no
        prefill forward, decode resumes at ``len(prompt)`` with the handed-off
        first token recorded.  Geometry skew fails here, at the queue."""
        req.prompt = _normalize_prompt(req.prompt, self.bos_id)
        if req.eos_id is None:
            req.eos_id = self.eos_id
        kv = payload["kv"]
        if kv["tokens"] != len(req.prompt):
            raise ValueError(
                f"handoff payload covers {kv['tokens']} tokens, "
                f"prompt has {len(req.prompt)}"
            )
        if kv["block_size"] != self.cache.block_size:
            raise ValueError(
                f"handoff block_size {kv['block_size']} != {self.cache.block_size}"
            )
        if kv["kv_quant"] != self.cache.kv_quant or (
            kv["kv_quant"] and kv["kv_bits"] != self.cache.kv_bits
        ):
            raise ValueError(
                f"handoff kv_quant/kv_bits ({kv['kv_quant']}, {kv['kv_bits']}) do "
                f"not match this cache ({self.cache.kv_quant}, {self.cache.kv_bits})"
            )
        total = self._slot_tokens(req)
        if total > self.max_seq:
            raise ValueError(f"request needs {total} positions > max_seq={self.max_seq}")
        if self.cache.blocks_needed(total) > self.cache.num_blocks - 1:
            raise ValueError("request exceeds the paged cache's total block budget")
        self._handoffs[req.uid] = payload
        self.sched.submit(req)

    def _admit_handoff(self, slot: int, req: Request, payload: dict) -> None:
        """Adopt migrated prompt KV into a fresh slot: import the wire blocks
        in place, grow the allocation to the full decode reservation and
        record the prefill replica's first token.  No prompt forward runs:
        ``prefill_tokens`` counts no recomputed token."""
        self.cache.reset_slot(slot)
        t0 = time.perf_counter()
        with self.obs.trace.span("kv_import", {"uid": req.uid, "slot": slot}):
            self.cache.import_blocks(slot, payload["kv"])
            self.cache.allocate(slot, self._slot_tokens(req))
        req.prefilled = len(req.prompt)
        req.margins.append(float(payload["margin"]))
        if self.prefix_share:
            self.cache.register_prefix(slot, req.prompt)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self._on_admitted(slot, req)
        if self.sched.record_token(slot, int(payload["first_token"])):
            self._release_slot(slot)

    def _admission_gate(self):
        """Round-local block budget: each admitted request reserves its
        worst-case blocks against the same free pool, so one round never
        over-commits what ``allocate`` will hand out.  Adoption only lowers a
        request's fresh-block draw (a copy-on-write fault takes a block the
        sequence would otherwise allocate), and the prompt cache's evictable
        blocks count as capacity: ``allocate`` reclaims them before it
        fails."""
        budget = self.cache.free_blocks + self.cache.reclaimable_blocks()

        def can_admit(req: Request) -> bool:
            nonlocal budget
            need = self.cache.blocks_needed(self._slot_tokens(req))
            if need > budget:
                return False
            budget -= need
            return True

        return can_admit

    def _admit(self, slot: int, req: Request) -> None:
        """Isolated chunked prefill: whole prompt chunks through a one-row
        view of this slot's block table and recurrent leaves (zeroed first) —
        other live rows are never touched.  With ``prefix_share`` the longest
        cached prefix is adopted first and prefill resumes at the
        chunk-aligned offset below its length (so every chunk keeps a shape
        plain prefill has), the adopted run trimmed to the blocks covering
        ``[0, resume)``: the span ``[resume, shared)`` is recomputed to the
        same K/V, and adopting its partial block would only buy a
        copy-on-write fault.  Each chunk makes its span writable first.  A
        request queued by ``submit_handoff`` imports its migrated blocks
        instead (``_admit_handoff``)."""
        payload = self._handoffs.pop(req.uid, None)
        if payload is not None:
            return self._admit_handoff(slot, req, payload)
        tr = self.obs.trace
        with tr.span("admit", {"uid": req.uid, "slot": slot, "prompt": len(req.prompt)}):
            self.cache.reset_slot(slot)
            adopted = 0
            if self.prefix_share:
                with tr.span("radix_lookup", {"uid": req.uid}):
                    shared, blocks = self.cache.lookup_prefix(req.prompt)
                resume = (shared // self.sched.prefill_chunk) * self.sched.prefill_chunk
                if resume > 0:
                    self.cache.adopt_prefix(slot, resume,
                                            blocks[:self.cache.blocks_needed(resume)])
                    req.prefilled = adopted = resume
            with tr.span("block_alloc", {"uid": req.uid}):
                self.cache.allocate(slot, self._slot_tokens(req))
            first, margin = self._prefill_chunks(slot, req, adopted=adopted)
            if self.prefix_share:
                self.cache.register_prefix(slot, req.prompt)
            req.margins.append(margin)
            self._on_admitted(slot, req)
        if self.sched.record_token(slot, first):
            self._release_slot(slot)

    def _prefill_chunks(self, slot: int, req: Request, *, adopted: int = 0,
                        preflight_span: bool = True) -> tuple[int, float]:
        """The isolated chunked prefill of ``req``'s prompt from
        ``req.prefilled`` on, through a one-row view of ``slot``'s block
        table, each chunk's span made writable first (under a
        ``cow_preflight`` span when ``preflight_span``).  Returns the first
        token and its margin on the host: the clock of ``prefill_s`` stops
        after that read, so it covers the device's queued work.
        ``prefill_tokens`` counts the prompt less the ``adopted`` tokens that
        were never recomputed."""
        tr = self.obs.trace
        t0 = time.perf_counter()
        pools = self.cache.slice_slot(slot)
        tok = marg = None
        for chunk, start in self.sched.prefill_plan(slot):
            with tr.span("prefill_chunk", {"uid": req.uid, "start": start}):
                if preflight_span:
                    with tr.span("cow_preflight", {"uid": req.uid}):
                        self.cache.ensure_writable(slot, start, start + len(chunk))
                else:
                    self.cache.ensure_writable(slot, start, start + len(chunk))
                tokens = torch.as_tensor(chunk[None, :], device=self.device)
                tok, marg = self._prefill_fn(tokens, pools, self.cache.bt_row(slot), start)
        self.cache.lens[slot] = len(req.prompt)
        first, margin = int(tok[0]), float(marg[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += len(req.prompt) - adopted
        return first, margin

    def _admit_group(self, group: list) -> None:
        """Lockstep admission: an equal-length group prefilled together in
        one batched chunked pass over the full tables (every row shares
        every position; the engine is empty, so the other rows write into
        the trash block)."""
        L = len(group[0][1].prompt)
        if any(len(r.prompt) != L for _, r in group):
            raise ValueError("lockstep admission needs equal prompt lengths")
        toks = np.zeros((self.batch, L), np.int32)
        for slot, req in group:
            self.cache.reset_slot(slot)
            self.cache.allocate(slot, L + req.max_new)
            toks[slot] = req.prompt
            req.prefilled = L
        t0 = time.perf_counter()
        tok = marg = None
        with self.obs.trace.span("admit_group", {"requests": len(group), "prompt": L}):
            bt = self.cache.bt()
            for lo in range(0, L, self.sched.prefill_chunk):
                hi = min(lo + self.sched.prefill_chunk, L)
                with self.obs.trace.span("prefill_chunk", {"start": lo}):
                    tokens = torch.as_tensor(toks[:, lo:hi], device=self.device)
                    tok, marg = self._prefill_fn(tokens, self.cache.pools, bt, lo)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += L * len(group)
        for slot, req in group:
            self.cache.lens[slot] = L
            req.margins.append(float(marg[slot]))
            if self.sched.record_token(slot, int(tok[slot])):
                self._release_slot(slot)

    def pin_prompt(self, tokens) -> int:
        """Prefill a system preamble once and pin its full blocks in the
        radix prompt cache for good (``--pin-prompt``): never evicted, not
        counted against the node cap.  Needs an idle engine (it borrows slot
        0 for the prefill and releases it, leaving only the pins).  Returns
        the pinned tokens (full blocks only; adopters recompute the partial
        tail like any other resumed span)."""
        if not self.prefix_share:
            raise ValueError("pin_prompt requires prefix_share=True")
        tokens = _normalize_prompt(tokens, self.bos_id)
        if not self.sched.idle():
            raise RuntimeError("pin_prompt needs an idle engine (call pre-traffic)")
        if len(tokens) + 1 > self.max_seq:
            raise ValueError("pinned prompt exceeds max_seq")
        slot = 0
        self.cache.reset_slot(slot)
        self.cache.allocate(slot, len(tokens))
        pools = self.cache.slice_slot(slot)
        for lo in range(0, len(tokens), self.sched.prefill_chunk):
            hi = min(lo + self.sched.prefill_chunk, len(tokens))
            self.cache.ensure_writable(slot, lo, hi)
            self._prefill_fn(torch.as_tensor(tokens[None, lo:hi], device=self.device), pools,
                             self.cache.bt_row(slot), lo)
        self.cache.lens[slot] = len(tokens)
        self.cache.register_prefix(slot, tokens, pinned=True)
        self.cache.release(slot)
        return (len(tokens) // self.cache.block_size) * self.cache.block_size

    def tick(self) -> int:
        """One decode step for every live slot (dead rows ride along writing
        into the trash block); returns the number of live slots advanced."""
        live = self.sched.live
        if not live:
            return 0
        tr = self.obs.trace
        tok_in = np.zeros((self.batch, 1), np.int32)
        with tr.span("cow_preflight", {"live": len(live)}):
            for i in live:
                tok_in[i, 0] = self.sched.slots[i].last_token
                # a donor's decode write can land in a block a sharer adopted
                self.cache.ensure_writable(i, int(self.cache.lens[i]),
                                           int(self.cache.lens[i]) + 1)
        t0 = time.perf_counter()
        with tr.span("decode_tick", {"live": len(live)}):
            out, marg = self._decode_fn(
                torch.as_tensor(tok_in, device=self.device), self.cache.bt(),
                torch.as_tensor(self.cache.lens, device=self.device),
            )
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += len(live)
        self.stats["decode_dispatches"] += 1
        for i in live:
            self.cache.lens[i] += 1
            self.sched.slots[i].margins.append(float(marg[i]))
            if self.sched.record_token(i, int(out[i])):
                self._release_slot(i)
        return len(live)

    def megastep(self) -> int:
        """Up to ``decode_steps`` decode ticks for every live slot in ONE
        window (``_megastep_fn``; one CUDA-graph replay on the card); returns
        the number of live slots advanced.  The per-tick host work is hoisted
        to window entry: **one upload** of tokens, lengths, masks, budgets,
        EOS ids and block tables, **one read-back** of ``(B, N)`` token ids,
        margins and emitted flags.  Every write a window makes stays inside
        each slot's admission-time allocation: ``rem`` caps it at
        ``max_new``, and the final emitted token is never consumed.  The
        copy-on-write preflight makes each slot's window span ``[lens, lens +
        min(N, rem))`` writable once, before the inputs (block tables
        included) are staged.

        The host then replays the emitted flags through
        ``Scheduler.record_token`` in tick order; because the device finish
        mask mirrors ``record_token`` exactly (EOS emit or ``max_new``
        reached), a finished row's later flags are False and the replay
        releases each slot at the same tick the per-tick path would have."""
        live = self.sched.live
        if not live:
            return 0
        tr = self.obs.trace
        N = self.decode_steps
        with tr.span("cow_preflight", {"live": len(live)}):
            for i in live:
                req = self.sched.slots[i]
                lo = int(self.cache.lens[i])
                self.cache.ensure_writable(i, lo, lo + min(N, req.max_new - len(req.generated)))
        with tr.span("decode_megastep", {"live": len(live), "steps": N}):
            inp = self._window_inputs(live)
            t0 = time.perf_counter()
            out, marg, em = self._run_window(inp)
            dt = time.perf_counter() - t0
        total = 0
        for j in range(N):
            for i in live:
                if not em[i, j]:
                    continue
                total += 1
                self.cache.lens[i] += 1
                self.sched.slots[i].margins.append(float(marg[i, j]))
                if self.sched.record_token(i, int(out[i, j])):
                    self._release_slot(i)
        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += total
        self.stats["decode_dispatches"] += 1
        return len(live)

    def _advance(self) -> int:
        """One decode round (the speculative engine swaps in its draft-verify
        round here).  ``decode_steps > 1`` routes to the fused megastep; 1
        keeps the per-tick path (and its per-token parity role)."""
        if self.decode_steps > 1:
            return self.megastep()
        return self.tick()

    def step(self) -> int:
        """Admit what fits, then advance one decode round.  With
        ``decode_steps > 1`` on a CUDA device the first step captures the
        window's graph before it admits anything (``_capture``)."""
        if self.decode_steps > 1 and self.device.type == "cuda" and self._graph is None:
            self._capture()
        admitted = self.sched.admissions(self._admission_gate())
        if self.sched.lockstep:
            if admitted:
                self._admit_group(admitted)
        else:
            for slot, req in admitted:
                self._admit(slot, req)
        n = self._advance()
        if n == 0 and not admitted and self.sched.queue:
            raise RuntimeError("scheduler stalled: queued work but nothing admittable")
        return n

    def generate(self, prompts: list, max_new: int = 16) -> list[list[int]]:
        """Convenience batch API: submit all, step until drained."""
        reqs = [Request(uid=i, prompt=_normalize_prompt(p, self.bos_id), max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            self.submit(r)
        self.last_requests = reqs  # parity gates read tokens + margins here
        while not self.sched.idle():
            self.step()
        return [r.generated for r in reqs]


def _check_device(params: dict, device: torch.device) -> None:
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif node.device.type != device.type:
            raise ValueError(f"parameter {path} is on {node.device}, the engine on {device}")

    walk(params, "")
