"""Paged serving engine: continuous batching over block-table KV pools.

Port of ``repro.serve.engine`` for the paged engine's per-tick greedy path:
scheduler-driven continuous batching (``serve/scheduler.py``), chunked
prefill of each admitted request on an isolated one-row view of the block
tables and of the per-slot recurrent leaves (zeroed at admission), and a
full-batch decode step per tick whose dead rows write into the trash block
(their recurrent rows advance and are zeroed on the slot's next admission).
The forward runs eagerly; the pools and recurrent leaves are updated in
place.

``deploy_params`` swaps trained A2Q params for int8 weights + per-channel
scales — the artifact whose l1 norms provably fit the target accumulator —
and ``Runtime(int_forward=True, decode_kernel=True)`` serves it through the
fused W8A8 kernel and the paged-attention kernel (for MLA models with
``mla_absorb=True`` too, through the MLA latent-attention kernel);
``Runtime(int_chain=True)`` folds every act-quant into the W8A8 kernel's
prologue.  ``kv_quant=True`` keeps the KV pools as int8 codes, or with
``kv_bits=4`` packed int4, beside fp32 scale pools.

The engine keeps the reference's ``stats`` = {prefill_tokens, decode_tokens,
prefill_s, decode_s, decode_dispatches} and ``throughput()`` contract (first
generated token booked under prefill).  Not ported yet: the contiguous
``ServeEngine``, the decode megastep (``decode_steps > 1``), lockstep
admission, prefix sharing, disaggregated handoff, non-greedy sampling and
the observability bundle.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.models.lm import Runtime, apply_lm
from repro_torch.nn.linear import deploy_linear
from repro_torch.nn.transformer import COMPUTE_DTYPES
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.sampling import SampleConfig, sample_tokens
from repro_torch.serve.scheduler import Scheduler, ServeRequest

__all__ = ["PagedServeEngine", "Request", "deploy_params", "parity_up_to_ties"]

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
        "decode_dispatches": 0,
    }


def _greedy_margin(logits: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


class PagedServeEngine:
    """Paged-KV serving engine: scheduler-driven continuous batching, chunked
    prefill on isolated one-row views, greedy on-device sampling (only token
    ids and greedy margins reach the host).

    ``params`` must already live on ``device`` (default ``"cuda"``; a CUDA
    device without a usable card raises).  ``num_blocks`` bounds KV memory
    (default: every slot at ``max_seq``); admission stalls, never crashes,
    when blocks run out.  ``kv_quant`` stores the KV pools as integer codes
    (``kv_bits`` 8, or 4 packed two a byte) with per-slot fp32 scales.  The KV
    pools are updated in place."""

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
        bos_id: int = 0,
        eos_id: Optional[int] = None,
        decode_steps: int = 1,
        kv_quant: bool = False,
        kv_bits: int = 8,
        device="cuda",
    ):
        if decode_steps != 1:
            raise NotImplementedError("the decode megastep (decode_steps > 1) is not ported yet")
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.arch = arch
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.rt = rt or Runtime()
        self.sample_cfg = sample or SampleConfig()
        if not self.sample_cfg.greedy:
            raise NotImplementedError(f"{self.sample_cfg.method} sampling is not ported yet")
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.cache = PagedKVCache(
            arch, batch, block_size=block_size, num_blocks=num_blocks, max_seq=max_seq,
            dtype=COMPUTE_DTYPES[arch.compute_dtype], device=self.device, kv_quant=kv_quant,
            kv_bits=kv_bits,
        )
        self.sched = Scheduler(batch, prefill_chunk=prefill_chunk)
        self.stats = _fresh_stats()
        self.last_requests: list = []

    # -- stats contract -------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the throughput counters and the cache's counters together."""
        self.stats = _fresh_stats()
        self.cache.reset_counters()

    def throughput(self) -> dict:
        """Derived tok/s split (prefill vs decode) from ``stats``."""
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

    # -- steps (sampling on device: only ids and margins reach the host) ------

    def _forward(self, tokens: torch.Tensor, pools: dict, bt: torch.Tensor, start, last: int):
        cache = {**pools, "_paged": {"bt": bt}}
        logits, _ = apply_lm(self.params, self.arch, tokens=tokens, cache=cache,
                             start_pos=start, rt=self.rt)
        row = logits[:, last]
        tok = sample_tokens(row, self.sample_cfg)
        return tok.cpu().numpy(), _greedy_margin(row).cpu().numpy()

    def _prefill_fn(self, tokens: torch.Tensor, pools: dict, bt: torch.Tensor, start: int):
        return self._forward(tokens, pools, bt, start, -1)

    def _decode_fn(self, tokens: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor):
        return self._forward(tokens, self.cache.pools, bt, pos, 0)

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request) -> None:
        req.prompt = _normalize_prompt(req.prompt, self.bos_id)
        if req.eos_id is None:
            req.eos_id = self.eos_id
        total = len(req.prompt) + req.max_new
        if total > self.max_seq:
            raise ValueError(f"request needs {total} positions > max_seq={self.max_seq}")
        if self.cache.blocks_needed(total) > self.cache.num_blocks - 1:
            raise ValueError("request exceeds the paged cache's total block budget")
        self.sched.submit(req)

    def _admission_gate(self):
        """Round-local block budget: each admitted request reserves its
        worst-case blocks against the same free pool, so one round never
        over-commits what ``allocate`` will hand out."""
        budget = self.cache.free_blocks

        def can_admit(req: Request) -> bool:
            nonlocal budget
            need = self.cache.blocks_needed(len(req.prompt) + req.max_new)
            if need > budget:
                return False
            budget -= need
            return True

        return can_admit

    def _admit(self, slot: int, req: Request) -> None:
        """Isolated chunked prefill: whole prompt chunks through a one-row
        view of this slot's block table and recurrent leaves (zeroed first) —
        other live rows are never touched."""
        self.cache.reset_slot(slot)
        self.cache.allocate(slot, len(req.prompt) + req.max_new)
        t0 = time.perf_counter()
        bt = self.cache.bt_row(slot)
        pools = self.cache.slice_slot(slot)
        tok = marg = None
        for chunk, start in self.sched.prefill_plan(slot):
            tokens = torch.as_tensor(chunk[None, :], device=self.device)
            tok, marg = self._prefill_fn(tokens, pools, bt, start)
        self.cache.lens[slot] = len(req.prompt)
        req.margins.append(float(marg[0]))
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += len(req.prompt)
        if self.sched.record_token(slot, int(tok[0])):
            self.cache.release(slot)

    def tick(self) -> int:
        """One decode step for every live slot (dead rows ride along writing
        into the trash block); returns the number of live slots advanced."""
        live = self.sched.live
        if not live:
            return 0
        tok_in = np.zeros((self.batch, 1), np.int32)
        for i in live:
            tok_in[i, 0] = self.sched.slots[i].last_token
        t0 = time.perf_counter()
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
                self.cache.release(i)
        return len(live)

    def step(self) -> int:
        """Admit what fits, then advance one decode tick."""
        admitted = self.sched.admissions(self._admission_gate())
        for slot, req in admitted:
            self._admit(slot, req)
        n = self.tick()
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
