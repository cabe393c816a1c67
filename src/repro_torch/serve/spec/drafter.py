"""Drafters: propose k tokens a sequence a speculative round.

Port of ``repro.serve.spec.drafter``.  Two drafters, one contract (the
verifier makes the output lossless, so a drafter only moves speed, through
its acceptance rate and its own cost):

* :class:`SelfDrafter` — precision-staged self-drafting: the engine's own
  params under a cheaper runtime (``int_forward=True``: the fused W8A8
  ``int_matmul`` on deployed weights; with ``decode_kernel`` the draft reads
  go through the paged-attention kernel), on the engine's own paged cache.
  Draft writes land at positions the verify overwrites, so the drafter
  keeps no cache state.  k ``T = 1`` steps, each proposal fed to the next
  step on the device, one read-back of the ``(B, k)`` proposals (the
  reference runs them as one ``lax.scan`` dispatch; here they run eagerly).
* :class:`ModelDrafter` — a small draft model with its own params and its
  own ``PagedKVCache``.  After each round the engine calls :meth:`sync`
  with the accepted length (a lens-only rollback of the draft cache) and
  the accepted tokens the drafter has not consumed yet (the full-acceptance
  bonus case), which the next round feeds first.  Vocabularies must match
  and the draft arch must be fully paged.

Both draft greedily (argmax, never a sample).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.lm import Runtime, apply_lm
from repro_torch.nn.transformer import COMPUTE_DTYPES

__all__ = ["SelfDrafter", "ModelDrafter"]


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


class SelfDrafter:
    """Draft with the engine's own params and cache under a draft runtime."""

    def __init__(self, arch, rt: Runtime):
        self.arch = arch
        self.rt = rt

    # -- lifecycle hooks (no state of its own) --------------------------------

    def admit(self, slot: int, prompt, max_new: int) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def sync(self, slot: int, accepted_len: int, pending) -> None:
        pass

    # -- drafting ---------------------------------------------------------------

    def propose(self, engine, live, tok_in: np.ndarray, k: int) -> np.ndarray:
        """k greedy draft tokens a row ``(B, k)``, writing draft-runtime K/V
        into the engine's pools at ``[lens, lens + k)`` (the verify
        overwrites all of it).  Rows not in ``live`` ride as in the plain
        tick: token 0 at position 0, into the trash block."""
        cache, dev = engine.cache, engine.device
        is_live = np.zeros((engine.batch,), bool)
        is_live[live] = True
        act = torch.as_tensor(is_live, device=dev)
        tok = torch.as_tensor(tok_in, device=dev)
        pos = torch.as_tensor(np.where(is_live, cache.lens, 0), device=dev)
        view = {**cache.pools, "_paged": {"bt": cache.bt()}}
        zero = torch.zeros_like(tok)
        toks = []
        for _ in range(k):
            logits, _ = apply_lm(engine.params, self.arch, tokens=tok[:, None], cache=view,
                                 start_pos=pos, rt=self.rt)
            tok = torch.where(act, _argmax(logits[:, 0]), zero)
            toks.append(tok)
            pos = torch.where(act, pos + 1, pos)
        return torch.stack(toks, 1).cpu().numpy()


class ModelDrafter:
    """A separate small draft model with its own params and paged cache."""

    def __init__(
        self,
        arch,
        params,
        *,
        slots: int,
        max_seq: int,
        spec_k: int,
        block_size: int = 16,
        prefill_chunk: int = 32,
        rt: Optional[Runtime] = None,
        device="cuda",
    ):
        from repro_torch import resolve_device
        from repro_torch.serve.paged_cache import PagedKVCache

        self.arch = arch
        self.params = params
        self.rt = rt or Runtime()
        self.spec_k = spec_k
        self.prefill_chunk = prefill_chunk
        self.device = resolve_device(device)
        self.cache = PagedKVCache(
            arch, slots, block_size=block_size, max_seq=max_seq,
            dtype=COMPUTE_DTYPES[arch.compute_dtype],
            device=self.device,
        )
        if not self.cache.fully_paged:
            raise ValueError("ModelDrafter needs a fully paged draft arch (no ring/recurrent "
                             f"state to roll back), got {arch.name}")
        self.pending: list[list[int]] = [[] for _ in range(slots)]

    def _forward(self, tokens: torch.Tensor, pools: dict, bt: torch.Tensor, start):
        logits, _ = apply_lm(self.params, self.arch, tokens=tokens,
                             cache={**pools, "_paged": {"bt": bt}}, start_pos=start, rt=self.rt)
        return logits

    # -- lifecycle --------------------------------------------------------------

    def admit(self, slot: int, prompt, max_new: int) -> None:
        """Prefill the prompt into the drafter's own cache (an isolated
        one-row view, chunked like the engine's prefill)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.cache.reset_slot(slot)
        self.cache.allocate(slot, len(prompt) + max_new + self.spec_k)
        pools, bt = self.cache.slice_slot(slot), self.cache.bt_row(slot)
        for lo in range(0, len(prompt), self.prefill_chunk):
            hi = min(lo + self.prefill_chunk, len(prompt))
            self._forward(torch.as_tensor(prompt[None, lo:hi], device=self.device), pools, bt, lo)
        self.cache.lens[slot] = len(prompt)
        self.pending[slot] = []

    def release(self, slot: int) -> None:
        self.cache.release(slot)
        self.pending[slot] = []

    def sync(self, slot: int, accepted_len: int, pending) -> None:
        """Roll the draft cache back to the accepted stream (lens only: the
        admission-time reservation stays for the request's life) and queue
        the accepted tokens it has not consumed as the next round's delta."""
        self.cache.rollback(slot, min(int(self.cache.lens[slot]), accepted_len))
        self.pending[slot] = [int(t) for t in pending]

    # -- drafting ---------------------------------------------------------------

    def propose(self, engine, live, tok_in: np.ndarray, k: int) -> np.ndarray:
        """Consume each row's pending delta (padded to the longest by
        repeating its last token: pad writes land past the row's tracked
        length, masked until overwritten), take the first proposal from each
        row's true last position, then k - 1 greedy steps.  ``(B, k)``."""
        B = self.cache.slots
        deltas = [[] for _ in range(B)]
        for i in live:
            deltas[i] = self.pending[i] + [int(tok_in[i])]
        delta_max = max((len(deltas[i]) for i in live), default=1)
        toks = np.zeros((B, delta_max), np.int32)
        idx = np.zeros((B,), np.int64)
        for i in range(B):
            d = deltas[i] or [0]
            toks[i, :len(d)] = d
            toks[i, len(d):] = d[-1]
            idx[i] = len(d) - 1
        dev = self.device
        bt = self.cache.bt()
        pos0 = torch.as_tensor(self.cache.lens, device=dev)
        idx_d = torch.as_tensor(idx, device=dev)
        logits = self._forward(torch.as_tensor(toks, device=dev), self.cache.pools, bt, pos0)
        tok = _argmax(logits[torch.arange(B, device=dev), idx_d])
        pos = pos0 + idx_d.to(pos0.dtype) + 1
        out = [tok]
        for _ in range(k - 1):
            tok = _argmax(self._forward(tok[:, None], self.cache.pools, bt, pos)[:, 0])
            out.append(tok)
            pos = pos + 1
        for i in live:
            self.cache.lens[i] += len(deltas[i]) + (k - 1)
            self.pending[i] = []
        return torch.stack(out, 1).cpu().numpy()
