"""Batched speculative verification: score all k draft tokens in one call.

Port of ``repro.serve.spec.verify``.  The verifier is the truth path: one
``apply_lm`` call a round feeds ``[x0, d1, ..., dk]`` (``T = k + 1``) at each
row's current length, so position ``j``'s logits are the model's next-token
distribution after the prefix through ``d_j``.  Greedy accept-prefix makes
the output token-identical to plain greedy decode: ``argmax(logits[:, 0])``
is the token plain decode emits after ``x0``; if it equals ``d1``, position
1's logits are what plain decode computes next, and so on by induction; the
first mismatch emits the verifier's own argmax and the rest is rolled back;
full acceptance emits a free bonus token from the last position.  The call
also writes K/V for every scored position, so the accepted prefix's cache
entries are the verify runtime's whatever the drafter wrote.  The engine
unwinds rejected positions with ``PagedKVCache.rollback`` (lens only: the
request's reservation stays owned).

The paged read at ``T = k + 1`` takes the gathered view and ``_sdpa``, as in
the reference (the decode kernel reads ``T == 1`` only).  Rows that are not
live ride as they ride in the plain tick: token 0 at position 0, their
tables trash.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import apply_lm

__all__ = ["make_verify_step", "accept_prefix"]


def make_verify_step(arch, rt):
    """The verify step ``(params, tokens (B, T), pools, bt, start (B,), live
    (B,) bool) -> (argmax (B, T) int32, top-2 margins (B, T) fp32)`` as
    numpy, writing the pools in place.

    ``rt`` is the verify runtime, the engine's own precision, never the
    drafter's; its argmaxes define acceptance.  MoE stacks: expert capacity
    is chunk-local (it is sized from the call's token count), so a ``T = k +
    1`` call could drop other tokens than ``k + 1`` single-token steps; for
    an arch with MoE stacks the verify therefore runs ``T = 1`` steps, the
    same arithmetic as plain decode, with the rows that are not live at
    token 0 and position 0 in every step as the plain tick feeds them."""
    moe_arch = any(s.kind == "moe" for s in arch.stacks)

    def score(logits):
        lf = logits.to(torch.float32)
        top2 = torch.topk(lf, 2, dim=-1).values
        return torch.argmax(lf, dim=-1).to(torch.int32), top2[..., 0] - top2[..., 1]

    def verify(params, tokens, pools, bt, start, live):
        cache = {**pools, "_paged": {"bt": bt}}
        if moe_arch:
            zero = torch.zeros_like(start)
            am, mg = [], []
            for j in range(tokens.shape[1]):
                pos = torch.where(live, start + j, zero)
                logits, _ = apply_lm(params, arch, tokens=tokens[:, j:j + 1], cache=cache,
                                     start_pos=pos, rt=rt)
                a, m = score(logits[:, 0])
                am.append(a)
                mg.append(m)
            am, mg = torch.stack(am, 1), torch.stack(mg, 1)
        else:
            logits, _ = apply_lm(params, arch, tokens=tokens, cache=cache, start_pos=start, rt=rt)
            am, mg = score(logits)
        return am.cpu().numpy(), mg.cpu().numpy()

    return verify


def accept_prefix(draft_tokens, verify_argmax) -> tuple[int, list[int]]:
    """Greedy accept-prefix for one row: ``draft_tokens (k,)`` against
    ``verify_argmax (k + 1,)``.  Returns ``(a, emitted)``: ``a`` accepted
    draft tokens and ``emitted = draft[:a] + [verify_argmax[a]]`` (the
    correction on the first mismatch, the bonus on full acceptance) — the
    next ``a + 1`` tokens of plain greedy decode."""
    a = 0
    k = len(draft_tokens)
    while a < k and int(draft_tokens[a]) == int(verify_argmax[a]):
        a += 1
    return a, [int(t) for t in draft_tokens[:a]] + [int(verify_argmax[a])]
