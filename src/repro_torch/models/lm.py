"""Model assembly: embeddings or frames -> stacks -> final norm -> head.

Port of ``repro.models.lm`` for token decoders (``family="lm"``) whose stacks
are ``attn_mlp`` (GQA or MLA), ``moe``, ``rwkv6`` (reads no positions) or
``hymba`` blocks; for the vision-language family (``family="vlm"``,
llava-next): the ``lm`` tree, precomputed patch embeddings prepended to the
token embeddings (the anyres tiling frontend is a stub in the reference
too); and for audio encoders (``family="audio"``, hubert): no token
embedding, precomputed frame embeddings in (the conv feature frontend is a
stub in the reference too), a boundary ``head`` of ``n_classes`` over every
frame.  On a mesh bound to a world's ranks (``Runtime(mesh=...)``,
``dist.sharding.Mesh.over_ranks``) the forward runs sharded on DTensors,
with the reference's four activation constraints (``constrain``: the
embeddings and every stack's output on ``rt.batch_spec``, the logits'
vocab on its TP axes).  ``lm_loss`` is the training loss of every family:
the token decoders (``attn_mlp``, ``moe``, ``rwkv6`` and ``hymba`` stacks,
deepseek-v3's multi-token-prediction head), llava's patches ahead of its
text and hubert's framewise classes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, StackConfig
from repro_torch.dist.sharding import constrain, sharded_scope
from repro_torch.nn.embedding import apply_embedding, init_embedding
from repro_torch.nn.linear import (
    _quant_weights,
    apply_linear,
    chain_report_scope,
    init_linear,
    linear_penalty,
)
from repro_torch.nn.module import tree_to
from repro_torch.nn.norms import apply_norm, init_norm
from repro_torch.nn.transformer import (
    COMPUTE_DTYPES,
    apply_stack,
    init_stack,
    init_stack_cache,
    tree_a2q_penalty,
)

__all__ = ["Runtime", "init_lm", "init_cache", "apply_lm", "lm_loss", "a2q_penalty_of"]


class Runtime:
    """Execution switches threaded through the model.

    ``decode_kernel`` routes paged-attention decode reads through the
    paged-attention kernels instead of the gathered-view ``_sdpa``.
    ``mla_absorb`` folds MLA's up-projection into the query and output of
    every cached step, so attention runs in latent space (and, with
    ``decode_kernel``, a decode read goes through the MLA latent kernel).
    ``int_forward`` routes deployed (``q8``/``s8``) linears through the fused
    W8A8 integer kernel instead of dequant + a ``compute_dtype`` matmul.
    ``int_chain`` (implies ``int_forward``) folds every deployed linear's
    act-quant into the kernel's quantizing prologue, so none pays a
    standalone act-quant.  ``chain_report`` holds the per-call dispositions of
    the last forward (see ``nn.linear.chain_report_scope``).

    ``mesh`` (``dist.sharding.Mesh``), ``ep_axis``, ``rules``
    (``dist.sharding.ShardingRules``) and ``grad_compress``
    (``dist.collectives.GradCompressConfig``) are the reference's
    distribution context.  A mesh bound to a world's ranks runs the model
    sharded (``constrain`` pins the activations by ``rules``; ``ep_axis``, a
    mesh axis or a tuple of them, runs the MoE experts expert-parallel);
    ``build_train_step`` reduces the data-parallel gradients through the
    int-quantized wire when the mesh has a data axis of more than one
    position."""

    def __init__(self, decode_kernel: bool = False, int_forward: bool = False,
                 int_chain: bool = False, mla_absorb: bool = False, mesh=None, rules=None,
                 grad_compress=None, ep_axis=None):
        self.mesh = mesh
        self.ep_axis = ep_axis
        self.rules = rules
        self.grad_compress = grad_compress
        self.mla_absorb = mla_absorb
        self.decode_kernel = decode_kernel
        self.int_forward = int_forward or int_chain
        self.int_chain = int_chain
        self.chain_report: dict = {}

    def batch_spec(self, ndim: int) -> tuple:
        """An activation's spec: the batch dim on the rules' batch axes, the
        rest replicated (``()`` without rules)."""
        if self.rules is None:
            return ()
        return (self.rules.rules.get("batch") or None,) + (None,) * (ndim - 1)


def init_lm(gen: torch.Generator, arch: ArchConfig, device="cuda") -> dict:
    """Parameters of ``arch`` drawn from ``gen`` (on the generator's device)
    and placed on ``device`` — the reference's tree: ``embed`` (not for
    audio), ``stacks`` (leaves stacked ``(count, ...)``), ``final_norm``,
    ``head`` when untied (audio: ``d_model -> n_classes``), and ``mtp`` when
    ``arch.mtp_depth > 0`` (the multi-token-prediction head of the training
    loss; serving never reads it)."""
    if arch.family not in ("lm", "vlm", "audio"):
        raise NotImplementedError(f"model family {arch.family!r} is not ported yet")
    dev = resolve_device(device)
    params: dict = {}
    if arch.family != "audio":
        params["embed"] = init_embedding(gen, arch.vocab, arch.d_model)
    params["stacks"] = {str(i): init_stack(gen, arch, s) for i, s in enumerate(arch.stacks)}
    params["final_norm"] = init_norm(arch.d_model, arch.norm, device=gen.device)
    if arch.family == "audio":
        params["head"] = init_linear(gen, arch.d_model, arch.n_classes, arch.quant,
                                     boundary=True)
    elif not arch.tie_embeddings:
        params["head"] = init_linear(gen, arch.d_model, arch.vocab, arch.quant, boundary=True)
    if arch.mtp_depth > 0:
        params["mtp"] = {
            "proj": init_linear(gen, 2 * arch.d_model, arch.d_model, arch.quant),
            "block": init_stack(gen, arch, _mtp_stackcfg(arch)),
            "norm_h": init_norm(arch.d_model, arch.norm, device=gen.device),
            "norm_e": init_norm(arch.d_model, arch.norm, device=gen.device),
        }
    return tree_to(params, dev)


def _mtp_stackcfg(arch: ArchConfig) -> StackConfig:
    """The MTP head's one block: the last stack's attention, a gated MLP of
    its ``d_ff`` (``4 * d_model`` when it has none, as a MoE stack)."""
    last = arch.stacks[-1]
    return StackConfig(kind="attn_mlp", count=1, attn=last.attn,
                       d_ff=last.d_ff or arch.d_model * 4, mlp_gated=True)


def _head_logits(params, arch: ArchConfig, h: torch.Tensor, rt: Runtime) -> torch.Tensor:
    cd = COMPUTE_DTYPES[arch.compute_dtype]
    if arch.tie_embeddings and arch.family != "audio":
        logits = torch.matmul(h.to(cd), params["embed"]["table"].to(cd).T)
    else:
        logits = apply_linear(params["head"], h, arch.quant, boundary=True, compute_dtype=cd,
                              int_forward=rt.int_forward, int_chain=rt.int_chain, site="head")
    if rt.mesh is not None and rt.mesh.spmd:
        batch = rt.rules.rules.get("batch") or ()
        # the vocab's axes but those carrying the batch (tp_extra may widen
        # vocab onto 'data', which may also be the batch axis)
        vocab = tuple(a for a in (rt.rules.rules.get("vocab") or ()) if a not in batch)
        vspec = vocab[0] if len(vocab) == 1 else (vocab or None)
        bspec = batch or None
        if arch.family != "audio" and vocab and \
                arch.vocab % math.prod(rt.mesh.shape[a] for a in vocab) == 0:
            logits = constrain(logits, rt.mesh, (bspec, None, vspec))
        else:
            logits = constrain(logits, rt.mesh, (bspec, None, None))
    return logits


def _whole_rows(logits: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Sharded logits with every row's classes on each rank (the batch
    stays split): the cross entropy gathers each row's target class."""
    if rt.mesh is None or not rt.mesh.spmd:
        return logits
    return constrain(logits, rt.mesh, rt.batch_spec(logits.dim()))


def init_cache(arch: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Contiguous decode caches of every stack on ``device``, keyed like
    ``params["stacks"]`` (``nn.transformer.init_stack_cache``)."""
    return {str(i): init_stack_cache(arch, s, batch, max_seq, dtype, device)
            for i, s in enumerate(arch.stacks)}


def apply_lm(
    params: dict,
    arch: ArchConfig,
    *,
    tokens: Optional[torch.Tensor] = None,
    frontend_embeds: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    start_pos=None,
    rt: Optional[Runtime] = None,
    return_hidden: bool = False,
):
    """Forward pass over ``tokens (B, T)``, precomputed ``frontend_embeds
    (B, S, d_model)`` (hubert's frames), or both (llava's patches: the
    embeddings first, then the tokens', along the sequence).  ``cache`` given => a cached step
    (``T == 1`` decode or ``T > 1`` chunked prefill) written at each row's
    ``start_pos`` (an int or a ``(B,)`` tensor): over a contiguous cache
    (``init_cache``), or over paged pools, when the cache carries its
    block-table view under the reserved key ``"_paged"``.  The caches, the
    pools and the per-row leaves (rings, rwkv6's ``tm.S``, ``tm.shift``,
    ``cm.shift``) are updated in place; the returned cache holds the
    per-stack leaves without the view.

    Returns ``(logits, new_cache)``, and with ``return_hidden`` also the
    post-``final_norm`` hidden states ``(B, S, d_model)`` (the MTP head's
    input).  The reference's third output, the A2Q penalty, depends on the
    params alone: ``a2q_penalty_of(params, arch)`` computes it (``lm_loss``
    adds it to the task loss)."""
    rt = rt or Runtime()
    with sharded_scope(rt.mesh):
        return _apply_lm(params, arch, tokens, frontend_embeds, cache, start_pos, rt,
                         return_hidden)


def _apply_lm(params, arch, tokens, frontend_embeds, cache, start_pos, rt, return_hidden):
    cd = COMPUTE_DTYPES[arch.compute_dtype]
    parts = []
    if frontend_embeds is not None:
        parts.append(frontend_embeds.to(cd))
    if tokens is not None:
        parts.append(apply_embedding(params["embed"], tokens, dtype=cd))
    if not parts:
        raise ValueError("apply_lm needs tokens or frontend_embeds")
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    x = constrain(x, rt.mesh, rt.batch_spec(3))
    B, S, _ = x.shape
    dev = x.device
    steps = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    if cache is not None:
        if start_pos is None:
            raise ValueError("a cached step needs start_pos")
        sp = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1)
        base = sp[:, None] if sp.shape[0] == B else sp.reshape(1, 1)
        positions = (base + steps).expand(B, S)
    else:
        positions = steps.expand(B, S)
    view = cache.get("_paged") if cache is not None else None
    with contextlib.ExitStack() as scope:
        if rt.int_forward:
            scope.enter_context(chain_report_scope(rt.chain_report))
        for i, s in enumerate(arch.stacks):
            sc = cache.get(str(i)) if cache is not None else None
            x = apply_stack(params["stacks"][str(i)], x, arch, s, positions, sc,
                            mla_absorb=rt.mla_absorb, view=view,
                            decode_kernel=rt.decode_kernel, int_forward=rt.int_forward,
                            int_chain=rt.int_chain, mesh=rt.mesh, ep_axis=rt.ep_axis)
            x = constrain(x, rt.mesh, rt.batch_spec(3))
        h = apply_norm(params["final_norm"], x, kind=arch.norm, eps=arch.norm_eps)
        logits = _head_logits(params, arch, h, rt)
    out_cache = None if cache is None else {k: v for k, v in cache.items() if k != "_paged"}
    return (logits, out_cache, h) if return_hidden else (logits, out_cache)


def a2q_penalty_of(params: dict, arch: ArchConfig) -> torch.Tensor:
    """The A2Q regularizer ``L_reg`` of a model: every stack's
    ``tree_a2q_penalty`` (its layers summed) plus the untied head's — the sum
    the reference's ``apply_lm`` accumulates through its scan (each term
    depends only on a layer's ``t`` and ``d``)."""
    penalty = torch.zeros((), dtype=torch.float32)
    for i in range(len(arch.stacks)):
        penalty = penalty + tree_a2q_penalty(params["stacks"][str(i)], arch.quant)
    if "head" in params:
        penalty = penalty + linear_penalty(params["head"], arch.quant, True, True)
    return penalty


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor, z_loss: float = 1e-4):
    """Mean CE over all positions, fp32, with MaxText-style z-loss.  The
    targets cover every position (the reference's gather refuses others)."""
    if tuple(targets.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"targets {tuple(targets.shape)} do not cover the logits' positions "
                         f"{tuple(logits.shape[:-1])}")
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    zl = z_loss * torch.square(lse).mean()
    return ce + zl, ce


def lm_loss(params: dict, arch: ArchConfig, batch: dict, rt: Optional[Runtime] = None):
    """Training loss ``task CE (+ z-loss) [+ 0.3 * MTP CE] + reg_lambda *
    L_reg`` and its metrics ``{"ce", "penalty", "loss"[, "mtp_ce"]}``, as
    ``repro.models.lm.lm_loss`` computes them.  ``batch`` = ``{tokens
    [, frontend_embeds], targets}`` with targets aligned to the *whole*
    (frontend + text) sequence: llava's patch positions take targets too,
    hubert's (no tokens) are its frames' classes.

    With an ``mtp`` subtree (deepseek-v3) the DeepSeek-style head predicts
    ``targets[t + 1]`` from ``h[t]`` fused with the embedding of
    ``targets[t]``: both normed, concatenated, projected by ``mtp.proj``,
    through one ``attn_mlp`` block (``_mtp_stackcfg``) and the model's head
    with no final norm; ``mtp_ce`` is that CE with its z-loss.  The MTP
    block's A2Q penalty joins the loss but not ``metrics["penalty"]``, and
    ``mtp.proj`` is left unpenalized, both as in the reference
    (``apply_a2q`` still clamps its ``t`` at the cap, so its accumulator
    guarantee holds)."""
    rt = rt or Runtime()
    with sharded_scope(rt.mesh):
        return _lm_loss(params, arch, batch, rt)


def _lm_loss(params, arch, batch, rt):
    penalty = a2q_penalty_of(params, arch)
    mtp_on = arch.mtp_depth > 0 and "mtp" in params
    if "head" in params and arch.quant.mode != "none":
        # the untied head's fake-quant weight (vocab x d_model: 1.03 G values
        # at llama4-scout's width), computed once for both heads with an MTP
        # head; when autograd records, under checkpoint: the backward keeps
        # only the matmul's compute-dtype copy and recomputes the rest (about
        # five fp32 copies) when it reaches the head
        recorded = torch.is_grad_enabled() and any(
            t.requires_grad for t in params["head"].values() if torch.is_tensor(t))
        if mtp_on or recorded:
            head = {k: v for k, v in params["head"].items() if k in ("aq", "b")}
            args = (params["head"], arch.quant, True, True)
            head["fq"] = checkpoint(_quant_weights, *args, use_reentrant=False) if recorded \
                else _quant_weights(*args)
            params = {**params, "head": head}
    logits, _, h = apply_lm(params, arch, tokens=batch.get("tokens"),
                            frontend_embeds=batch.get("frontend_embeds"), rt=rt,
                            return_hidden=True)
    targets = batch["targets"]
    loss, ce = _cross_entropy(_whole_rows(logits, rt), targets)
    metrics = {"ce": ce, "penalty": penalty}
    if mtp_on:
        cd = COMPUTE_DTYPES[arch.compute_dtype]
        mtp = params["mtp"]
        emb_next = apply_embedding(params["embed"], targets[:, :-1], dtype=cd)
        fused = torch.cat([apply_norm(mtp["norm_h"], h[:, :-1], kind=arch.norm),
                           apply_norm(mtp["norm_e"], emb_next, kind=arch.norm)], dim=-1)
        hm = apply_linear(mtp["proj"], fused, arch.quant, compute_dtype=cd)
        B, S, _ = hm.shape
        pos = torch.arange(S, dtype=torch.int32, device=hm.device)[None, :].expand(B, S)
        hm = apply_stack(mtp["block"], hm, arch, _mtp_stackcfg(arch), pos)
        mtp_loss, _ = _cross_entropy(_whole_rows(_head_logits(params, arch, hm, rt), rt),
                                     targets[:, 1:])
        loss = loss + 0.3 * mtp_loss
        penalty = penalty + tree_a2q_penalty(mtp["block"], arch.quant)
        metrics["mtp_ce"] = mtp_loss
    loss = loss + arch.quant.reg_lambda * penalty
    metrics["loss"] = loss
    return loss, metrics
