"""Training the MoE decoders in the port against the JAX package on the CPU:
reduced deepseek-v3 (MLA, a MoE stack, the multi-token-prediction head)
and reduced llama4-scout (chunk-local and NoPE MoE layers, top-1), baseline
QAT experts, three ``sgdm`` steps, checkpoints and the launcher.

Parameters are drawn by the port's initializer and given to both packages
(numpy, the reference's layout); batches come from ``TokenStream``; both
sides compute in float32.  The loss and gradient gate is
``tests/test_torch_train.py::test_lm_loss_and_grads_match``'s (cap ties
left out and counted, misses explained by activations at a rounding tie,
at least one strict batch), with two additions for a MoE:

* routing is discrete: on every batch the two packages' router
  probabilities are read at each MoE layer (a ``jax.debug.callback`` on
  the reference's side) and each package's top-k choices and capacity
  drops derived from its own; a batch whose choices differ must show a
  near-tie (the k-th and (k+1)-th probabilities within 1e-5) and is then
  left out of the gradient comparison and counted; at least one batch
  routes identically;
* ``mtp_ce`` (the MTP head's CE with its z-loss) to rtol 1e-5 beside the
  loss and ce.

QAT experts: the max-abs calibration to 1 ulp of the reference formula on
the port's own draw, the fake-quant view and its straight-through
gradients to 1e-6 (``exp2`` of the two libraries may differ by a few
ulps), deployed codes exactly.
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _a2q_nodes, _flat, _np, _penalty_slack, _push, _tie_mask

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.base import QuantConfig as JQuantConfig
from repro.nn import moe as jmoe
from repro.nn.module import unbox
from repro.optim import optimizers as jopt
from repro.serve.engine import deploy_params as jdeploy_params
from repro.train import checkpoint as jckpt

import repro_torch.nn.moe as tmoe
from repro_torch.configs import get_arch, reduced
from repro_torch.core.bounds import int_range
from repro_torch.configs.base import QuantConfig
from repro_torch.convert import from_jax_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.lm import Runtime, apply_lm, init_lm, lm_loss
from repro_torch.models.steps import build_train_step
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.serve.engine import deploy_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

DEEPSEEK, LLAMA4 = "deepseek-v3-671b", "llama4-scout-17b-a16e"
NEAR_TIE = 1e-5  # the largest top-k gap a routing disagreement may show


@functools.cache
def _model(name):
    """(reference arch, port arch, params as numpy in the reference's
    layout), drawn by the port's initializer from seed 0 (the reference's
    takes 10-30 s a model on the CPU; both packages get these same values)."""
    arch = reduced(get_arch(name))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    return jreduced(jget_arch(name)), arch, tree_map(lambda t: t.numpy(), params)


def _routing(probs: np.ndarray, k: int, cf: float):
    """``(top-k expert ids (T, k) as sorted sets, kept (T, k))`` from one
    layer's router probabilities, in the packages' order: top-k, then a
    stable sort by expert (token order within), each expert keeping its
    first ``max(int(T * k * cf / E), 1)`` assignments."""
    T, E = probs.shape
    top = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    flat = top.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    pos = np.arange(se.size) - np.searchsorted(se, np.arange(E))[se]
    kept = np.empty(se.size, bool)
    kept[order] = pos < max(int(T * k * cf / E), 1)
    return np.sort(top, axis=1), kept.reshape(T, k)


_JREC: list = []  # what the reference's last recorded call handed out, in order


def _jax_recording(fn):
    """``fn`` jitted with the reference's ``apply_act_quant`` and
    ``_dispatch_compute_combine`` wrapped (at trace time) to hand each
    act-quant's integer codes and each MoE layer's router probabilities to
    ``_JREC`` through ordered ``jax.debug.callback`` s; ``run(*args) ->
    (fn's outputs, records)``."""
    import repro.nn.linear as jlin
    from repro.core.bounds import int_range as jint_range

    orig_aq, orig_dcc = jlin.apply_act_quant, jmoe._dispatch_compute_combine

    def aq(qp, x, bits, signed):
        n, p = jint_range(bits, signed)
        codes = jnp.clip(jnp.round(x / jnp.exp2(qp["log2_scale"].astype(x.dtype))), n, p)
        jax.debug.callback(lambda c: _JREC.append(("aq", np.asarray(c))), codes, ordered=True)
        return orig_aq(qp, x, bits, signed)

    def dcc(x2d, probs, *rest):
        jax.debug.callback(lambda p: _JREC.append(("moe", np.asarray(p))), probs, ordered=True)
        return orig_dcc(x2d, probs, *rest)

    jfn = jax.jit(fn)

    def run(*args):
        _JREC.clear()
        jlin.apply_act_quant = jmoe.apply_act_quant = aq
        jmoe._dispatch_compute_combine = dcc
        try:
            out = jax.block_until_ready(jfn(*args))
            jax.effects_barrier()
        finally:
            jlin.apply_act_quant = jmoe.apply_act_quant = orig_aq
            jmoe._dispatch_compute_combine = orig_dcc
        return out, list(_JREC)

    return run


@functools.cache
def _jax_recorder(name):
    """``jax.value_and_grad`` of the reference's ``lm_loss``, recorded
    (``_jax_recording``), with ``remat="none"`` so each forward op runs
    once: ``run(params, batch) -> (((loss, metrics), grads), records)``."""
    from repro.models.lm import lm_loss as jlm_loss

    jarch = dataclasses.replace(_model(name)[0], remat="none")
    return _jax_recording(jax.value_and_grad(lambda p, b: jlm_loss(p, jarch, b), has_aux=True))


def _port_keys(tree) -> dict:
    """``{storage address: leaf path}`` of every tensor of a port tree (the
    train step's detached copies and a stack's layer views share it)."""
    return {v.untyped_storage().data_ptr(): p for p, v in tree_leaves_with_path(tree)}


def _key(ls: torch.Tensor, by_ptr: dict):
    """An activation scale's ``(leaf path, offset in the leaf)``."""
    return by_ptr[ls.untyped_storage().data_ptr()], ls.storage_offset()


@contextlib.contextmanager
def _port_hooks(aq=None, dcc=None):
    """``apply_act_quant`` (the linears' and the MoE's) and
    ``_dispatch_compute_combine`` of the port swapped for wrappers."""
    import repro_torch.nn.linear as tlin

    orig_aq, orig_dcc = tlin.apply_act_quant, tmoe._dispatch_compute_combine
    if aq is not None:
        tlin.apply_act_quant = tmoe.apply_act_quant = aq(orig_aq)
    if dcc is not None:
        tmoe._dispatch_compute_combine = dcc(orig_dcc)
    try:
        yield
    finally:
        tlin.apply_act_quant = tmoe.apply_act_quant = orig_aq
        tmoe._dispatch_compute_combine = orig_dcc


def _codes(x, ls, bits, signed):
    n, p = int_range(bits, signed)
    return torch.clamp(torch.round(x.detach() / torch.exp2(ls.detach().to(x.dtype))), n, p)


def reference_decisions(arch, tree, batch, jrec):
    """The reference's discrete decisions on one batch (``jrec``, what
    ``_jax_recording`` recorded), keyed for the port tree ``tree``:
    ``(codes, probs, flips)`` — ``{(scale leaf path, offset): [the
    reference's integer codes, a call at a time]}`` of every activation
    quantizer of ``lm_loss``'s forward, matched call by call with the
    port's own forward (the two call them in one order), the reference's
    router probabilities of every MoE layer in order, and the number of
    codes the port's own forward rounds apart from them."""
    by_ptr, trec = _port_keys(tree), []

    def aq(orig):
        def wrapped(qp, x, bits, signed):
            trec.append(("aq", _key(qp["log2_scale"], by_ptr),
                         _codes(x, qp["log2_scale"], bits, signed)))
            return orig(qp, x, bits, signed)
        return wrapped

    with _port_hooks(aq), torch.no_grad():
        lm_loss(tree, dataclasses.replace(arch, remat="none"),
                {k: torch.as_tensor(v) for k, v in batch.items()})
    jaq = [ref for kind, ref in jrec if kind == "aq"]
    assert len(trec) == len(jaq)
    codes, flips = {}, 0
    for (_, key, mine), ref in zip(trec, jaq):
        assert tuple(mine.shape) == ref.shape, (key, mine.shape, ref.shape)
        # the head's quantizer runs twice with an MTP head
        codes.setdefault(key, []).append(torch.from_numpy(np.array(ref)))
        flips += int((mine.numpy() != ref).sum())
    return codes, [ref for kind, ref in jrec if kind == "moe"], flips


@contextlib.contextmanager
def reference_codes(codes: dict, tree):
    """The port's activation quantizers (of ``tree``'s forwards, a train
    step's included) put out the reference's codes: ``y + (q_ref - q) *
    s``, so the value is ``q_ref * s`` and the scale's straight-through
    gradient ``q_ref - x / s``, as the reference's (the input's is
    unchanged).  A quantizer's calls take its codes in turn, and a
    recomputed block's (remat) start over.  Yields ``(mags, probs)``:
    ``{scale leaf path: per-layer sum of |terms|}`` of each scale's
    gradient ``ln2 * s * Σ g_i * (q_i - x_i / s)`` (``q_i`` alone where
    clipped), filled by the backward (that sum cancels to a small part of
    its terms, so a scale's gradient is held against it), and the MoE
    layers' router probabilities of the first forward, on those codes."""
    by_ptr, calls, terms, probs = _port_keys(tree), {}, [], []

    def aq(orig):
        def wrapped(qp, x, bits, signed):
            y = orig(qp, x, bits, signed)
            ls = qp["log2_scale"]
            key = _key(ls, by_ptr)
            calls[key] = calls.get(key, -1) + 1
            ref = codes[key][calls[key] % len(codes[key])].to(x.dtype)
            s = torch.exp2(ls.to(x.dtype))
            y = y + (ref - _codes(x, ls, bits, signed)) * s
            if calls[key] < len(codes[key]) and y.requires_grad:  # not a remat recompute
                u, (n, p) = x.detach().double() / s.detach().double(), int_range(bits, signed)
                t = {"key": key, "q": torch.where((u > n) & (u < p), ref.double() - u,
                                                  ref.double()) * s.detach().double()}
                y.register_hook(lambda g, t=t: t.__setitem__("g", g.detach().double()))
                terms.append(t)
            return y
        return wrapped

    def dcc(orig):
        def wrapped(x2d, p, *rest):
            probs.append(p.detach().numpy().copy())
            return orig(x2d, p, *rest)
        return wrapped

    mags: dict = {}
    with _port_hooks(aq, dcc):
        yield mags, probs
    for t in terms:  # the backward has run
        (path, at), m = t["key"], float((t["q"] * t["g"]).abs().sum()) * np.log(2.0)
        mags.setdefault(path, {}).setdefault(at, 0.0)
        mags[path][at] += m
    for path, m in mags.items():
        mags[path] = np.array([m[i] for i in sorted(m)])


def routing_report(arch, jprobs, tprobs) -> dict:
    """``{"same": bool, "drops": int, "gap": float}`` over every MoE layer
    of one forward (the reference's router probabilities and the port's,
    the first forward's on the reference's codes); a disagreement that is
    not a near-tie fails."""
    cfgs = [s.moe for s in arch.stacks if s.kind == "moe" for _ in range(s.count)]
    assert len(jprobs) == len(cfgs) and len(tprobs) >= len(cfgs)
    same, drops, gap = True, 0, np.inf
    for cfg, jp, tp in zip(cfgs, jprobs, tprobs):
        (jt, jk), (tt, tk) = (_routing(p, cfg.top_k, cfg.capacity_factor) for p in (jp, tp))
        drops += int((~tk).sum())
        bad = np.flatnonzero((jt != tt).any(1) | (jk != tk).any(1))
        for p in (jp, tp):
            srt = -np.sort(-p, axis=1)
            g = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]
            gap = min(gap, float(g.min()))
            if bad.size:  # a differing choice must sit at a near-tie
                assert (g[bad] <= NEAR_TIE).any(), ("routing differs off a tie", bad, g[bad])
        same &= bad.size == 0
    return {"same": same, "drops": drops, "gap": gap}


def _off_grid(params):
    """A copy with the shared experts' activation scales a quarter octave
    up.  The initializer gives them the MoE's entry quantizer's scale, so
    their inputs sit exactly on their grid and their scales' gradients are
    rounding noise (~1e-10) in both packages; off the grid they carry
    signal the gate can hold."""
    out = jax.tree.map(np.copy, params)
    for stack in out["stacks"].values():
        for name in ("shared_in", "shared_gate", "shared_out"):
            if "moe" in stack and name in stack["moe"]:
                stack["moe"][name]["aq"]["log2_scale"] += np.float32(0.25)
    return out


def _off_trunc_ties(params, arch):
    """A copy with every A2Q weight whose scaled value ``g/s * v / ||v||_1``
    sits within 1e-5 of a nonzero integer moved 1e-4 of itself toward 0, so
    both packages truncate it to the integer below: their ``g/s`` and
    ``||v||_1`` differ by ulps (``log2`` of the cap, the sum's order), and
    at such a value one package truncates a code apart from the other
    (one flip in reduced llama4-scout's pushed experts).  Computed in
    float64 from the reference's formula; returns the copy and the count
    moved."""
    q, out, moved = arch.quant, jax.tree.map(np.copy, params), 0
    for path, node in _a2q_nodes(out):
        N = q.boundary_bits if path == ("head",) else q.act_bits
        signed = path[-2:] != ("cm", "wv")
        d, t, v = (node[k].astype(np.float64) for k in ("d", "t", "v"))
        T = int(signed) + np.log2(2.0 ** (q.acc_bits - 1) - 1) + d - N
        gs = np.exp2(np.minimum(t, T) - d)[..., None, :]
        x = gs * v / np.maximum(np.abs(v).sum(-2, keepdims=True), 1e-12)
        tie = (np.abs(x - np.round(x)) <= 1e-5 * np.maximum(np.abs(x), 1)) & (np.round(x) != 0)
        node["v"][tie] *= np.float32(1 - 1e-4)
        moved += int(tie.sum())
    return out, moved


def check_lm_loss_and_grads(name, pushed, seeds=(1, 2, 3), batch_fn=None):
    """``lm_loss``'s loss, ce, penalty, ``mtp_ce`` and every gradient leaf
    against ``jax.value_and_grad`` of the reference's (jitted), on three
    batches (``batch_fn(seed)``, numpy; ``TokenStream``'s by default), every
    batch strict: the port's activation quantizers put out
    the reference's codes (``reference_codes``; the codes the port's own
    forward rounds apart are counted), the ``t``/``d`` of columns on their
    cap are left out and counted (``tests/test_torch_train.py``), the
    penalty is held to rtol 1e-5 plus ``_penalty_slack``, every other leaf
    to 1e-4 of its largest |g|, an activation scale's to 1e-4 of the sum of
    its terms' magnitudes.  A leaf whose two gradients are both below 1e-8
    of the tree's largest |g| is counted as zero: rounding noise around an
    analytic 0 (a top-1 router: its gate ``p / p`` is 1, so it must be
    among them), or a linear whose input quantizes to all-zero codes.  For
    a MoE the routing on those codes must agree (``routing_report``; a
    batch routed apart at a near-tie is left out and counted)."""
    jarch, arch, params = _model(name)
    is_moe = any(s.kind == "moe" for s in arch.stacks)
    if is_moe:
        params = _off_grid(params)
    if pushed:
        params = _push(params, arch)
    params, moved = _off_trunc_ties(params, arch)
    ties = _tie_mask(params, arch)
    n_ties = sum(int(m.sum()) for k, m in ties.items() if k[-1] == "t")
    assert (n_ties == 0) == pushed
    strict, report, zeros = 0, [], set()
    for seed in seeds:
        batch = batch_fn(seed) if batch_fn is not None else \
            TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=seed).batch(0)
        ((jl, jm), jg), jrec = _jax_recorder(name)(jax.tree.map(jnp.asarray, params),
                                                   {k: jnp.asarray(v) for k, v in batch.items()})
        codes, jprobs, flips = reference_decisions(arch, from_jax_numpy(params), batch, jrec)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(params))
        with reference_codes(codes, live) as (mags, tprobs):
            tl, tm = lm_loss(live, arch, tb)
            flat_live = tree_leaves_with_path(live)
            tg = torch.autograd.grad(tl, [v for _, v in flat_live])
        rep = routing_report(arch, jprobs, tprobs) if is_moe else {"same": True}
        report.append((seed, flips, rep))
        if not rep["same"]:
            continue
        assert tm.keys() == jm.keys()
        for k in ("loss", "ce", "mtp_ce"):
            if k in jm:
                np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5,
                                           err_msg=k)
        np.testing.assert_allclose(float(tm["penalty"].detach()), float(jm["penalty"]), rtol=1e-5,
                                   atol=_penalty_slack(params, arch), err_msg="penalty")
        assert (float(tm["penalty"].detach()) > 0.05) == pushed
        jflat = _flat(_np(jg))
        top = max(float(np.abs(v).max()) for v in jflat.values())
        for (path, _), g in zip(flat_live, tg):
            got, want = g.numpy(), jflat[path]
            if max(np.abs(got).max(), np.abs(want).max()) <= 1e-8 * top:
                zeros.add(path)
                continue
            keep = np.broadcast_to(~ties[path], want.shape) if path in ties else \
                np.ones(want.shape, bool)
            if not keep.any():
                continue
            if path[-1] == "log2_scale":
                ratio = (np.abs(got - want) / mags[path]).max()
                assert ratio <= 1e-4, (seed, path, ratio)
            else:
                diff = np.abs(got - want)[keep]
                assert diff.max() <= 1e-4 * np.abs(want).max(), (seed, path, diff.max())
        strict += 1
    assert strict > 0
    top1 = {("stacks", str(i), "moe", "router") for i, s in enumerate(arch.stacks)
            if s.kind == "moe" and s.moe.top_k == 1}
    assert top1 <= zeros, zeros
    print(f"{name} {'pushed' if pushed else 'init'}: {n_ties} tie columns left out of the t/d "
          f"comparison; {moved} weights moved off a truncation tie; {strict} of {len(seeds)} "
          f"batches strict; (batch, activation codes the port's own forward rounds apart, "
          f"routing): {report}; zero up to rounding: {sorted(zeros)}")


@pytest.mark.parametrize("pushed", [False, True], ids=["init", "pushed"])
@pytest.mark.parametrize("name", [DEEPSEEK, LLAMA4])
def test_moe_lm_loss_and_grads_match(name, pushed):
    """Loss, ce, penalty, ``mtp_ce`` (deepseek) and every gradient leaf
    (experts, router, the MTP head's included) against ``jax.value_and_grad``
    of the reference's ``lm_loss``, on three batches."""
    check_lm_loss_and_grads(name, pushed)


def test_mtp_head_terms_match_the_reference():
    """The MTP head's structure: its block is the last stack's attention
    with a gated MLP of ``4 * d_model`` (deepseek's last stack is a MoE,
    ``d_ff`` 0).  ``metrics["penalty"]`` leaves the MTP terms out; the loss
    takes in the MTP block's penalty (``t`` pushed further past its cap
    raises the loss by ``reg_lambda`` times the push) and not ``mtp.proj``'s
    (the same push leaves the loss as it was: ``apply_a2q`` clamps ``t``)."""
    from repro_torch.core.a2q import a2q_norm_cap
    from repro_torch.models.lm import _mtp_stackcfg, a2q_penalty_of

    _, arch, params = _model(DEEPSEEK)
    st = _mtp_stackcfg(arch)
    assert (st.kind, st.count, st.d_ff, st.mlp_gated) == ("attn_mlp", 1, 4 * arch.d_model, True)
    assert st.attn == arch.stacks[-1].attn
    batch = {k: torch.from_numpy(v) for k, v in
             TokenStream(vocab=arch.vocab, seq_len=32, global_batch=2, seed=4).batch(0).items()}
    q = arch.quant

    def loss_with(push):  # push: a leaf path's A2Q node -> its columns above the cap + 1
        p, above = from_jax_numpy(_push(params, arch)), torch.zeros(())
        if push:
            node = p
            for k in push:
                node = node[k]
            above = node["t"] > a2q_norm_cap(node["d"], q.acc_bits, q.act_bits, True)
            node["t"] += above.float()
        with torch.no_grad():
            loss, m = lm_loss(p, arch, batch)
        return float(loss), m, int(above.sum()), p

    base, m, _, p = loss_with(())
    torch.testing.assert_close(m["penalty"], a2q_penalty_of(p, arch), rtol=0, atol=0)
    block, _, n_block, _ = loss_with(("mtp", "block", "mlp", "w_out"))
    proj, _, n_proj, _ = loss_with(("mtp", "proj"))
    assert n_block > 0 and n_proj > 0
    np.testing.assert_allclose(block - base, q.reg_lambda * n_block, rtol=1e-3)
    assert proj == base


def test_moe_penalty_matches_reference():
    """``nn.moe.moe_penalty`` (routed experts per (expert, channel), shared
    experts as linears) equals the reference's on a pushed MoE layer, and
    ``tree_a2q_penalty`` over the stack sums the same terms."""
    from repro_torch.nn.transformer import tree_a2q_penalty

    jarch, arch, params = _model(DEEPSEEK)
    stack = _push(params, arch)["stacks"]["1"]
    s = next(st for st in arch.stacks if st.kind == "moe")
    layer = jax.tree.map(lambda a: a[0], stack["moe"])
    want = float(jmoe.moe_penalty(jax.tree.map(jnp.asarray, layer), s.moe, jarch.quant))
    got = float(tmoe.moe_penalty(from_jax_numpy(layer), s.moe, arch.quant))
    assert want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=_penalty_slack({"moe": layer}, arch))
    whole = float(tree_a2q_penalty({"moe": from_jax_numpy(layer)}, arch.quant))
    np.testing.assert_allclose(whole, got, rtol=1e-6)


def _qat(q):
    return dict(mode="qat", weight_bits=q.weight_bits, act_bits=q.act_bits, acc_bits=q.acc_bits)


@pytest.mark.parametrize("name", [DEEPSEEK, LLAMA4])
def test_qat_experts_init_view_grads_and_codes(name):
    """Baseline-QAT expert weights (``w`` + per-(expert, channel)
    ``wq.log2_scale``): the port's init calibrates its own draw as the
    reference's formula does (1 ulp); on the reference's draw the
    fake-quant view and the straight-through gradients of ``sum(view *
    R)`` to ``w`` and ``log2_scale`` match to 1e-6 of their largest value,
    and ``deploy_params`` on a stacked ``(count, E, K, C)`` leaf gives the
    reference's codes exactly and its scales to rtol 1e-6."""
    arch = reduced(get_arch(name))
    moe = next(s.moe for s in arch.stacks if s.kind == "moe")
    E, K, C = moe.n_experts, arch.d_model, moe.d_ff
    q, jq = QuantConfig(**_qat(arch.quant)), JQuantConfig(**_qat(arch.quant))

    mine = tmoe._init_expert_weight(torch.Generator().manual_seed(0), E, K, C, q)
    assert set(mine) == {"w", "wq"} and mine["wq"]["log2_scale"].shape == (E, C)
    w = mine["w"].numpy()
    want = np.log2(np.maximum(np.abs(w).max(1), 1e-8) / np.float32(127.0)).astype(np.float32)
    np.testing.assert_array_max_ulp(mine["wq"]["log2_scale"].numpy(), want, maxulp=1)

    ref = unbox(jmoe._init_expert_weight(jax.random.PRNGKey(3), E, K, C, jq,
                                         ("experts", "embed", None)))
    ref = _np(ref)
    rng = np.random.default_rng(0)
    R = rng.normal(size=(E, K, C)).astype(np.float32)
    _, jg = jax.value_and_grad(lambda p: jnp.sum(jmoe._expert_weight_view(p, jq) * R))(
        jax.tree.map(jnp.asarray, ref))
    view_j = np.asarray(jax.jit(lambda p: jmoe._expert_weight_view(p, jq))(
        jax.tree.map(jnp.asarray, ref)))
    live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(ref))
    view_t = tmoe._expert_weight_view(live, q, torch.arange(E), torch.float32)
    np.testing.assert_allclose(view_t.detach().numpy(), view_j, rtol=0,
                               atol=1e-6 * np.abs(view_j).max())
    gw, gs = torch.autograd.grad((view_t * torch.from_numpy(R)).sum(),
                                 [live["w"], live["wq"]["log2_scale"]])
    want = np.asarray(jg["w"])
    np.testing.assert_allclose(gw.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    # a scale's gradient ln2 * s * sum_K R (q - w / s) cancels: held against
    # the sum of its terms' magnitudes (fp32 sums of K terms)
    s_ = np.exp2(ref["wq"]["log2_scale"].astype(np.float64))[:, None, :]
    u = ref["w"] / s_
    qc = np.clip(np.round(u), -128, 127)
    mags = np.log(2.0) * np.abs(R * np.where(np.abs(u) < 127, qc - u, qc) * s_).sum(1)
    # plus a few ulps of each term's w / s: exp2 of the two libraries may put
    # s an ulp apart, which moves u by an ulp of its own size
    ulps = np.log(2.0) * np.abs(R * ref["w"]).sum(1) * 2.0**-21
    assert (np.abs(gs.numpy() - np.asarray(jg["wq"]["log2_scale"])) <= 1e-5 * mags + ulps).all()

    # a MoE stack's QAT experts as a model tree holds them: (count, E, K, C)
    stacked = {"moe": {"w_in": {"w": np.stack([ref["w"], ref["w"][::-1] * 1.5]),
                                "wq": {"log2_scale": np.stack([ref["wq"]["log2_scale"]] * 2)}}}}
    jd = _np(jdeploy_params(jax.tree.map(jnp.asarray, stacked), jq))
    td = deploy_params(from_jax_numpy(stacked), q)
    np.testing.assert_array_equal(td["moe"]["w_in"]["q8"].numpy(), jd["moe"]["w_in"]["q8"])
    assert td["moe"]["w_in"]["q8"].dtype == torch.int8
    # 2^log2_scale: XLA's CPU exp2 lands up to 4 ulps from torch's
    np.testing.assert_allclose(td["moe"]["w_in"]["s8"].numpy(), jd["moe"]["w_in"]["s8"],
                               rtol=1e-6)


def test_qat_moe_model_trains_and_serves_its_deploy(tmp_path):
    """A QAT llama4-scout (every linear and expert QAT) takes train steps
    whose loss falls, its state (``w``, ``wq`` experts and their adamw
    moments) round-trips a checkpoint bit for bit, and its deployed tree's
    forward reads the experts' ``q8 * s8`` views."""
    import dataclasses

    arch = reduced(get_arch(LLAMA4))
    arch = dataclasses.replace(arch, quant=QuantConfig(**_qat(arch.quant)))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    opt = topt.adamw()
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(arch, opt, lr_schedule=lambda s: torch.tensor(3e-3))
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=5)
    res = Trainer(step, stream.batch, log_every=1).run(state, 8)
    losses = [r["loss"] for r in res.history]
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])
    ckpt.save(str(tmp_path), res.state, 8)
    restored, _ = ckpt.restore(str(tmp_path), tree_map(torch.zeros_like, res.state))
    assert ("params", "stacks", "0", "moe", "w_in", "wq", "log2_scale") in \
        {p for p, _ in tree_leaves_with_path(restored)}
    for (p, a), (_, b) in zip(tree_leaves_with_path(restored),
                              tree_leaves_with_path(res.state)):
        assert torch.equal(a, b), p
    dep = deploy_params(res.state["params"], arch.quant)
    moe = dep["stacks"]["0"]["moe"]
    assert moe["w_in"]["q8"].dtype == torch.int8 and moe["w_in"]["q8"].ndim == 4
    toks = torch.from_numpy(stream.batch(99)["tokens"])
    with torch.no_grad():
        logits, _ = apply_lm(dep, arch, tokens=toks)
        want, _ = apply_lm(res.state["params"], arch, tokens=toks)
    assert torch.isfinite(logits).all()
    # deployed codes equal the fake-quant grid: the same forward up to fp32 rounding
    torch.testing.assert_close(logits, want, rtol=1e-3, atol=1e-3)


@functools.cache
def _jax_sgdm_step(name, lr):
    """The reference's ``sgdm`` train step in the three parts of
    ``repro.models.steps.build_train_step`` (``value_and_grad`` of
    ``lm_loss``, ``clip_by_global_norm`` at 1.0, the update), the first
    the gradient gates' compiled ``_jax_recorder`` (one compile less):
    ``run(state, batch) -> ((state, metrics), records)``."""
    opt = jopt.sgdm()

    @jax.jit
    def update(grads, state):
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        params, opt_state = opt.update(grads, state["opt_state"], state["params"],
                                       jnp.float32(lr))
        return {"params": params, "opt_state": opt_state, "step": state["step"] + 1}, gnorm

    def run(state, batch):
        ((_, metrics), grads), jrec = _jax_recorder(name)(state["params"], batch)
        new, gnorm = update(grads, state)
        return (new, dict(metrics, grad_norm=gnorm, lr=jnp.float32(lr))), jrec

    return run


def test_sgdm_train_steps_match_reference_deepseek():
    """Three ``build_train_step`` steps with ``sgdm`` of reduced deepseek-v3
    (MLA, MoE, MTP) from the same params and batches as the reference's
    jitted step, each port step on the reference step's activation codes
    (``reference_codes``; an activation at a rounding tie otherwise moves
    its token's whole path): losses and ``mtp_ce`` rtol 1e-4, params within
    1e-5 of each leaf's largest |p|, the ``t``/``d`` columns that start on
    their cap left out (their first gradients split differently)."""
    jarch, arch, params = _model(DEEPSEEK)
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=2)
    lr = 2e-3
    jstep = _jax_sgdm_step(DEEPSEEK, lr)
    tstep = build_train_step(arch, topt.sgdm(), lr_schedule=lambda s: torch.tensor(lr))
    jp = jax.tree.map(jnp.asarray, params)
    js = {"params": jp, "opt_state": jopt.sgdm().init(jp), "step": jnp.zeros((), jnp.int32)}
    tp = from_jax_numpy(params)
    ts = {"params": tp, "opt_state": topt.sgdm().init(tp),
          "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        b = stream.batch(i)
        (js, jm), jrec = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        codes, jprobs, _ = reference_decisions(arch, ts["params"], b, jrec)
        with reference_codes(codes, ts["params"]) as (_, tprobs):
            ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert routing_report(arch, jprobs, tprobs)["same"], i
        for k in ("loss", "mtp_ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got, want = _flat(ts["params"]), _flat(_np(js["params"]))
    ties = _tie_mask(params, arch)
    assert got.keys() == want.keys()
    for k in want:
        keep = np.broadcast_to(~ties[k], want[k].shape) if k in ties else slice(None)
        diff = np.atleast_1d(np.abs(got[k] - want[k]))[keep]
        assert diff.size == 0 or diff.max() <= 1e-5 * np.abs(want[k]).max(), (k, diff.max())


def _deepseek_setup(seed=0):
    arch = reduced(get_arch(DEEPSEEK))
    params = init_lm(torch.Generator().manual_seed(seed), arch, device="cpu")
    opt = topt.adamw()
    step = build_train_step(arch, opt, lr_schedule=lambda s: torch.tensor(2e-3))
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    return arch, state, step, TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=6)


def test_moe_mtp_checkpoint_resumes_bit_for_bit(tmp_path):
    """A deepseek-v3 (MoE + MTP) run checkpointed at step 3 and resumed in a
    fresh trainer reproduces the uninterrupted 5-step run bit for bit:
    losses, ``mtp_ce`` and every leaf (experts, MTP head, adamw moments)."""
    d = str(tmp_path / "ckpt")
    _, state, step, stream = _deepseek_setup()
    Trainer(step, stream.batch, ckpt_dir=d, ckpt_every=3, log_every=1).run(state, 3)
    _, like, step2, _ = _deepseek_setup()
    tr = Trainer(step2, stream.batch, log_every=1)
    restored, start = ckpt.restore(d, like)
    assert start == 3
    paths = {p for p, _ in tree_leaves_with_path(restored)}
    assert ("params", "mtp", "proj", "v") in paths
    assert ("opt_state", "m", "stacks", "1", "moe", "w_gate", "t") in paths
    res2 = tr.run(restored, 2, start_step=start)
    _, state3, step3, _ = _deepseek_setup()
    res3 = Trainer(step3, stream.batch, log_every=1).run(state3, 5)
    for k in ("loss", "mtp_ce"):
        assert [r[k] for r in res2.history] == [r[k] for r in res3.history[3:]], k
    for (p, a), (_, b) in zip(tree_leaves_with_path(res2.state),
                              tree_leaves_with_path(res3.state)):
        assert torch.equal(a, b), p


def test_reference_deepseek_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the reference's ``checkpoint.save`` wrote of reduced
    deepseek-v3 after two jitted ``sgdm`` steps (experts, router, MTP head,
    momenta) restores into the port's state with no reshaping, bit for
    bit, and the port's next step's loss and ``mtp_ce`` (on the reference
    step's activation codes) equal the reference's next step's to rtol
    1e-5."""
    jarch, arch, params = _model(DEEPSEEK)
    lr = 2e-3
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=2)
    jstep = _jax_sgdm_step(DEEPSEEK, lr)
    jp = jax.tree.map(jnp.asarray, params)
    js = {"params": jp, "opt_state": jopt.sgdm().init(jp), "step": jnp.zeros((), jnp.int32)}
    for i in range(2):
        (js, _), _ = jstep(js, {k: jnp.asarray(v) for k, v in stream.batch(i).items()})
    d = str(tmp_path / "ref")
    jckpt.save(d, js, 2)
    want = _flat(_np(js))
    (_, jm), jrec = jstep(js, {k: jnp.asarray(v) for k, v in stream.batch(2).items()})

    tp = from_jax_numpy(params)
    like = {"params": tp, "opt_state": topt.sgdm().init(tp),
            "step": torch.zeros((), dtype=torch.int32)}
    restored, start = ckpt.restore(d, like)
    assert start == 2 and os.path.isdir(os.path.join(d, "step_00000002"))
    got = _flat(restored)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    tstep = build_train_step(arch, topt.sgdm(), lr_schedule=lambda s: torch.tensor(lr))
    codes, _, _ = reference_decisions(arch, restored["params"], stream.batch(2), jrec)
    with reference_codes(codes, restored["params"]):
        _, tm = tstep(restored, {k: torch.from_numpy(v) for k, v in stream.batch(2).items()})
    for k in ("loss", "ce", "mtp_ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", [DEEPSEEK, LLAMA4])
def test_launcher_trains_moe_on_the_cpu(name, capsys):
    from repro_torch.launch.train import main

    res = main(["--device", "cpu", "--arch", name, "--reduced", "--steps", "6", "--batch", "4",
                "--seq", "32", "--lr", "3e-3"])
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    out = capsys.readouterr().out
    assert "loss " in out
    assert ("mtp_ce " in out) == (name == DEEPSEEK)
    if name == DEEPSEEK:
        assert res.history[-1]["mtp_ce"] < res.history[0]["mtp_ce"]


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw", "sgdm"])
def test_donated_step_matches_the_functional_step(opt_name):
    """``build_train_step(donate=True)`` (the update a leaf at a time, written
    into the given state's tensors) gives the functional step's losses,
    params and optimizer state bit for bit over three steps of reduced
    llama4-scout, and returns the given tensors."""
    arch = reduced(get_arch(LLAMA4))
    make = {"adafactor": lambda: topt.adafactor(min_dim_size_to_factor=8),
            "adamw": topt.adamw, "sgdm": topt.sgdm}[opt_name]
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=7)
    runs = []
    for donate in (False, True):
        params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
        opt = make()
        state = {"params": params, "opt_state": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        ptrs = [t.data_ptr() for _, t in tree_leaves_with_path(state["params"])]
        step = build_train_step(arch, opt, lr_schedule=lambda s: torch.tensor(3e-3),
                                donate=donate)
        losses = []
        for i in range(3):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in stream.batch(i).items()})
            losses.append(float(m["loss"]))
        same = [t.data_ptr() for _, t in tree_leaves_with_path(state["params"])] == ptrs
        assert same == donate
        runs.append((losses, tree_leaves_with_path(state)))
    assert runs[0][0] == runs[1][0]
    for (p, a), (q, b) in zip(runs[0][1], runs[1][1]):
        assert p == q and torch.equal(a, b), p
