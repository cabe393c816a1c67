"""The port's training stack against the JAX package on the CPU.

Parameters are drawn by the JAX initializers and carried over with
``repro_torch.convert.from_jax_numpy``; batches come from ``TokenStream``.
Both sides compute in float32 (the reduced configs).  Tolerances:

* ``TokenStream`` batches — bit for bit (numpy on both sides);
* schedules — 1e-6 of the schedule's base lr (a few fp32 ulps of its
  terms: ``cos`` and ``pow`` of two libraries; near the end of the cosine
  ``1 + cos`` cancels, so one ulp of ``cos`` is 3e-6 of the floor);
* optimizer updates on the same params, grads and state — rtol 1e-6;
* ``lm_loss`` — loss, ce and penalty rtol 1e-5; every gradient leaf within
  1e-4 of that leaf's largest |g|, except ``t`` and ``d`` on the columns
  whose ``t`` sits within 4 ulp of its norm cap T (a tie): there
  ``min(t, T)`` and ``max(t - T, 0)`` split the gradient half and half in
  one package and may send it whole to one side in the other, because the
  two compute T one ulp apart (``log2(32767)`` rounds differently);
* three ``sgdm`` train steps — losses rtol 1e-4, params within 1e-5 of each
  leaf's largest |p|.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.a2q import a2q_norm_cap as ja2q_norm_cap
from repro.core.a2q import a2q_penalty as ja2q_penalty
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models.lm import Runtime as JRuntime
from repro.models.lm import init_lm as jinit_lm
from repro.models.lm import lm_loss as jlm_loss
from repro.models.steps import build_train_step as jbuild_train_step
from repro.nn.module import unbox
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.core.a2q import a2q_norm_cap, a2q_penalty
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.lm import lm_loss
from repro_torch.models.steps import build_train_step
from repro_torch.nn.module import tree_leaves_with_path, tree_map
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ARCHS = ("smollm-135m", "yi-6b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    """``{keys: numpy leaf}`` of a port tree or a numpy'd JAX tree."""
    return {p: (v.detach().numpy() if torch.is_tensor(v) else np.asarray(v))
            for p, v in tree_leaves_with_path(tree)}


@functools.cache
def _model(name):
    """(reference arch, port arch, raw JAX params as numpy)."""
    jarch = jreduced(jget_arch(name))
    return jarch, reduced(get_arch(name)), _np(unbox(jinit_lm(KEY, jarch)))


@functools.cache
def _jax_grad(name):
    jarch = _model(name)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, jarch, b), has_aux=True))


@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_batches_bit_equal(seed):
    ref = JTokenStream(vocab=256, seq_len=32, global_batch=4, seed=seed)
    port = TokenStream(vocab=256, seq_len=32, global_batch=4, seed=seed)
    for step in range(3):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine_with_warmup": lambda m: m.cosine_with_warmup(1e-3, warmup=10, total=80, floor=1e-5),
    "step_decay": lambda m: m.step_decay(1e-3, 0.1, every=30),
    "exponential_decay": lambda m: m.exponential_decay(1e-3, 0.9, every=7),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    jf, tf = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    got = np.array([float(tf(torch.tensor(s, dtype=torch.int32))) for s in range(100)])
    want = np.array([float(jf(jnp.int32(s))) for s in range(100)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


OPTIMIZERS = {
    "sgdm": lambda m: m.sgdm(weight_decay=1e-2),
    "adamw": lambda m: m.adamw(weight_decay=1e-2),
    "adafactor": lambda m: m.adafactor(min_dim_size_to_factor=8, weight_decay=1e-2),
}


def _assert_trees_close(got, want, rtol):
    """Leaf by leaf: ``rtol``, and as much of the leaf's largest |value|
    (``p - lr * u`` cancels near 0, and XLA contracts multiply-adds into
    fmas where PyTorch rounds twice: an ulp there is large against the
    difference)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * np.abs(want[k]).max(),
                                   err_msg=str(k))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match(name):
    """Two updates from the same params, grads and state: params and the
    state trees (keys and values) agree to rtol 1e-6."""
    params = _model("smollm-135m")[2]
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, params)
             for _ in range(2)]
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp, tp = jax.tree.map(jnp.asarray, params), from_jax_numpy(params)
    js, ts = jo.init(jp), to.init(tp)
    jupd = jax.jit(jo.update)
    for step, g in enumerate(grads):
        lr = np.float32(1e-2 / (step + 1))
        jp, js = jupd(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts = to.update(from_jax_numpy(g), ts, tp, torch.tensor(lr))
    _assert_trees_close(tp, _np(jp), 1e-6)
    _assert_trees_close(ts, _np(js), 1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    """Clipped (1.0) and passed through (1e3): the norm and the scaled grads
    agree with the reference's to rtol 1e-6."""
    params = _model("yi-6b")[2]
    rng = np.random.default_rng(4)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = topt.clip_by_global_norm(from_jax_numpy(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tc, _np(jc), 1e-6)


def _a2q_nodes(tree, path=()):
    """``(path, node)`` of every A2Q layer (a dict with v, t and d)."""
    if "t" in tree and "d" in tree and "v" in tree:
        yield path, tree
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _a2q_nodes(v, path + (k,))


def _cap(node, arch, path):
    boundary = path == ("head",)
    N = arch.quant.boundary_bits if boundary else arch.quant.act_bits
    signed = path[-2:] != ("cm", "wv")
    return a2q_norm_cap(torch.from_numpy(np.array(node["d"])), arch.quant.acc_bits, N,
                        signed).numpy()


def _push(params, arch):
    """A copy with every A2Q column off its cap: columns 0, 3, 6, ... with
    ``t`` 0.05 above it (the penalty live), the rest 0.05 and 0.1 below it
    (``t`` live through ``min(t, T)``)."""
    out = jax.tree.map(np.copy, params)
    for path, node in _a2q_nodes(out):
        T = _cap(node, arch, path)
        cols = np.arange(node["t"].shape[-1]) % 3
        shift = np.where(cols == 0, 0.05, np.where(cols == 1, -0.05, -0.1)).astype(np.float32)
        node["t"][...] = T + shift
    return out


def _tie_mask(params, arch) -> dict:
    """``{path + ("t",) and path + ("d",): columns whose t is a tie}`` for
    every A2Q layer: ``|t - T| <= 4`` ulps of the cap's largest term
    (``1_signed + log2(2**(P-1) - 1)``, about 16, in which T's sum rounds;
    the two packages' T differ by about one of those, far more than an ulp
    of T itself near 0)."""
    masks = {}
    for path, node in _a2q_nodes(params):
        T = _cap(node, arch, path)
        signed = int(path[-2:] != ("cm", "wv"))
        term = np.float32(signed + np.log2(2.0 ** (arch.quant.acc_bits - 1) - 1))
        ulp = np.spacing(np.maximum(np.abs(T), term).astype(np.float32))
        masks[path + ("t",)] = masks[path + ("d",)] = np.abs(node["t"] - T) <= 4 * ulp
    return masks


def _penalty_slack(params, arch) -> float:
    """How far the penalty may move on the caps alone: the two packages'
    caps differ by about an ulp of their largest term, so every column at
    or above its cap (within 4 of those ulps) may contribute that much
    more or less."""
    ulp = np.spacing(np.float32(16.0))  # 1_signed + log2(2**15 - 1) rounds at 16
    slack = 0.0
    for path, node in _a2q_nodes(params):
        slack += float(4 * ulp * (node["t"] >= _cap(node, arch, path) - 4 * ulp).sum())
    return slack


def _port_forward_probe(params, arch, batch):
    """What the port's own forward says about the gradient's conditioning:

    * ``{path of an aq.log2_scale leaf: per-layer sum of |terms|}`` — that
      gradient is ``ln2 * s * Σ g_i * (q_i - x_i / s)`` over every
      activation it quantized (``q_i`` alone where clipped), a sum that
      cancels to 1/20-1/300 of its terms' magnitudes, so it is held
      against their sum, not against itself;
    * the number of activations sitting at a rounding tie (``x / s`` within
      1e-6 of a half-integer): the two packages' activations differ by ulps,
      so such a code may round one apart, and that token's forward, and
      with it every gradient it feeds, then differs a little.

    Measured through a hook on the port's act-quant (the linears' and a
    MoE's entry quantizer), without remat (each call runs once)."""
    import repro_torch.nn.linear as lin
    import repro_torch.nn.moe as moe
    from repro_torch.core.bounds import int_range

    live = tree_map(lambda t: torch.from_numpy(np.array(t)).requires_grad_(), params)
    by_id = {id(v): p for p, v in tree_leaves_with_path(live) if p[-1] == "log2_scale"}
    calls, orig = [], lin.apply_act_quant

    def record(qp, x, bits, signed):
        y = orig(qp, x, bits, signed)
        ls = qp["log2_scale"]
        base = ls if ls._base is None else ls._base
        call = {"path": by_id[id(base)], "at": ls.storage_offset() - base.storage_offset(),
                "x": x.detach(), "s": torch.exp2(ls).detach(), "range": int_range(bits, signed)}
        y.register_hook(lambda g: call.__setitem__("g", g))
        calls.append(call)
        return y

    lin.apply_act_quant = moe.apply_act_quant = record
    try:
        loss, _ = lm_loss(live, dataclasses.replace(arch, remat="none"), batch)
        loss.backward()
    finally:
        lin.apply_act_quant = moe.apply_act_quant = orig
    mags, ties = {}, 0
    for c in calls:
        u = (c["x"] / c["s"]).double()
        ties += int(((u - torch.floor(u) - 0.5).abs() <= 1e-6 * torch.clamp_min(u.abs(), 1)).sum())
        n, p = c["range"]
        q = torch.clamp(torch.round(u), n, p)
        term = torch.where((u > n) & (u < p), q - u, q) * c["g"].double() * float(c["s"])
        mags.setdefault(c["path"], {})[c["at"]] = float(term.abs().sum()) * np.log(2.0)
    return {p: np.array([m[i] for i in sorted(m)]) for p, m in mags.items()}, ties


@pytest.mark.parametrize("pushed", [False, True], ids=["init", "pushed"])
@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_and_grads_match(name, pushed):
    """``lm_loss``'s loss, ce and penalty and its gradient, leaf by leaf,
    against ``jax.value_and_grad`` of the reference's (jitted), on three
    batches.

    * ``t`` and ``d`` of the columns at their cap (a tie, 4 ulps; every
      capped column at init, none once pushed) are left out, counted and
      named; the penalty is held to rtol 1e-5 plus the most the caps'
      one-ulp disagreement may move it (``_penalty_slack``);
    * every other leaf to 1e-4 of its largest |g|, an activation scale's
      (``aq.log2_scale``) to 1e-4 of the sum of its terms' magnitudes;
    * a leaf that misses this must be explained by an activation at a
      rounding tie in the port's forward (``_port_forward_probe``), and is
      then held to a relative L2 error of 1e-3 (an activation scale to
      3e-3 of its terms).  Measured on five batches: 1e-6 without a flip,
      at most 3.2e-3 of the largest |g| (5e-4 relative L2) with one; a
      wrong gradient is off by its own size.  At least one of the batches
      passes with no explanation."""
    jarch, arch, params = _model(name)
    if pushed:
        params = _push(params, arch)
    ties = _tie_mask(params, arch)
    n_ties = sum(int(m.sum()) for k, m in ties.items() if k[-1] == "t")
    assert (n_ties == 0) == pushed  # every capped column starts on its cap
    strict_batches, explained = 0, []
    for seed in (1, 2, 3):
        batch = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=seed).batch(0)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        (jl, jm), jg = _jax_grad(name)(jax.tree.map(jnp.asarray, params),
                                       {k: jnp.asarray(v) for k, v in batch.items()})
        live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(params))
        tl, tm = lm_loss(live, arch, tb)
        flat_live = tree_leaves_with_path(live)
        tg = torch.autograd.grad(tl, [v for _, v in flat_live])
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(tm["penalty"].detach()), float(jm["penalty"]), rtol=1e-5,
                                   atol=_penalty_slack(params, arch), err_msg="penalty")
        assert (float(tm["penalty"].detach()) > 0.05) == pushed
        mags, act_ties = _port_forward_probe(params, arch, tb)
        jflat = _flat(_np(jg))
        missed = []
        for (path, _), g in zip(flat_live, tg):
            got, want = g.numpy(), jflat[path]
            keep = np.broadcast_to(~ties[path], want.shape) if path in ties else \
                np.ones(want.shape, bool)
            if not keep.any():
                continue
            diff = np.abs(got - want)[keep]
            if path[-1] == "log2_scale":
                ratio = (np.abs(got - want) / mags[path]).max()
                if ratio > 1e-4:
                    missed.append(path)
                    assert ratio <= 3e-3, (seed, path, ratio)
            elif diff.max() > 1e-4 * np.abs(want).max():
                missed.append(path)
                rel = np.linalg.norm(diff) / np.linalg.norm(want[keep])
                assert rel <= 1e-3, (seed, path, rel)
        if missed:
            assert act_ties > 0, (seed, "unexplained gradient misses", missed)
            explained.append((seed, act_ties, len(missed)))
        else:
            strict_batches += 1
    assert strict_batches > 0
    print(f"{name} {'pushed' if pushed else 'init'}: {n_ties} tie columns (t within 4 ulp of "
          f"its cap) left out of the t/d comparison; {strict_batches} of 3 batches within 1e-4 "
          f"on every other leaf; (batch, activations at a rounding tie, leaves held to the "
          f"L2 bound instead): {explained}")


def test_remat_block_matches_none_bit_for_bit():
    """``remat="block"`` (each block under torch.utils.checkpoint) gives the
    same loss and gradients as ``"none"`` on the CPU, bit for bit."""
    _, arch, params = _model("yi-6b")
    batch = {k: torch.from_numpy(v)
             for k, v in TokenStream(vocab=arch.vocab, seq_len=32, global_batch=2).batch(0).items()}
    outs = []
    for remat in ("block", "none"):
        live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(params))
        loss, _ = lm_loss(live, dataclasses.replace(arch, remat=remat), batch)
        outs.append((loss.detach(), torch.autograd.grad(loss, [v for _, v in
                                                              tree_leaves_with_path(live)])))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_sgdm_train_steps_match_reference():
    """Three ``build_train_step`` steps with ``sgdm`` from the same params
    and batches as the reference's jitted step: losses rtol 1e-4, params
    within 1e-5 of each leaf's largest |p|, but for ``t`` and ``d`` of the
    columns that start on their cap (ties: their first gradients split
    differently, see ``test_lm_loss_and_grads_match``), which are left out
    and counted."""
    jarch, arch, params = _model("smollm-135m")
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=2)
    lr = 2e-3  # the reference's own tests' lr (tests/test_train.py)
    jopt_, topt_ = jopt.sgdm(), topt.sgdm()
    jstep = jax.jit(jbuild_train_step(jarch, jopt_, JRuntime(),
                                      lr_schedule=lambda s: jnp.float32(lr)))
    tstep = build_train_step(arch, topt_,
                             lr_schedule=lambda s: torch.tensor(lr, dtype=torch.float32))
    jp = jax.tree.map(jnp.asarray, params)
    js = {"params": jp, "opt_state": jopt_.init(jp), "step": jnp.zeros((), jnp.int32)}
    tp = from_jax_numpy(params)
    ts = {"params": tp, "opt_state": topt_.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    for i in range(3):
        b = stream.batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(ts["step"]) == 3
    got, want = _flat(ts["params"]), _flat(_np(js["params"]))
    ties = _tie_mask(params, arch)
    for k in want:
        keep = np.broadcast_to(~ties[k], want[k].shape) if k in ties else slice(None)
        diff = np.abs(got[k] - want[k])[keep]
        assert diff.size == 0 or diff.max() <= 1e-5 * np.abs(want[k]).max(), (k, diff.max())
    print(f"{sum(int(m.sum()) for k, m in ties.items() if k[-1] == 't')} tie columns' t and d "
          "left out")


def test_penalty_tie_gradient_is_the_references_half():
    """At ``t == T`` the penalty's gradient is 0.5 to ``t`` (and -0.5 to
    ``d``), the reference's ``jnp.maximum`` split.  ``acc_bits=12``, where
    both packages compute ``log2(2**11 - 1)`` to the same float, so both
    see the same T and the same ties; columns off the tie get 1 or 0."""
    d = np.random.default_rng(5).normal(size=(6,)).astype(np.float32) - 6
    T = np.asarray(a2q_norm_cap(torch.from_numpy(d), 12, 8, True))
    np.testing.assert_array_equal(T, np.asarray(ja2q_norm_cap(jnp.asarray(d), 12, 8, True)))
    t = T + np.asarray([0, 0, 0, 0.25, -0.25, 0], np.float32)
    jg = jax.grad(lambda p: ja2q_penalty(p, 12, 8, True))({"t": jnp.asarray(t),
                                                           "d": jnp.asarray(d)})
    tp = {"t": torch.from_numpy(t).requires_grad_(), "d": torch.from_numpy(d).requires_grad_()}
    gt, gd = torch.autograd.grad(a2q_penalty(tp, 12, 8, True), [tp["t"], tp["d"]])
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jg["t"]))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(jg["d"]))
    np.testing.assert_array_equal(gt.numpy(), [0.5, 0.5, 0.5, 1.0, 0.0, 0.5])


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint the reference's ``Trainer`` wrote (reduced smollm-135m,
    adamw, 5 steps) restores into the port's state through the port's
    ``checkpoint.restore`` with no reshaping; the port's next step's loss
    equals the reference's next step's to rtol 1e-5."""
    jarch, arch, params = _model("smollm-135m")
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4, seed=3)
    lr = 2e-3
    d = str(tmp_path / "ckpt")
    jopt_ = jopt.adamw()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jp, "opt_state": jopt_.init(jp), "step": jnp.zeros((), jnp.int32)}
    jtr = JTrainer(jbuild_train_step(jarch, jopt_, JRuntime(),
                                     lr_schedule=lambda s: jnp.float32(lr)),
                   stream.batch, ckpt_dir=d, ckpt_every=100, log_every=1)
    jres = jtr.run(jstate, 5)
    want = _flat(_np(jres.state))  # read before the next step donates the buffers
    want_params = _np(jres.state["params"])
    jnext = JTrainer(jtr.step_fn, stream.batch, log_every=1).run(jres.state, 1).history[-1]

    topt_ = topt.adamw()
    tp = from_jax_numpy(params)
    like = {"params": tp, "opt_state": topt_.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    tr = Trainer(build_train_step(arch, topt_, lr_schedule=lambda s: torch.tensor(lr)),
                 stream.batch, ckpt_dir=d, log_every=1)
    restored, start = tr.maybe_restore(like)
    assert start == 5 and int(restored["step"]) == 5
    got = _flat(restored)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tnext = tr.run(restored, 1, start_step=start).history[-1]
    assert tnext["step"] == jnext["step"] == 5
    for k in ("loss", "ce"):
        np.testing.assert_allclose(tnext[k], jnext[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tnext["penalty"], jnext["penalty"], rtol=1e-5, err_msg="penalty",
                               atol=_penalty_slack(want_params, arch))
