"""The mixture-of-experts FFN in the port against the JAX package.

Reduced deepseek-v3's MoE (8 experts, top-2, one shared expert, d_ff 32,
fp32) with params from the JAX initializer, float (A2Q fake-quant),
deployed to int8, and unquantized, on the same numpy activations.  Besides the outputs, the
tests compare what each side packs for its experts — the group sizes and the
packed rows, captured at each side's ``_local_expert_ffn`` — so both keep
and drop the same (token, expert) pairs.  A tight capacity factor makes
drops the normal case, as they are at decode at full width (capacity 1); the
decode shape (3 tokens, top-2 of 8 experts) gives the static expert-slot
form fewer slots than experts.

Tolerance 1e-5: the same fp32 arithmetic summed in another order; the
packed rows are activation codes times one scale and agree to the ``exp2``
last bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.moe as jmoe
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.nn.module import unbox
from repro.nn.transformer import apply_stack as japply_stack
from repro.serve.engine import deploy_params as jdeploy_params

import repro_torch.nn.moe as moe
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import from_jax_numpy
from repro_torch.nn.transformer import apply_stack
from repro_torch.serve.engine import deploy_params

torch.set_num_threads(1)

NAME = "deepseek-v3-671b"
TOL = 1e-5


@pytest.fixture(scope="module")
def moe_params():
    """JAX params of one reduced MoE layer, as numpy: A2Q float and deployed,
    and unquantized (``mode="none"``)."""
    arch = jreduced(jget_arch(NAME))
    cfg = arch.stacks[1].moe
    plain = dataclasses.replace(arch.quant, mode="none")
    params = jax.jit(lambda k: unbox(jmoe.init_moe(k, arch.d_model, cfg, arch.quant)))(
        jax.random.PRNGKey(7))
    deployed = jax.jit(lambda p: jdeploy_params(p, arch.quant))(params)
    plain_params = jax.jit(lambda k: unbox(jmoe.init_moe(k, arch.d_model, cfg, plain)))(
        jax.random.PRNGKey(8))
    return {"float": jax.tree.map(np.asarray, params),
            "deployed": jax.tree.map(np.asarray, deployed),
            "none": jax.tree.map(np.asarray, plain_params)}


def _spy(monkeypatch, module, sink):
    """Record (packed rows, group sizes) at ``module._local_expert_ffn``."""
    real = module._local_expert_ffn

    if module is jmoe:
        def spy(x_buf, *rest):
            jax.debug.callback(lambda xb, gs: sink.append((np.asarray(xb), np.asarray(gs))),
                               x_buf, rest[3])
            return real(x_buf, *rest)
    else:
        def spy(x_buf, params, group_sizes, *rest):
            sink.append((x_buf.numpy().copy(), np.asarray(group_sizes)))
            return real(x_buf, params, group_sizes, *rest)

    monkeypatch.setattr(module, "_local_expert_ffn", spy)


@pytest.mark.parametrize("kind", ["float", "deployed", "none"])
@pytest.mark.parametrize("cf,shape", [(2.0, (2, 6)), (0.5, (2, 6)), (2.0, (3, 1)), (0.5, (3, 1))],
                         ids=["cf2", "cf0.5", "cf2-decode", "cf0.5-decode"])
def test_apply_moe_matches_jax_with_same_drops(moe_params, monkeypatch, kind, cf, shape):
    jarch, arch = jreduced(jget_arch(NAME)), reduced(get_arch(NAME))
    if kind == "none":
        jarch = dataclasses.replace(jarch, quant=dataclasses.replace(jarch.quant, mode="none"))
        arch = dataclasses.replace(arch, quant=dataclasses.replace(arch.quant, mode="none"))
    jcfg = dataclasses.replace(jarch.stacks[1].moe, capacity_factor=cf)
    cfg = dataclasses.replace(arch.stacks[1].moe, capacity_factor=cf)
    params = moe_params[kind]
    x = np.random.default_rng(17).normal(size=(*shape, arch.d_model)).astype(np.float32)
    if shape[1] == 1:  # a repeated token routes as its twin: capacity 1 drops one of them
        x[2] = x[0]
    jseen, seen = [], []
    _spy(monkeypatch, jmoe, jseen)
    _spy(monkeypatch, moe, seen)
    want = jax.jit(lambda p, v: jmoe.apply_moe(p, v, jcfg, jarch.quant,
                                               compute_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = moe.apply_moe(from_jax_numpy(params), torch.from_numpy(x), cfg, arch.quant,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    (jx, jgs), (tx, tgs) = jseen[-1], seen[-1]
    np.testing.assert_array_equal(tgs, jgs)  # the same kept count per expert
    np.testing.assert_allclose(tx, jx[: tx.shape[0]], rtol=0, atol=TOL)  # the same rows
    T, k = x.shape[0] * x.shape[1], cfg.top_k
    capacity = max(int(T * k * cf / cfg.n_experts), 1)
    assert tgs.max() <= capacity
    if cf < 1.0:  # the tight capacity really drops
        assert T * k - int(tgs.sum()) > 0


def test_moe_stack_matches_jax_int_forward():
    """Reduced deepseek-v3's MoE stack (MLA + MoE blocks), deployed, on the
    fused int path: the routed experts on the dequantized view (booked as a
    fallback), the shared experts and MLA linears on ``int_matmul``."""
    jarch, arch = jreduced(jget_arch(NAME)), reduced(get_arch(NAME))
    from repro.nn.transformer import init_stack as jinit_stack

    params = jax.jit(lambda k: jdeploy_params(unbox(jinit_stack(k, jarch, jarch.stacks[1])),
                                              jarch.quant))(jax.random.PRNGKey(9))
    x = np.random.default_rng(19).normal(size=(2, 5, arch.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    want = jax.jit(lambda p, v, q: japply_stack(p, v, jarch, jarch.stacks[1], q,
                                                int_forward=True)[0])(
        params, jnp.asarray(x), jnp.asarray(pos))
    got = apply_stack(from_jax_numpy(jax.tree.map(np.asarray, params)), torch.from_numpy(x),
                      arch, arch.stacks[1], torch.from_numpy(pos), int_forward=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_deploy_params_keeps_stacked_expert_leaves():
    """``deploy_params`` deploys ``(count, E, K, N)`` expert leaves expert by
    expert, the shared experts as linears, and passes the MoE's entry
    quantizer and the router through."""
    arch = reduced(get_arch(NAME))
    from repro_torch.nn.transformer import init_stack

    p = init_stack(torch.Generator().manual_seed(0), arch, arch.stacks[1])
    d = deploy_params(p, arch.quant)["moe"]
    cfg, count = arch.stacks[1].moe, arch.stacks[1].count
    assert d["w_in"]["q8"].shape == (count, cfg.n_experts, arch.d_model, cfg.d_ff)
    assert d["w_in"]["q8"].dtype == torch.int8
    assert d["w_out"]["s8"].shape == (count, cfg.n_experts, arch.d_model)
    assert set(d["shared_in"]) == {"q8", "s8", "aq"}
    assert torch.equal(d["aq"]["log2_scale"], p["moe"]["aq"]["log2_scale"])
    assert torch.equal(d["router"], p["moe"]["router"])
    # the A2Q bound holds per (expert, output channel)
    l1 = d["w_in"]["q8"].to(torch.int64).abs().sum(dim=-2)
    assert int(l1.max()) <= (2 ** (arch.quant.acc_bits - 1) - 1) // 2 ** (arch.quant.act_bits - 1)
