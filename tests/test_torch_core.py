"""The port's configs and A2Q core against the JAX package.

Integer codes must agree exactly.  Floats agree to a stated tolerance: every
scale is ``exp2`` of a learned log2 value, and ``jnp.exp2`` / ``torch.exp2``
differ by up to 8 fp32 ulp (rtol 1e-6).  Gradients of ``apply_a2q`` agree to
1e-5 (the straight-through estimator makes them float expressions of the
same inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core import a2q as ja2q
from repro.core import quantizers as jq

from repro_torch.configs import ARCH_NAMES, get_arch, reduced
from repro_torch.core import a2q, quantizers

torch.set_num_threads(1)


def _fields(cfg):
    """A config as nested plain data (dataclass names dropped)."""
    return jax.tree.map(lambda x: x, dataclasses.asdict(cfg))


def test_configs_match_reference_field_by_field():
    assert ARCH_NAMES == JARCH_NAMES
    for name in ARCH_NAMES:
        assert _fields(get_arch(name)) == _fields(jget_arch(name)), name
        assert _fields(reduced(get_arch(name))) == _fields(jreduced(jget_arch(name))), name


def _vtd(rng, K, C, signed, M=8, N=8, P=16):
    """A2Q params from the JAX init on random weights, with ``t`` pushed above
    the cap on some channels so the clamp and the clip both engage."""
    w = jnp.asarray(rng.normal(size=(K, C)) * 0.05, jnp.float32)
    p = ja2q.init_a2q(w, M, P, N, signed)
    t = np.asarray(p["t"]) + rng.uniform(-2.0, 3.0, C).astype(np.float32)
    return {"v": np.array(p["v"]), "t": t, "d": np.array(p["d"])}


@pytest.mark.parametrize("K,C,signed,P", [(576, 192, True, 16), (1536, 64, False, 16), (64, 32, True, 12)])
def test_a2q_int_weights_codes_match(K, C, signed, P):
    p = _vtd(np.random.default_rng(K + P), K, C, signed, P=P)
    jqw, js = ja2q.a2q_int_weights({k: jnp.asarray(v) for k, v in p.items()}, 8, P, 8, signed)
    tqw, ts = a2q.a2q_int_weights({k: torch.from_numpy(v) for k, v in p.items()}, 8, P, 8, signed)
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    # the guarantee itself: every column's l1 fits the Eq. 15 budget
    budget = (2 ** (P - 1) - 1) * 2.0 ** (int(signed) - 8)
    assert np.abs(tqw.numpy()).sum(0).max() <= budget


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, True)])
def test_act_quant_int_codes_match(bits, signed):
    rng = np.random.default_rng(bits + signed)
    x = (rng.normal(size=(64, 96)) * 3).astype(np.float32)
    for log2_scale in (-4.4, -2.0, -6.7, 0.3):
        ls = np.float32(log2_scale)
        jc, js = jq.act_quant_int({"log2_scale": jnp.asarray(ls)}, jnp.asarray(x), bits, signed)
        tc, ts = quantizers.act_quant_int({"log2_scale": torch.tensor(ls)}, torch.from_numpy(x),
                                          bits, signed)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_apply_a2q_grad_matches_jax():
    """Gradients of ``sum(apply_a2q(v, t, d) * R)`` reach v, t and d through
    the round-toward-zero STE and the clip, as ``jax.grad`` computes them."""
    rng = np.random.default_rng(9)
    p = _vtd(rng, 96, 24, True)
    R = rng.normal(size=(96, 24)).astype(np.float32)

    def jloss(jp):
        return jnp.sum(ja2q.apply_a2q(jp, 8, 16, 8, True) * R)

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    (a2q.apply_a2q(tp, 8, 16, 8, True) * torch.from_numpy(R)).sum().backward()
    for k in ("v", "t", "d"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
