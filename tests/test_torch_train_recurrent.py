"""Training the recurrent decoders in the port against the JAX package on
the CPU: reduced rwkv6-7b (time-mix through ``rwkv6_chunked``, the
channel-mix's unsigned ``cm.wv``) and reduced hymba-1.5b (sliding-window
attention beside the Mamba-2 SSD heads, ``ssd_chunked``).

The loss and gradient gate is ``tests/test_torch_train_moe.py``'s
``check_lm_loss_and_grads`` (the reference's activation codes fed to the
port's quantizers, cap ties and weights at a truncation tie handled as
there, every batch strict at 1e-4).  Both blocks differentiate under
``torch.utils.checkpoint`` (``remat="block"``) bit for bit as without it,
and the launcher trains each.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_train_moe import _model, check_lm_loss_and_grads

from repro_torch.convert import from_jax_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.lm import lm_loss
from repro_torch.nn import ssm
from repro_torch.nn.module import tree_leaves_with_path, tree_map

torch.set_num_threads(1)

ARCHS = ("rwkv6-7b", "hymba-1.5b")


@pytest.mark.parametrize("pushed", [False, True], ids=["init", "pushed"])
@pytest.mark.parametrize("name", ARCHS)
def test_recurrent_lm_loss_and_grads_match(name, pushed):
    """Loss, ce, penalty and every gradient leaf (the decay LoRA, ``u``,
    ``mix``, ``A_log``, ``D``, ``dt_bias``, the unsigned ``cm.wv`` cap's
    ``t``/``d``) against ``jax.value_and_grad`` of the reference's
    ``lm_loss`` on three batches."""
    check_lm_loss_and_grads(name, pushed)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_block_matches_none_bit_for_bit(name):
    """Each rwkv6 / hymba block under ``torch.utils.checkpoint`` gives the
    same loss and gradients as without it, bit for bit: a cacheless forward
    writes no state in place, so the recompute sees what the forward saw."""
    _, arch, params = _model(name)
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


def test_rwkv6_training_forward_takes_the_chunked_form():
    """Under autograd the time-mix's recurrence is ``rwkv6_chunked`` (the
    reference's training form; on the card too, where the scan kernel has
    no backward), and its gradients reach ``r``/``k``/``v``/``w``/``u``."""
    _, arch, params = _model("rwkv6-7b")
    calls, orig = [], ssm.rwkv6_chunked

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    live = tree_map(lambda t: t.requires_grad_(), from_jax_numpy(params))
    batch = {k: torch.from_numpy(v)
             for k, v in TokenStream(vocab=arch.vocab, seq_len=16, global_batch=2).batch(0).items()}
    ssm.rwkv6_chunked = counted
    try:
        loss, _ = lm_loss(live, dataclasses.replace(arch, remat="none"), batch)
    finally:
        ssm.rwkv6_chunked = orig
    assert len(calls) == arch.n_layers
    tm = live["stacks"]["0"]["tm"]
    grads = torch.autograd.grad(loss, [tm["u"], tm["w0"], tm["w_lora_a"], tm["mix"]])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_trains_recurrent_on_the_cpu(name, capsys):
    from repro_torch.launch.train import main

    res = main(["--device", "cpu", "--arch", name, "--reduced", "--steps", "6", "--batch", "4",
                "--seq", "32", "--lr", "3e-3"])
    losses = [r["loss"] for r in res.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "loss " in out and "mtp_ce" not in out
