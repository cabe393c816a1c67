"""Training the frontend families in the port against the JAX package on
the CPU: reduced hubert-xlarge (``family="audio"``: frame embeddings in, no
token embedding, a bidirectional encoder, framewise classes out) and
reduced llava-next-34b (``family="vlm"``: patch embeddings ahead of the
text), both with targets over the whole (frontend + text) sequence.

The loss and gradient gate is ``tests/test_torch_train_moe.py``'s
``check_lm_loss_and_grads`` (the reference's activation codes fed to the
port's quantizers, cap ties left out and counted, weights at a truncation
tie moved off it, every batch strict at 1e-4) on the batches of
``tests/test_arch_smoke.py``'s ``_batch`` (B=2, S=16), drawn from each
seed.  Then ``build_train_step`` trains each on one batch.
"""

import numpy as np
import pytest
import torch
from test_torch_train_moe import _model, check_lm_loss_and_grads

from repro_torch.models.lm import lm_loss
from repro_torch.models.steps import build_train_step
from repro_torch.nn.module import tree_map
from repro_torch.optim.optimizers import adamw
from repro_torch.train.state import init_state

torch.set_num_threads(1)

ARCHS = ("hubert-xlarge", "llava-next-34b")


def frontend_batch(arch, seed, B=2, S=16) -> dict:
    """``tests/test_arch_smoke.py``'s batch of ``arch``'s family (numpy,
    float32 embeddings, int32 targets over all S positions) from ``seed``."""
    rng = np.random.default_rng(seed)
    if arch.family == "audio":
        return {"frontend_embeds": rng.normal(size=(B, S, arch.d_model)).astype(np.float32),
                "targets": rng.integers(0, arch.n_classes, (B, S)).astype(np.int32)}
    si = arch.frontend.seq_len
    return {"tokens": rng.integers(0, arch.vocab, (B, S - si)).astype(np.int32),
            "frontend_embeds": rng.normal(size=(B, si, arch.d_model)).astype(np.float32),
            "targets": rng.integers(0, arch.vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("pushed", [False, True], ids=["init", "pushed"])
@pytest.mark.parametrize("name", ARCHS)
def test_frontend_lm_loss_and_grads_match(name, pushed):
    """Loss, ce, penalty and every gradient leaf (hubert's ``n_classes``
    head, layer norms and biases; llava's embedding table through the text
    positions) against ``jax.value_and_grad`` of the reference's
    ``lm_loss``, on three batches."""
    _, arch, _ = _model(name)
    check_lm_loss_and_grads(name, pushed, batch_fn=lambda seed: frontend_batch(arch, seed))


@pytest.mark.parametrize("name", ARCHS)
def test_frontend_train_step_learns_a_batch(name):
    """``build_train_step`` on the frontend batches: the loss is finite,
    over every (frontend + text) position, and falls on a repeated batch;
    targets shorter than the sequence are refused, as the reference's
    gather refuses them."""
    _, arch, params = _model(name)
    params = tree_map(torch.from_numpy, params)
    opt = adamw()
    state = init_state(tree_map(torch.clone, params), opt).tree()
    step = build_train_step(arch, opt, lr_schedule=lambda s: torch.tensor(3e-3))
    batch = {k: torch.from_numpy(v) for k, v in frontend_batch(arch, 0).items()}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.05, losses
    short = dict(batch, targets=batch["targets"][:, :-1])
    with pytest.raises(ValueError, match="targets"):
        lm_loss(params, arch, short)
