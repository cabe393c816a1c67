"""The port's training loop on its own (the reference's ``tests/test_train.py``
cases, run on the port): loss goes down, every optimizer trains, checkpoint
and resume are exact on the CPU, keep-k and atomicity, shape mismatches and
``allow_missing``, the straggler watchdog, grad clip, the launcher; and the
kernel wrappers, which have no backward, refuse inputs that autograd
records."""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data.synthetic import TokenStream
from repro_torch.kernels import ops
from repro_torch.models.lm import Runtime, init_lm
from repro_torch.models.steps import build_train_step
from repro_torch.nn.module import tree_leaves_with_path
from repro_torch.optim.optimizers import adafactor, adamw, clip_by_global_norm, sgdm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import StragglerWatchdog
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _setup(opt=None):
    arch = reduced(get_arch("smollm-135m"))
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    opt = opt or adamw()
    state = init_state(params, opt).tree()
    step = build_train_step(arch, opt, Runtime(),
                            lr_schedule=lambda s: torch.tensor(2e-3, dtype=torch.float32))
    stream = TokenStream(vocab=arch.vocab, seq_len=32, global_batch=4)
    return arch, state, step, stream


def test_loss_decreases():
    _, state, step, stream = _setup()
    res = Trainer(step, stream.batch, log_every=1).run(state, 30)
    first = np.mean([r["loss"] for r in res.history[:5]])
    last = np.mean([r["loss"] for r in res.history[-5:]])
    assert last < first - 0.1, (first, last)
    assert set(res.history[0]) == {"loss", "ce", "penalty", "grad_norm", "lr", "step", "step_time"}
    assert [r["step"] for r in res.history] == list(range(30))


@pytest.mark.parametrize("optname", ["sgdm", "adamw", "adafactor"])
def test_optimizers_reduce_loss(optname):
    opt = {"sgdm": sgdm(), "adamw": adamw(),
           "adafactor": adafactor(min_dim_size_to_factor=8)}[optname]
    _, state, step, stream = _setup(opt)
    res = Trainer(step, stream.batch, log_every=1).run(state, 20)
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_logs_every_n_steps_and_the_last():
    """The host reads the metrics only on logged steps: every
    ``log_every``-th and the last; ``step_time`` is the mean over the steps
    since the previous logged one."""
    _, state, step, stream = _setup()
    res = Trainer(step, stream.batch, log_every=4).run(state, 10)
    assert [r["step"] for r in res.history] == [0, 4, 8, 9]
    assert all(r["step_time"] > 0 for r in res.history)
    assert int(res.state["step"]) == 10


def test_checkpoint_roundtrip_and_resume_bit_for_bit(tmp_path):
    """A fresh trainer resumes from step 10 and reproduces an uninterrupted
    15-step run bit for bit on the CPU (stateless data stream), params
    and optimizer state included."""
    d = str(tmp_path / "ckpt")
    _, state, step, stream = _setup()
    Trainer(step, stream.batch, ckpt_dir=d, ckpt_every=5, log_every=1).run(state, 10)
    _, state2, step2, _ = _setup()
    tr2 = Trainer(step2, stream.batch, ckpt_dir=d, ckpt_every=100, log_every=1)
    restored, start = tr2.maybe_restore(state2)
    assert start == 10
    res2 = tr2.run(restored, 5, start_step=start)

    _, state3, step3, _ = _setup()
    res3 = Trainer(step3, stream.batch, log_every=1).run(state3, 15)
    assert [r["loss"] for r in res2.history] == [r["loss"] for r in res3.history[10:]]
    for (p, a), (_, b) in zip(tree_leaves_with_path(res2.state),
                              tree_leaves_with_path(res3.state)):
        assert torch.equal(a, b), p


def test_checkpoint_atomicity_and_keepk(tmp_path):
    d = str(tmp_path / "c2")
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, tree, s, keep=2)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [4, 5]
    # incomplete checkpoint (no sentinel) is ignored
    os.makedirs(os.path.join(d, "step_00000099"))
    assert ckpt.latest_step(d) == 5
    restored, step = ckpt.restore(d, tree)
    assert step == 5
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(5))
    # the manifest spells each leaf's path as the reference does
    import json

    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        paths = [m["path"] for m in json.load(f)["leaves"]]
    assert paths == ["['a']", "['b']['c']"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "c3")
    ckpt.save(d, {"a": torch.ones((3,))}, 1)
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.ones((4,))})


def test_checkpoint_allow_missing_keeps_like_values(tmp_path):
    d = str(tmp_path / "c4")
    ckpt.save(d, {"a": torch.arange(3.0)}, 1)
    like = {"a": torch.zeros((3,)), "extra": {"local": torch.full((2, 3), 7.0)}}
    with pytest.raises(KeyError):
        ckpt.restore(d, like)
    restored, step = ckpt.restore(d, like, allow_missing=True)
    assert step == 1
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(3.0))
    np.testing.assert_array_equal(restored["extra"]["local"].numpy(), np.full((2, 3), 7.0))


def test_emergency_save_writes_the_last_state(tmp_path):
    d = str(tmp_path / "c5")
    _, state, step, stream = _setup()
    tr = Trainer(step, stream.batch, ckpt_dir=d, ckpt_every=100, log_every=1)
    tr.run(state, 3)
    assert ckpt.latest_step(d) == 3
    tr._last_state = dict(tr._last_state, step=torch.tensor(7, dtype=torch.int32))
    tr.emergency_save()
    assert ckpt.latest_step(d) == 7
    ts = TrainState.from_tree(ckpt.restore(d, tr._last_state)[0])
    assert int(ts.step) == 7 and ts.tree().keys() == {"params", "opt_state", "step"}


def test_straggler_watchdog():
    events = []
    wd = StragglerWatchdog(window=16, threshold=1.5, min_samples=8,
                           on_straggler=lambda s, t, p: events.append(s))
    for i in range(32):
        wd.observe(i, 0.1)
    assert not wd.observe(32, 0.12)
    assert wd.observe(33, 0.5)
    assert events == [33]


def test_grad_clip():
    g = {"w": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0, rel=1e-5)


def test_compressed_step_runs_and_frontend_models_train():
    """The compressed step (``Runtime(mesh, grad_compress)``, four groups on
    one device) builds and runs a step with both residuals live; ``lm_loss``
    gives a finite loss on reduced llava-next-34b (vlm: patches ahead of the
    text) and hubert-xlarge (audio: frames in, framewise classes out)."""
    from repro_torch.dist.collectives import GradCompressConfig
    from repro_torch.dist.sharding import Mesh
    from repro_torch.models.lm import lm_loss
    from repro_torch.train.state import init_grad_err

    arch, state, _, stream = _setup()
    mesh = Mesh.on_device("cpu", data=4)
    step = build_train_step(arch, adamw(), Runtime(mesh=mesh, grad_compress=GradCompressConfig()),
                            lr_schedule=lambda s: torch.tensor(2e-3, dtype=torch.float32))
    state["grad_err"] = init_grad_err(state["params"], 4)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in stream.batch(0).items()})
    assert int(state["step"]) == 1 and torch.isfinite(m["loss"])
    for part in ("local", "server"):
        assert sum(float(t.abs().sum()) for _, t in
                   tree_leaves_with_path(state["grad_err"][part])) > 0
    for name in ("llava-next-34b", "hubert-xlarge"):  # the vlm and audio families
        a = reduced(get_arch(name))
        p = init_lm(torch.Generator().manual_seed(0), a, device="cpu")
        g = torch.Generator().manual_seed(1)
        si = a.frontend.seq_len  # patches or frames
        S = si + (8 if a.family == "vlm" else 0)
        b = {"frontend_embeds": torch.randn(1, si, a.d_model, generator=g),
             "targets": torch.randint(0, a.n_classes or a.vocab, (1, S), generator=g)}
        if a.family == "vlm":
            b["tokens"] = torch.randint(0, a.vocab, (1, 8), generator=g)
        loss, _ = lm_loss(p, a, b)
        assert torch.isfinite(loss)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    out = str(tmp_path / "hist.json")
    res = main(["--device", "cpu", "--arch", "smollm-135m", "--reduced", "--steps", "6",
                "--batch", "4", "--seq", "32", "--json-out", out])
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert os.path.exists(out)
    assert "loss " in capsys.readouterr().out


def test_launcher_grad_compress_on_one_device_and_a_missing_card(capsys):
    """``--grad-compress-bits 8`` on one CPU device says, as the reference
    does, that there is no multi-device data axis, and trains uncompressed;
    the default device is the card, and without one the launcher raises."""
    from repro_torch.launch.train import main

    res = main(["--device", "cpu", "--arch", "smollm-135m", "--reduced", "--steps", "3",
                "--batch", "4", "--seq", "16", "--grad-compress-bits", "8",
                "--grad-compress-scale", "column"])
    assert "grad-compress requested but no multi-device data axis: running uncompressed" in \
        capsys.readouterr().out
    assert "grad_err" not in res.state and np.isfinite(res.history[-1]["loss"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):  # the default device is the card
        main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])


def _op_calls():
    """Each op on small CPU inputs, with the argument autograd may record."""
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=g)
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.tensor([5], dtype=torch.int32)
    return {
        "int_matmul": lambda x: ops.int_matmul(
            x, torch.randint(-8, 8, (16, 4), generator=g, dtype=torch.int8),
            scale=torch.ones(4), aq_scale=0.05),
        "a2q_quantize": lambda v: ops.a2q_quantize(v, torch.zeros(4), torch.full((4,), -6.0),
                                                   weight_bits=8, acc_bits=16, input_bits=8,
                                                   input_signed=True),
        "flash_attention": lambda q: ops.flash_attention(q, f(1, 2, 5, 8), f(1, 2, 5, 8)),
        "paged_attention": lambda q: ops.paged_attention(q, f(3, 4, 1, 8), f(3, 4, 1, 8), bt,
                                                         lengths),
        "paged_mla_attention": lambda q: ops.paged_mla_attention(
            q, f(1, 2, 4), f(3, 4, 8), f(3, 4, 4), bt, lengths, scale=0.25),
        "rwkv6_scan": lambda r: ops.rwkv6_scan(r, f(1, 2, 3, 4), f(1, 2, 3, 4),
                                               torch.rand(1, 2, 3, 4, generator=g), f(2, 4)),
    }, {
        "int_matmul": (2, 16), "a2q_quantize": (16, 4), "flash_attention": (1, 2, 5, 8),
        "paged_attention": (1, 2, 8), "paged_mla_attention": (1, 2, 8), "rwkv6_scan": (1, 2, 3, 4),
    }


@pytest.mark.parametrize("op", ["int_matmul", "a2q_quantize", "flash_attention",
                                "paged_attention", "paged_mla_attention", "rwkv6_scan"])
def test_kernel_ops_refuse_autograd(op):
    """An input that requires grad raises while grad mode is on, on the CPU
    as on the card (the kernel would return a tensor with no grad_fn and
    silently drop the gradient); the same call runs under no_grad."""
    calls, shapes = _op_calls()
    x = torch.randn(*shapes[op], generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no backward"):
        calls[op](x.clone().requires_grad_())
    with torch.no_grad():
        calls[op](x.clone().requires_grad_())
    calls[op](x)  # nothing recorded: runs
