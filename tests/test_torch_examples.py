"""The examples' twins on the CPU against the reference examples.

Each reference example runs in this process on the CPU and its parameters
are caught where it draws them (``init_linear`` / ``init_lm``, wrapped); its
twin (``examples/*_torch.py``, ``--device cpu``) runs from those same
parameters (its own draw replaced by them: the two packages' random streams
differ), and every figure the twin prints is held to the reference's:

* ``quickstart``: every line equal (the bounds, the deployed codes' max
  l1 and sparsity, the accumulator audits);
* ``serve_lm``: the arch line equal and every request's tokens equal;
* ``train_lm_a2q``: three adamw steps of smollm-135m at ``--scale 0.05``:
  the arch line equal, the first loss (printed to 3 decimals) within one
  unit of its last digit and the last within two (two updates of adam move an element by about
  the lr whatever its gradient's rounding), the A2Q invariant line's
  verdict equal and its
  worst |w|_1 within 1 code of the reference's (a code at a truncation tie
  may land on either side).
"""

import importlib.util
import re
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np

from repro.nn.module import unbox

from repro_torch.convert import from_jax_numpy

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_port(tree):
    return from_jax_numpy(jax.tree.map(np.asarray, unbox(tree)))


def _caught(mod, name):
    """Wrap ``mod.name`` (a reference initializer) to keep what it returns,
    as the port's tensors (copied at once: a donating step frees the
    reference's arrays)."""
    got = []
    orig = getattr(mod, name)

    def wrapper(*a, **k):
        out = orig(*a, **k)
        got.append(_as_port(out))
        return out

    return mock.patch.object(mod, name, wrapper), got


def test_quickstart_twin_prints_the_reference(capsys):
    import repro.nn.linear as jlinear

    patch, got = _caught(jlinear, "init_linear")
    with patch:
        _load("quickstart")
    ref = capsys.readouterr().out.splitlines()
    twin = _load("quickstart_torch")
    with mock.patch.object(twin, "init_linear", lambda *a, **k: got[0]):
        twin.main(["--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert len(ref) == 5 and mine == ref


def test_serve_lm_twin_serves_the_reference_tokens(capsys):
    ref_mod = _load("serve_lm")
    patch, got = _caught(ref_mod, "init_lm")
    with patch:
        ref_mod.main()
    ref = capsys.readouterr().out.splitlines()
    twin = _load("serve_lm_torch")
    with mock.patch.object(twin, "init_lm", lambda *a, **k: got[0]):
        twin.main(["--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert mine[0] == ref[0]
    reqs = [line for line in ref if line.startswith("req ")]
    assert len(reqs) == 5
    assert [line for line in mine if line.startswith("req ")] == reqs
    assert mine[-1].split(",")[0] == ref[-1].split(",")[0]  # "40 tokens"


def _figures(lines):
    arch = next(line for line in lines if line.startswith("arch:"))
    loss = next(line for line in lines if line.startswith("loss:"))
    inv = next(line for line in lines if line.startswith("A2Q invariant"))
    first, last = map(float, re.findall(r"-?\d+\.\d+", loss.split(":", 1)[1]))
    worst = float(re.search(r"worst \|w\|_1 = ([\d.]+)", inv).group(1))
    return arch, first, last, inv.split(":")[0], inv.rsplit(":", 1)[1].strip(), worst


def test_train_lm_a2q_twin_trains_as_the_reference(capsys, tmp_path):
    argv = ["--steps", "3", "--scale", "0.05", "--batch", "2", "--seq", "16"]
    ref_mod = _load("train_lm_a2q")
    patch, got = _caught(ref_mod, "init_lm")
    with patch, mock.patch.object(sys, "argv", ["train_lm_a2q.py", *argv, "--ckpt-dir",
                                                str(tmp_path / "ref")]):
        ref_mod.main()
    ref = _figures(capsys.readouterr().out.splitlines())
    twin = _load("train_lm_a2q_torch")
    with mock.patch.object(twin, "init_lm", lambda *a, **k: got[0]):
        twin.main([*argv, "--ckpt-dir", str(tmp_path / "twin"), "--device", "cpu"])
    mine = _figures(capsys.readouterr().out.splitlines())
    assert mine[0] == ref[0]
    assert abs(mine[1] - ref[1]) <= 1e-3 + 1e-9  # one unit of the 3 printed decimals
    assert abs(mine[2] - ref[2]) <= 2e-3 + 1e-9
    assert mine[3:5] == ref[3:5] and mine[4] == "OK"
    assert abs(mine[5] - ref[5]) <= 1.0
