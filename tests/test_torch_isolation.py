"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
refuse to run on a CUDA device that is not there instead of falling back to
the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
BANNED = ("jax", "jaxlib", "repro")


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


def _sources():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_banned(n) for n in names), f"{path}:{node.lineno} imports {names}"


_BLOCKED_IMPORT = """
import importlib, importlib.util, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {banned!r}:
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(n.split(".")[0] in {banned!r} for n in sys.modules), sorted(sys.modules)
print("isolated")
"""


def test_port_imports_with_jax_and_reference_blocked():
    code = _BLOCKED_IMPORT.format(banned=BANNED, smoke=str(SMOKE))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_default_device_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.lm import init_cache, init_lm
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine

    arch = reduced(get_arch("smollm-135m"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_lm(torch.Generator().manual_seed(0), arch)
    params = init_lm(torch.Generator().manual_seed(0), arch, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedServeEngine(arch, params)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(arch, params)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(arch, 1, 16)
