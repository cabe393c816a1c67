"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

The output directory is keyed by a hash of the source and the flags, under
``build/`` at the repository root (listed in ``.gitignore``), so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here runs
at import time: the first CUDA call of a kernel builds and loads it.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``), else
from ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("int_matmul", "paged_attention", "paged_mla_attention", "rwkv6_scan",
           "a2q_quantize", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(name, path, process or None, temporary output)``."""
    out = _lib_path(name)
    if out.exists():
        return name, out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, out, proc, tmp


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every named source in parallel (one ``nvcc`` each) and return
    the compiler's messages per source (register and shared-memory use from
    ``-Xptxas -v``; empty for a library that was already built).  Raises on
    the first failed build, after every started compiler has exited."""
    started = [_start(n) for n in names]
    logs, failed = {}, []
    for name, out, proc, tmp in started:
        if proc is None:
            logs[name] = ""
            continue
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
