"""Shared pytest config: register the ``slow`` marker and the ``--runslow``
flag.  ``slow`` tests spawn 8-fake-device subprocesses (tests must not set
``XLA_FLAGS`` in-process) and are skipped by default so the tier-1 command
stays fast; run them with ``pytest --runslow``.

The module-scoped cache purge below keeps the full suite viable in one
process: each module compiles its own engines/kernels (cross-module jit
reuse is ~zero — wrappers are per-instance), and with 300+ tests the
accumulated live XLA CPU executables eventually segfault the compiler on a
later, otherwise-innocent compile.  Dropping the caches at module teardown
bounds the live-executable count at no recompile cost."""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    yield
    jax.clear_caches()


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run @pytest.mark.slow multi-device subprocess tests",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess test (run with --runslow)"
    )
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; skips without a CUDA card"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow subprocess test: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
