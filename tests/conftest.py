"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device behavior is validated without accelerators by forcing the
host platform to expose 8 devices (SURVEY.md §4.5). With RUN_CHIP_TESTS=1
the real backend is kept instead, so that the tests marked `chip` run on
the GPU:

    RUN_CHIP_TESTS=1 python -m pytest tests/ -m chip -q

Elsewhere those tests skip, decided by a fixture at run time.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("MPLBACKEND", "Agg")

import jax
import pytest

if os.environ.get("RUN_CHIP_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU (run with RUN_CHIP_TESTS=1 on one)")


@pytest.fixture(autouse=True)
def _chip_only(request):
    if (request.node.get_closest_marker("chip")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: set RUN_CHIP_TESTS=1 on a machine with one")
