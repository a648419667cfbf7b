"""Test configuration: run everything on CPU with 8 virtual devices.

Sharding/pjit tests exercise a virtual 8-device mesh; single-device numeric
tests just use cpu:0. The platform is pinned through jax.config before any
backend is initialized, so the suite never opens an accelerator.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which decides at run time (never at import) whether a card is
present and skips with a reason otherwise; ``python chip_smoke.py`` runs
the same paths on the card.
"""

import functools
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Auto-mesh (Engine builds an 8-device mesh by default on multi-device
# hosts) stays OFF for the suite baseline -- the sharded paths are
# exercised deliberately by test_parallel.py / test_auto_mesh.py with
# explicit meshes or env overrides.
os.environ.setdefault("BRUTEFIR_TPU_MESH", "off")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped on the CPU suite")


@pytest.fixture
def rng():
    return np.random.default_rng(0xB1F)


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided when the test runs)."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU; run python chip_smoke.py on the card")


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the engine's Triton MAC through the Pallas interpreter, so
    the CPU suite drives the same kernel the card compiles."""
    from brutefir_tpu.ops import triton_mac
    monkeypatch.setattr(triton_mac, "available", lambda: True)
    monkeypatch.setattr(
        triton_mac, "triton_spectral_mac",
        functools.partial(triton_mac.triton_spectral_mac, interpret=True))
