"""bench.py on the CPU: it refuses to measure without a GPU, and its
timers and HLO summary work (at a tiny shape; the numbers mean nothing
here)."""

import os
import subprocess
import sys

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert not r.stdout.strip()


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(bench, "N", 256)
    monkeypatch.setattr(bench, "B", 4)
    # the bench picks each MAC through the environment; restore it after
    monkeypatch.delenv("BRUTEFIR_TPU_MAC", raising=False)


def test_step_cells_time_each_mac(tiny, tmp_path, triton_interpret):
    cells = bench.step_cells(str(tmp_path), ["jnp", "triton"], 2)
    assert set(cells) == {"flagship_jnp", "flagship_triton", "scale_jnp",
                          "scale_triton"}
    for c in cells.values():
        assert c["device_step_ms"] > 0 and len(c["samples_ms"]) == 2


def test_mac_fusions_lists_fusions(tiny, tmp_path):
    rec = bench.mac_fusions(str(tmp_path), str(tmp_path / "hlo"))
    assert set(rec) == {"flagship_uniform", "scale_distinct"}
    assert all(rec.values())
    assert sorted(os.listdir(tmp_path / "hlo")) == [
        "mac_flagship_uniform.hlo.txt", "mac_scale_distinct.hlo.txt"]
