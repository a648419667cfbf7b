"""chip_smoke.py on the CPU: its oracles, config builders and last line,
every phase at a tiny shape, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke as cs
from brutefir_tpu.config import parse_config
from brutefir_tpu.ops import partconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    return dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")


def test_refuses_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_fails_without_the_program(tmp_path):
    """Alone in a directory the script cannot import the engine."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    line = cs.last_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"NVIDIA H100 80GB HBM3", "count": {count}}}}}')
    assert json.loads(line)["device"]["count"] == count


def test_run_phase_fails_outside_tolerance(capsys):
    with pytest.raises(SystemExit) as ei:
        cs.run_phase("demo", lambda: (2.0, 1.0, "LSB"))
    assert ei.value.code != 0
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("t", [0, 5, 37])
def test_mac_oracle_matches_rotated_ring_form(rng, t):
    """The oracle (rotation on the coefficient gather, float64) equals the
    textbook form sum_i ring[(t-i) % B] * H[i] of partconv.spectral_mac,
    and its float32 bound covers the difference."""
    F, E, B, K = 3, 2, 5, 64
    ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
    bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
    idx = np.array([1, 0, 1], np.int32)
    mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    ref, bound = cs.mac_oracle(ring, bank, idx, mask, t)
    H = bank[idx] * mask[:, :, None, None]
    got = np.asarray(partconv.spectral_mac(jnp.asarray(ring), jnp.asarray(H),
                                           jnp.int32(t)), np.float64)
    assert np.all(np.abs(got - ref) <= bound)
    assert np.all(bound > 0)


def test_s24_files_roundtrip(tmp_path, rng):
    x = cs.random_s24(rng, 3, 100)
    assert np.abs(x).max() < cs.S24_AMP + 1
    cs.write_s24_4le(tmp_path / "a.raw", x)
    np.testing.assert_array_equal(cs.read_s24_4le(tmp_path / "a.raw", 3), x)
    v = np.array([[-1, 5, -(1 << 23)], [(1 << 23) - 1, 0, 7]], np.int32)
    b = np.stack([(v.T >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.uint8)
    b.tofile(tmp_path / "b.raw")
    np.testing.assert_array_equal(cs.read_s24_3le(tmp_path / "b.raw", 2), v)


@pytest.mark.parametrize("n_coeffs", [1, 4])
def test_massive_config_builds(tmp_path, n_coeffs):
    paths = [str(tmp_path / f"t{i}.raw") for i in range(n_coeffs)]
    conf = parse_config(cs.massive_config("/dev/zero", "/dev/null", paths,
                                          4, 256, 2))
    assert conf.filter_length == 256 and conf.n_blocks == 2
    assert len(conf.filters) == 4 and len(conf.coeffs) == n_coeffs
    assert [f.coeff for f in conf.filters] == (
        [0] * 4 if n_coeffs == 1 else [0, 1, 2, 3])
    assert conf.iodevs[0][0].sample_format.name == "S24_4LE"


def test_mixed_config_builds(tmp_path):
    conf = parse_config(cs.mixed_config(str(tmp_path), "/dev/zero",
                                        "/dev/null", N=256, B=2, K=4))
    assert [f.crossfade for f in conf.filters] == [False, False, True, False]
    assert conf.filters[1].delayblocks == 1
    assert conf.filters[1].out_channels == [(1, -1.0)]
    assert conf.logic_modules[0][0] == "cli"


def test_xtc_config_fills_paths():
    with open(os.path.join(REPO, "examples", "xtc_lowlatency.conf")) as fh:
        text = cs.xtc_config(fh.read(), "/d.txt", "/c.txt", "/i", "/o")
    for p in ("/d.txt", "/c.txt", "/i", "/o"):
        assert f'"{p}"' in text
    conf = parse_config(text)
    assert conf.filter_length == 64 and conf.n_blocks == 64


@pytest.mark.parametrize("phase", [
    "flagship", "scale", "mixed", "mac", "xtc", "hook", "float64"])
def test_phase_at_tiny_shape(tmp_path, phase):
    """Every phase's plumbing and oracle, at a size the CPU runs fast."""
    d = str(tmp_path)
    calls = {
        "flagship": lambda: cs.phase_flagship(d, channels=4, N=256, B=4,
                                              blocks=6, check=(0, 3)),
        "scale": lambda: cs.phase_scale(d, channels=6, N=256, B=4,
                                        blocks=4, check=(0, 5)),
        "mixed": lambda: cs.phase_mixed(d, N=256, B=4, K=8),
        "mac": lambda: cs.phase_mac(widths=((4, 1, 4, 256), (6, 6, 4, 256)),
                                    kernels=("dense",)),
        "xtc": lambda: cs.phase_xtc(d, os.path.join(
            REPO, "examples", "xtc_lowlatency.conf"), blocks=40),
        "hook": lambda: cs.phase_hook(d),
        "float64": lambda: cs.phase_float64(d, N=256, B=2, blocks=4),
    }
    err, tol, unit = calls[phase]()
    assert err <= tol, (phase, err, tol, unit)


@pytest.mark.parametrize("which", ["flagship", "scale"])
def test_four_phase_on_virtual_devices(tmp_path, which):
    """--four's comparison on the suite's virtual CPU devices: the
    auto-mesh run equals the single-device run and the oracle."""
    prior = os.environ.get("BRUTEFIR_TPU_MESH")
    err, tol, _ = cs.phase_four(str(tmp_path), which, N=512, B=4,
                                channels=8, blocks=4)
    assert os.environ.get("BRUTEFIR_TPU_MESH") == prior
    assert err <= tol
