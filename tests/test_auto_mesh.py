"""Auto-mesh: multi-device hosts shard by default (VERDICT r2 item 1).

The analog of the reference's one-filter-process-per-CPU default with
load_balance_filters (bfconf.c:2227-2318): `python -m brutefir_tpu` on a
multi-device host runs sharded with no code or config changes, and
BRUTEFIR_TPU_MESH overrides ("off", "2x4", ...).
"""

import numpy as np
import pytest
import jax

from brutefir_tpu.parallel.mesh import auto_mesh, make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def test_auto_mesh_prefers_pure_sp():
    """Flagship-like shape: bin parallelism divides -> sp-pure mesh."""
    m = auto_mesh(26, 8192, np.dtype(np.float32), env="auto")
    assert m is not None
    assert m.shape["f"] == 1 and m.shape["sp"] == 8


def test_auto_mesh_env_off():
    assert auto_mesh(26, 8192, np.dtype(np.float32), env="off") is None
    assert auto_mesh(26, 8192, np.dtype(np.float32), env="1") is None


def test_auto_mesh_env_explicit():
    m = auto_mesh(26, 8192, np.dtype(np.float32), env="2x4")
    assert m.shape["f"] == 2 and m.shape["sp"] == 4


def test_auto_mesh_dense_divisible():
    """Bins that are not a power of two still shard evenly on sp."""
    m = auto_mesh(4, 96, np.dtype(np.float32), env="auto")
    assert m is not None
    f, sp = m.shape["f"], m.shape["sp"]
    assert 96 % sp == 0


def test_auto_mesh_filter_axis_rescue():
    """Nothing divides the bins: the filter axis (or a smaller device
    count) still yields a working mesh."""
    m = auto_mesh(7, 100, np.dtype(np.float32), env="auto")
    assert m is not None
    f, sp = m.shape["f"], m.shape["sp"]
    assert (f == 1 or 7 % f == 0) and 100 % sp == 0


def test_auto_mesh_single_device():
    assert auto_mesh(26, 8192, np.dtype(np.float32),
                     devices=jax.devices()[:1], env="auto") is None


def test_engine_auto_shards(tmp_path, rng, monkeypatch):
    """Engine(conf) with no mesh argument picks up the auto mesh from the
    environment default and produces the same audio as the unsharded
    engine."""
    import scipy.signal
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine

    N, B, C = 128, 4, 2
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = rng.standard_normal((C, N * 4)).astype(np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    np.ascontiguousarray(x.T.astype("<f4")).tofile(inp)
    chans = ",".join(str(i) for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; }};"
        for i in range(C))
    cfg = f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
"""
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "2x4")
    conf = parse_config(cfg)
    conf.quiet = True
    eng = Engine(conf)
    assert eng.mesh is not None
    assert eng.mesh.shape["f"] == 2 and eng.mesh.shape["sp"] == 4
    eng.run()
    y = np.fromfile(outp, dtype="<f4").reshape(-1, C).T
    for c in range(C):
        ref = scipy.signal.fftconvolve(x[c], taps)[: x.shape[1]]
        np.testing.assert_allclose(y[c], ref, rtol=0, atol=2e-3)


def test_engine_mesh_off_by_env(tmp_path, rng, monkeypatch):
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    x = np.zeros(256, np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 128;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "off")
    eng = Engine(conf)
    assert eng.mesh is None


def test_run_offline_batched_under_mesh(tmp_path, rng, monkeypatch):
    """Scan-batched offline dispatch (run_offline) now works sharded:
    the dio multi_step jit carries the mesh shardings."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    from brutefir_tpu.parallel import make_mesh

    N, B, C = 128, 2, 4
    x = np.clip((rng.standard_normal((N * 8, C)) * 2**20).round(),
                -(2**23), 2**23 - 1).astype("<i4")
    inp, outp = tmp_path / "in.raw", tmp_path / "out.raw"
    x.tofile(inp)
    chans = ",".join(str(i) for i in range(C))
    cfg = f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "S24_4LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
""" + "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; }};"
        for i in range(C))
    conf = parse_config(cfg)
    conf.quiet = True
    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    eng = Engine(conf, mesh=mesh)
    assert eng.dio is not None
    stats = eng.run_offline(batch_blocks=4)
    assert stats["frames"] == N * 8
    y = np.fromfile(outp, dtype="<i4").reshape(-1, C)
    assert np.abs(y.astype(np.int64) - x.astype(np.int64)).max() <= 1


def test_process_setting_places(tmp_path, rng, capsys, monkeypatch):
    """filter { process: N; } maps process groups onto the 'f' mesh axis
    (bfconf.c:1024-1036); the engine reports the placement. A single
    filter pinned to process 1 still gets an f=2 mesh, landing in the
    second group's shard chunk with an inert pad row in the first."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    x = np.zeros(256, np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "auto")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 128;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; process: 1; }};
""")
    eng = Engine(conf)
    err = capsys.readouterr().err
    assert "Manual process placement" in err
    assert eng.mesh is not None and eng.mesh.shape["f"] == 2
    assert eng.spec_rows == [-1, 0]      # group 0 pad, group 1 = filter 0


def test_mesh_env_malformed_is_typed_config_error(monkeypatch):
    """A malformed BRUTEFIR_TPU_MESH aborts loudly with the config exit
    code, instead of a bare ValueError/ silent fallback."""
    from brutefir_tpu.errors import BFError, BF_EXIT_INVALID_CONFIG
    with pytest.raises(BFError) as ei:
        auto_mesh(4, 128, np.dtype(np.float32), env="2y3")
    assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG
    with pytest.raises(BFError) as ei:
        auto_mesh(4, 128, np.dtype(np.float32), env="0x2")
    assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG
    with pytest.raises(BFError) as ei:
        auto_mesh(4, 128, np.dtype(np.float32), env="4x4")  # 16 > 8 devices
    assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG


def _freqd_conf(tmp_path, rng, N=128, B=2, C=2):
    from brutefir_tpu.config import parse_config
    x = rng.standard_normal((C, N * 4)).astype(np.float32) * 0.1
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    np.ascontiguousarray(x.T.astype("<f4")).tofile(inp)
    chans = ",".join(str(i) for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; }};"
        for i in range(C))
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
""")
    conf.quiet = True
    return conf, x, outp


class _Doubler:
    def output_freqd(self, buf, ch):
        buf *= 2.0


def test_freqd_hooks_degrade_auto_mesh(tmp_path, rng, monkeypatch):
    """Auto-selected mesh + a module registering frequency-domain hooks:
    the engine degrades to a single device with a warning (a config that
    worked pre-auto-mesh keeps working), and the hook's effect lands."""
    from brutefir_tpu.runtime import Engine
    monkeypatch.setenv("BRUTEFIR_TPU_MESH", "auto")
    conf, x, outp = _freqd_conf(tmp_path, rng)
    eng = Engine(conf)
    assert eng.mesh is not None          # auto mesh selected
    eng.logic.append(_Doubler())
    eng.run()
    assert eng.mesh is None              # degraded at attach_logic
    y = np.fromfile(outp, dtype="<f4").reshape(-1, x.shape[0]).T
    np.testing.assert_allclose(y, 2.0 * x, atol=1e-4)


def test_freqd_hooks_reject_explicit_mesh(tmp_path, rng):
    """An explicitly requested mesh does NOT silently degrade: the user
    asked for multi-device, freqd hooks cannot run there, abort."""
    from brutefir_tpu.runtime import Engine
    from brutefir_tpu.runtime.engine import EngineError
    conf, _, _ = _freqd_conf(tmp_path, rng)
    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    eng = Engine(conf, mesh=mesh)
    eng.logic.append(_Doubler())
    with pytest.raises(EngineError, match="single"):
        eng.attach_logic()
