"""Coverage of rarer branches: BE formats e2e, multi-device EOF, text loop,
runtime cfd, EQ phase response."""

import numpy as np
import pytest
import scipy.signal

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime import Engine


def test_big_endian_e2e(tmp_path, rng):
    N = 128
    x = (rng.standard_normal(N * 3) * 8000).astype(">i2")
    inp, outp = tmp_path / "in.s16be", tmp_path / "out.s16be"
    x.tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S16_BE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S16_BE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype=">i2")
    np.testing.assert_array_equal(y, x)


def test_multi_device_eof_shortest_wins(tmp_path, rng):
    """Two input devices of different lengths: output truncates at the
    shorter one (first EOF drives the drain, dai.c:1312-1332)."""
    N = 64
    xa = rng.standard_normal(N * 4).astype(np.float32)
    xb = rng.standard_normal(N * 2 + 17).astype(np.float32)
    ina, inb = tmp_path / "a.f32", tmp_path / "b.f32"
    outp = tmp_path / "out.f32"
    xa.astype("<f4").tofile(ina)
    xb.astype("<f4").tofile(inb)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{ina}"; }}; sample: "FLOAT_LE"; channels: 1; }};
input 1 {{ device: "file" {{ path: "{inb}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0/120, 1; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype="<f4")
    assert len(y) == len(xb)  # shorter stream defines the length
    # 0/120: input 0 at -120 dB (inaudible); output ~ xb
    np.testing.assert_allclose(y, xb[: len(y)], atol=1e-3)


def test_text_mode_loop(tmp_path, rng):
    N = 32
    seg = rng.standard_normal(N).astype(np.float64)
    inp, outp = tmp_path / "in.txt", tmp_path / "out.txt"
    inp.write_text("\n".join("%+.16e" % v for v in seg) + "\n")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; text: true; loop: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; text: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run(max_blocks=4)
    y = np.array([float(v) for v in outp.read_text().split()])
    assert len(y) == 4 * N
    for b in range(4):
        np.testing.assert_allclose(y[b * N: (b + 1) * N], seg, atol=1e-5)


def test_runtime_cfd_via_script(tmp_path, rng):
    """cfd changes the filter pre-delay at a block boundary."""
    N, B = 64, 4
    x = rng.standard_normal(N * 8).astype(np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: "cli" {{ echo: false; script: "sleep b3;\\ncfd 0 2;\\nsleep b100;"; }};
coeff 0 {{ filename: "dirac pulse"; blocks: 1; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype="<f4")
    # blocks 0..3 pass through (cfd lands at block 4's snapshot)
    np.testing.assert_allclose(y[: 4 * N], x[: 4 * N], atol=1e-4)
    # from block 4 the output is the input delayed 2 blocks
    np.testing.assert_allclose(y[6 * N: 8 * N], x[4 * N: 6 * N], atol=1e-4)


def test_eq_phase_render(tmp_path, rng):
    """A 90-degree phase EQ applies the requested phase rotation at the
    band frequency (checked via cross-spectrum phase)."""
    N, B = 256, 2
    sr = 44100
    f0 = sr / 8  # aligned with an rfft bin of the total length
    x = np.sin(2 * np.pi * f0 / sr * np.arange(N * 16)).astype(np.float32) * 0.3
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: {sr};
filter_length: {N},{B};
logic: "eq" {{ coeff: 0, 1; bands: 2000, {f0:.0f}, 10000;
              phase: {f0:.0f}/90; }};
coeff 0 {{ filename: "dirac pulse"; shared_mem: true; }};
coeff 1 {{ filename: "dirac pulse"; shared_mem: true; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype="<f4")
    taps = N * B
    # steady-state region past the EQ's linear-phase latency (taps/2)
    a = x[8 * N: 14 * N].astype(np.float64)
    b = y[8 * N + taps // 2: 14 * N + taps // 2].astype(np.float64)
    # phase of the cross-spectrum at f0; reference phase units are
    # value/(180*pi) radians-ish: 90 -> 90/(180*pi) rad = 0.159 rad
    fa = np.fft.rfft(a)
    fb = np.fft.rfft(b)
    k = int(round(f0 / sr * len(a)))
    dphi = np.angle(fb[k] / fa[k])
    expect = 90.0 / (180.0 * np.pi)  # the reference's unit conversion
    assert abs(dphi - expect) < 0.02


def test_device_io_with_virtual_mapping(tmp_path, rng):
    """The on-device codec handles many-virtual-per-physical mapping on
    both sides (input duplication, output mixing)."""
    N = 128
    x = (rng.standard_normal((2, N * 3)) * 100000).astype(np.int32)
    inp, outp = tmp_path / "in.raw", tmp_path / "out.raw"
    np.ascontiguousarray(x.T.astype("<i4")).tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1,2,3 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE";
             channels: 2; mapping: 0,1,0,1; }};
output 0,1,2 {{ device: "file" {{ path: "{outp}"; }}; sample: "S32_LE";
             channels: 2; mapping: 0,1,0; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
filter 2 {{ from_inputs: 2//0.5; to_outputs: 2; coeff: 0; }};
""")
    eng = Engine(conf)
    assert eng.dio is not None
    eng.run()
    y = np.fromfile(outp, dtype="<i4").reshape(-1, 2).T
    # phys 0 = virt out 0 + virt out 2 = x0 + 0.5*x0 = 1.5 x0 (quantized)
    np.testing.assert_allclose(y[0], np.round(1.5 * x[0]), atol=1)
    np.testing.assert_allclose(y[1], x[1], atol=1)


def test_text_mode_loop_no_trailing_newline(tmp_path, rng):
    """Loop wrap inserts a token boundary: a file whose last token has no
    trailing whitespace must not merge with the first token of pass 2."""
    N = 32
    seg = rng.standard_normal(N).astype(np.float64)
    inp, outp = tmp_path / "in.txt", tmp_path / "out.txt"
    inp.write_text("\n".join("%+.16e" % v for v in seg))  # no final \n
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; text: true; loop: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; text: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run(max_blocks=4)
    y = np.array([float(v) for v in outp.read_text().split()])
    assert len(y) == 4 * N
    for b in range(4):
        np.testing.assert_allclose(y[b * N: (b + 1) * N], seg, atol=1e-5)


def test_benchmark_stage_breakdown_table(tmp_path, rng, capfd):
    """benchmark: true prints the per-stage timing table every 10 periods
    (the reference's benchmark table, bfrun.c:2035-2078)."""
    N = 128
    x = rng.standard_normal(N * 12).astype(np.float32) * 0.2
    inp = tmp_path / "in.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},2;
benchmark: true;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "/dev/null"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    err = capfd.readouterr().err
    for col in ("decode/ms", "device/ms", "encode/ms", "total/ms", "rti"):
        assert col in err


def test_watchdog_aborts_stalled_run(tmp_path, monkeypatch):
    """BRUTEFIR_TPU_WATCHDOG kills a run whose device stalls
    (here: an input device that blocks forever after one block)."""
    import os
    import subprocess
    import sys as _sys
    code = f"""
import os, sys, time
os.environ["BRUTEFIR_TPU_WATCHDOG"] = "2"
sys.path.insert(0, {repr(os.getcwd())})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime.engine import Engine
from brutefir_tpu.io import IoDevice

mp = {repr(str(tmp_path))}
os.makedirs(mp, exist_ok=True)
open(os.path.join(mp, "bfio_stall.py"), "w").write('''
import time
from brutefir_tpu.io import IoDevice, register_io_module
class Device(IoDevice):
    def read(self, nbytes):
        if getattr(self, "_n", 0) >= 2:
            time.sleep(3600)
        self._n = getattr(self, "_n", 0) + 1
        return b"\\\\x00" * nbytes
    def write(self, data):
        return len(data)
register_io_module("stall", Device)
''')
conf = parse_config(\"\"\"
sampling_rate: 44100;
filter_length: 256,2;
modules_path: "{{mp}}";
coeff 0 {{{{ filename: "dirac pulse"; }}}};
input 0 {{{{ device: "stall" {{{{}}}}; sample: "S16_LE"; channels: 1; }}}};
output 0 {{{{ device: "file" {{{{ path: "/dev/null"; }}}}; sample: "S16_LE"; channels: 1; dither: false; }}}};
filter 0 {{{{ from_inputs: 0; to_outputs: 0; coeff: 0; }}}};
\"\"\".format(mp=mp))
Engine(conf).run()
print("UNREACHABLE")
"""
    r = subprocess.run([_sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 1
    assert "stalled device" in r.stderr
    assert "UNREACHABLE" not in r.stdout
