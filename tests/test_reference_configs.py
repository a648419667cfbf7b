"""End-to-end runs of the reference's shipped configs.

bench1..bench5 and xtc_config (tests/data/, the shapes SURVEY.md section 4
documents for the reference tree) are run with their device blocks
redirected from /dev/zero -> random input files and
/dev/null (or alsa) -> output files, then checked against numpy oracles.
This is the reference's own validation strategy (SURVEY 4): the benchmark
configs double as integration tests and file-to-file runs are the
regression oracle.
"""

import os
import re

import numpy as np
import pytest
import scipy.signal

from brutefir_tpu.config import parse_config, IN, OUT
from brutefir_tpu.core.sampleformat import parse_sample_format
from brutefir_tpu.core.codecs import Overflow, quantize_no_dither
from brutefir_tpu.runtime import Engine

REF = os.path.join(os.path.dirname(__file__), "data")


def load_ref_config(name):
    with open(f"{REF}/{name}") as fh:
        return fh.read()


def redirect_devices(text, in_path, out_path):
    text = re.sub(r'device:\s*"file"\s*{\s*path:\s*"/dev/zero";\s*}',
                  f'device: "file" {{ path: "{in_path}"; }}', text)
    text = re.sub(r'device:\s*"file"\s*{\s*path:\s*"/dev/null";\s*}',
                  f'device: "file" {{ path: "{out_path}"; }}', text)
    text = re.sub(r'device:\s*"alsa"\s*{[^}]*}',
                  lambda m: (f'device: "file" {{ path: "{in_path}"; }}'
                             if redirect_devices.first_alsa_in(m) else
                             f'device: "file" {{ path: "{out_path}"; }}'),
                  text)
    return text


def _alsa_flipper():
    state = {"n": 0}

    def first(m):
        state["n"] += 1
        return state["n"] == 1
    return first


def write_s24_4le(path, rows):
    """rows [C, n] int32 -> interleaved S24_4LE file."""
    np.ascontiguousarray(rows.T.astype("<i4")).tofile(path)


def read_s24_4le(path, channels):
    a = np.fromfile(path, dtype="<i4")
    return a.reshape(-1, channels).T


def quantize_ref(x, fmt):
    return quantize_no_dither(np.asarray(x, np.float32), fmt,
                              Overflow(max=fmt.imax))


@pytest.fixture
def s24(request):
    return parse_sample_format("S24_4LE")


def run_config(tmp_path, name, x_int, channels, scale_blocks=None,
               shrink=None):
    """Run a redirected reference config on the given integer input rows."""
    text = load_ref_config(name)
    if shrink:  # optionally reduce filter_length for test speed
        text = re.sub(r"filter_length:\s*\d+(,\d+)?;", shrink, text, count=1)
    inp = tmp_path / "in.raw"
    outp = tmp_path / "out.raw"
    redirect_devices.first_alsa_in = _alsa_flipper()
    text = redirect_devices(text, inp, outp)
    text = text.replace('modules_path: ".";', '')
    text = text.replace('convolver_config: ".fftw3wisdom";', '')
    write_s24_4le(inp, x_int)
    conf = parse_config(text, name)
    eng = Engine(conf)
    stats = eng.run()
    return conf, stats, outp


def test_bench3_single_partition_dirac(tmp_path, rng, s24):
    n = 512 * 3
    x = rng.integers(-(1 << 20), 1 << 20, (26, n)).astype(np.int32)
    conf, stats, outp = run_config(
        tmp_path, "bench3_config", x, 26,
        shrink="filter_length: 512;")
    y = read_s24_4le(outp, 26)
    assert y.shape[1] == n
    # dirac passthrough: quantize(float(x)) == x
    np.testing.assert_array_equal(y, x)


def test_bench2_partitioned_dirac(tmp_path, rng, s24):
    n = 256 * 8
    x = rng.integers(-(1 << 20), 1 << 20, (26, n)).astype(np.int32)
    conf, stats, outp = run_config(
        tmp_path, "bench2_config", x, 26,
        shrink="filter_length: 256,8;")
    y = read_s24_4le(outp, 26)
    np.testing.assert_array_equal(y, x)


def test_bench1_cascaded_diracs(tmp_path, rng, s24):
    n = 256 * 6
    x = rng.integers(-(1 << 18), 1 << 18, (2, n)).astype(np.int32)
    conf, stats, outp = run_config(
        tmp_path, "bench1_config", x, 2,
        shrink="filter_length: 256,8;")
    y = read_s24_4le(outp, 2)
    # graph: out0 = dirac(f2(x0) + f5(x1)), out1 = dirac(f3(x0) + f4(x1)),
    # every filter a dirac -> both outputs are x0 + x1 (within quantization)
    expect = quantize_ref((x[0] + x[1]).astype(np.float32), s24)
    np.testing.assert_allclose(y[0], expect, atol=1)
    np.testing.assert_allclose(y[1], expect, atol=1)


def test_bench5_crossfade_script_identity(tmp_path, rng, s24):
    """Script flips dirac<->dirac every block with crossfade: identity."""
    n = 128 * 8
    x = rng.integers(-(1 << 18), 1 << 18, (26, n)).astype(np.int32)
    conf, stats, outp = run_config(
        tmp_path, "bench5_config", x, 26,
        shrink="filter_length: 128,8;")
    y = read_s24_4le(outp, 26)
    # crossfading between two identical (dirac) responses is the identity
    np.testing.assert_allclose(y, x, atol=1)


def test_bench4_kitchen_sink_oracle(tmp_path, rng, s24):
    """Mixed formats, mapping, per-edge gains/polarity, pre-delay, dither,
    filter cascades: full semantic oracle in numpy."""
    N, B = 128, 13
    n = N * 8
    # device 1: 4-channel S24_4LE file, uses phys 0,3 -> six virtual inputs
    # amplitudes kept below S16 clipping after the summing graph
    x4 = rng.integers(-(1 << 12), 1 << 12, (4, n)).astype(np.int32)
    # device 2: 2-channel S8 file -> virtual inputs 6,7
    x8 = rng.integers(-4, 4, (2, n)).astype(np.int32)

    text = load_ref_config("bench4_config")
    text = re.sub(r"filter_length:\s*\d+,\d+;", f"filter_length: {N},{B};",
                  text, count=1)
    in1, in2 = tmp_path / "in1.raw", tmp_path / "in2.raw"
    out1, out2 = tmp_path / "out1.raw", tmp_path / "out2.raw"
    write_s24_4le(in1, x4)
    np.ascontiguousarray(x8.T.astype(np.int8)).tofile(in2)
    reps = iter([f'device: "file" {{ path: "{p}"; }}'
                 for p in (in1, in2, out1, out2)])
    text = re.sub(r'device:\s*"file"\s*{[^}]*}', lambda m: next(reps), text)
    text = text.replace('modules_path: ".";', '')
    text = text.replace('convolver_config: ".fftw3wisdom";', '')
    conf = parse_config(text, "bench4")
    eng = Engine(conf)
    eng.run()

    # oracle: virtual inputs (normalized float domain)
    s = 1.0 / (1 << 23)
    v = {0: x4[0] * s, 1: x4[3] * s, 2: x4[0] * s, 3: x4[3] * s,
         4: x4[0] * s, 5: x4[3] * s,
         6: x8[0] / 128.0, 7: x8[1] / 128.0}
    v = {k: np.asarray(a, np.float64) for k, a in v.items()}

    def delay_blocks(a, blocks):
        d = blocks * N
        return np.concatenate([np.zeros(d), a[: len(a) - d]])

    g = lambda db: 10 ** (-db / 20.0)
    # filter 0: from 0//-1, 1//2; delay 1 block; coeff dirac(13 blocks)
    f0 = delay_blocks(-v[0] + 2.0 * v[1], 1)
    # filter 1: from inputs 6, 2 and filter 0 at -3 dB; coeff dirac(1 block)
    f1 = v[6] + v[2] + g(3.0) * f0
    # filter 2: from filters 0, 1; inputs 3,4,5,7
    f2 = f0 + f1 + v[3] + v[4] + v[5] + v[7]
    # output 0 (S16_LE, dithered): f0*g(3) + f2; output 1 (FLOAT_NE): f1*g(5.32) + f2
    y0_f = (g(3.0) * f0 + f2) * (1 << 15)
    y1_f = g(5.32) * f1 + f2

    y0 = np.fromfile(out1, "<i2").astype(np.float64)
    y1 = np.fromfile(out2, "<f4").astype(np.float64)
    assert len(y0) == n and len(y1) == n
    # float output matches the semantic oracle essentially exactly
    np.testing.assert_allclose(y1, y1_f, rtol=0, atol=1e-7 + 1e-6 * np.abs(y1_f).max())
    # dithered 16-bit output: HP-TPDF dither + error feedback bounds the
    # deviation from the ideal value to a few LSB
    assert np.abs(y0 - y0_f).max() < 5.0


@pytest.fixture
def xtc_coeffs():
    """The reference's measured crosstalk filters; the repository does
    not carry them, so the test skips where they are absent."""
    paths = [os.path.join(REF, f"{n}.txt") for n in ("directpath",
                                                     "crosspath")]
    if not all(os.path.exists(p) for p in paths):
        pytest.skip("directpath.txt / crosspath.txt (the reference's "
                    "measured XTC filters) are not in tests/data")


def test_xtc_config_real_coefficients(tmp_path, rng, xtc_coeffs):
    """The reference's real 2x2 crosstalk canceller: directpath.txt /
    crosspath.txt TEXT coefficients at 64x64 partitioning vs scipy."""
    N, B = 64, 64
    n = N * 80
    x = rng.integers(-(1 << 20), 1 << 20, (2, n)).astype(np.int32)

    text = load_ref_config("xtc_config")
    inp, outp = tmp_path / "in.raw", tmp_path / "out.raw"
    # S24_LE (3-byte) 26-channel device, channels 24,25 used
    flip = _alsa_flipper()
    text = re.sub(r'device:\s*"alsa"\s*{[^}]*}',
                  lambda m: (f'device: "file" {{ path: "{inp}"; }}'
                             if flip(m) else
                             f'device: "file" {{ path: "{outp}"; }}'), text)
    text = text.replace('filename: "directpath.txt"',
                        f'filename: "{REF}/directpath.txt"')
    text = text.replace('filename: "crosspath.txt"',
                        f'filename: "{REF}/crosspath.txt"')
    # build the 26-channel interleaved S24_LE input (only 24,25 nonzero)
    frames = np.zeros((n, 26), np.int32)
    frames[:, 24] = x[0]
    frames[:, 25] = x[1]
    b = np.empty((n, 26, 3), np.uint8)
    u = frames.astype(np.uint32)
    b[..., 0] = u & 0xFF
    b[..., 1] = (u >> 8) & 0xFF
    b[..., 2] = (u >> 16) & 0xFF
    b.tofile(inp)
    conf = parse_config(text, "xtc")
    eng = Engine(conf)
    eng.run()

    raw = np.fromfile(outp, np.uint8).reshape(n, 26, 3)
    vv = (raw[..., 0].astype(np.uint32) | (raw[..., 1].astype(np.uint32) << 8)
          | (raw[..., 2].astype(np.uint32) << 16))
    y = ((vv << 8).astype(np.int32) >> 8)[:, [24, 25]].T.astype(np.float64)

    taps = {}
    for nm in ("directpath", "crosspath"):
        vals = [float(line.split()[0])
                for line in open(f"{REF}/{nm}.txt") if line.strip()]
        taps[nm] = np.asarray(vals[: N * B], np.float64)
    xl = x[0].astype(np.float64)
    xr = x[1].astype(np.float64)
    conv = lambda a, h: scipy.signal.fftconvolve(a, h)[: n]
    # left out = direct(left) + cross(right); right sym. (dither: true)
    el = conv(xl, taps["directpath"]) + conv(xr, taps["crosspath"])
    er = conv(xr, taps["directpath"]) + conv(xl, taps["crosspath"])
    # float32 engine + 24-bit dithered quantization: allow small error
    tol = 4.0 + 2e-6 * max(np.abs(el).max(), np.abs(er).max())
    assert np.abs(y[0] - el).max() < tol
    assert np.abs(y[1] - er).max() < tol

    # the dither is fixed-seeded (dither.c:105 tausinit(state,0)), so the
    # S24_LE byte stream is reproducible: pin it like the bench goldens
    from test_fullshape_parity import check_golden
    check_golden("xtc_64x64_real_coeffs_dithered_s24",
                 np.fromfile(outp, np.uint8).tobytes())
