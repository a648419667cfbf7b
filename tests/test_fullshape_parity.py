"""Full-shape, real-coefficient parity for the shipped bench configs.

The dirac-identity runs in test_reference_configs.py exercise the engine
plumbing but a sign/indexing bug that cancels under diracs would slip
through them. These tests run bench1/2/3/5 at the EXACT shipped shapes
(tests/data/bench1_config..bench5_config: 8192x8 and 65536x1,
26 channels, the 6-filter cascade, the crossfade-every-block script,
`bfrun.c:1745-1754`) with random real coefficients, file-to-file through
the real engine, against float64 scipy oracles.

Each run's integer output is also pinned by a committed sha256 golden
(tests/golden/fullshape_goldens.json): the bench configs set
`dither: false;` and the suite runs single-threaded XLA:CPU, so the
byte stream is run-to-run reproducible (SURVEY 4.5) and any numeric
drift -- a kernel change, an XLA upgrade reordering a reduction -- shows
up as a hash mismatch even when it stays inside the oracle tolerance.
Regenerate after an intentional numeric change with:

    BFTPU_UPDATE_GOLDENS=1 python -m pytest tests/test_fullshape_parity.py
"""

import hashlib
import json
import os
import re

import numpy as np
import pytest
import scipy.signal

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime import Engine

REF = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "fullshape_goldens.json")


def _load_goldens():
    if os.path.exists(GOLDEN_PATH):
        with open(GOLDEN_PATH) as fh:
            return json.load(fh)
    return {}


def check_golden(name: str, blob: bytes):
    """Assert the output byte stream matches the committed golden hash."""
    digest = hashlib.sha256(blob).hexdigest()
    goldens = _load_goldens()
    if os.environ.get("BFTPU_UPDATE_GOLDENS"):
        goldens[name] = {"sha256": digest, "bytes": len(blob)}
        os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
        with open(GOLDEN_PATH, "w") as fh:
            json.dump(goldens, fh, indent=1, sort_keys=True)
        return
    assert name in goldens, (
        f"no committed golden for {name!r}; run with BFTPU_UPDATE_GOLDENS=1")
    assert goldens[name]["bytes"] == len(blob), (
        f"{name}: output length changed "
        f"({goldens[name]['bytes']} -> {len(blob)})")
    assert goldens[name]["sha256"] == digest, (
        f"{name}: output bytes drifted from the committed golden "
        f"(oracle may still pass -- regenerate only if the numeric "
        f"change is intentional)")


def write_s24_4le(path, rows):
    np.ascontiguousarray(rows.T.astype("<i4")).tofile(path)


def read_s24_4le(path, channels):
    a = np.fromfile(path, dtype="<i4")
    return a.reshape(-1, channels).T


def make_taps(rng, n, scale):
    return (rng.uniform(-1.0, 1.0, n) * scale).astype(np.float32)


def conv64(x, h):
    return scipy.signal.fftconvolve(
        np.asarray(x, np.float64), np.asarray(h, np.float64))[: len(x)]


def run_patched(tmp_path, name, text, x_int, channels):
    inp = tmp_path / "in.raw"
    outp = tmp_path / "out.raw"
    text = re.sub(r'device:\s*"file"\s*{\s*path:\s*"/dev/zero";\s*}',
                  f'device: "file" {{ path: "{inp}"; }}', text)
    text = re.sub(r'device:\s*"file"\s*{\s*path:\s*"/dev/null";\s*}',
                  f'device: "file" {{ path: "{outp}"; }}', text)
    text = text.replace('modules_path: ".";', '')
    text = text.replace('convolver_config: ".fftw3wisdom";', '')
    write_s24_4le(inp, x_int)
    conf = parse_config(text, name)
    eng = Engine(conf)
    eng.run()
    return outp


@pytest.fixture
def rng():
    return np.random.default_rng(0xF111)


def test_bench2_fullshape_random_taps(tmp_path, rng):
    """bench2 at the shipped 8192x8: 26 ch through one 65536-tap filter."""
    N, B, C = 8192, 8, 26
    n = N * 12
    taps = make_taps(rng, N * B, 0.003)
    x = rng.integers(-(1 << 20), 1 << 20, (C, n)).astype(np.int32)

    text = open(f"{REF}/bench2_config").read()
    tapf = tmp_path / "taps.raw"
    taps.tofile(tapf)
    text = text.replace('coeff 0 { filename: "dirac pulse"; };',
                        f'coeff 0 {{ filename: "{tapf}"; '
                        f'format: "FLOAT_LE"; }};')
    outp = run_patched(tmp_path, "bench2_full", text, x, C)

    y = read_s24_4le(outp, C)
    assert y.shape == (C, n)
    for c in range(C):
        ref = conv64(x[c], taps) * (1.0)
        tol = 8e-6 * np.abs(ref).max() + 4.0
        np.testing.assert_allclose(y[c], ref, rtol=0, atol=tol)
    check_golden("bench2_8192x8_random", open(outp, "rb").read())


def test_bench3_fullshape_random_taps(tmp_path, rng):
    """bench3 at the shipped 65536x1: plain (unpartitioned) overlap-save."""
    N, C = 65536, 26
    n = N * 3
    taps = make_taps(rng, N, 0.003)
    x = rng.integers(-(1 << 20), 1 << 20, (C, n)).astype(np.int32)

    text = open(f"{REF}/bench3_config").read()
    tapf = tmp_path / "taps.raw"
    taps.tofile(tapf)
    text = text.replace('coeff 0 { filename: "dirac pulse"; };',
                        f'coeff 0 {{ filename: "{tapf}"; '
                        f'format: "FLOAT_LE"; }};')
    outp = run_patched(tmp_path, "bench3_full", text, x, C)

    y = read_s24_4le(outp, C)
    assert y.shape == (C, n)
    for c in range(C):
        ref = conv64(x[c], taps)
        tol = 8e-6 * np.abs(ref).max() + 4.0
        np.testing.assert_allclose(y[c], ref, rtol=0, atol=tol)
    check_golden("bench3_65536x1_random", open(outp, "rb").read())


def test_bench1_fullshape_cascade_random_taps(tmp_path, rng):
    """bench1 at the shipped 8192x8: the 6-filter cascade with six
    DISTINCT random 65536-tap coefficient sets (convolve_eval path,
    fftw_convolver.c:411-433)."""
    N, B = 8192, 8
    n = N * 20
    taps = [make_taps(rng, N * B, 0.003) for _ in range(6)]
    x = rng.integers(-(1 << 20), 1 << 20, (2, n)).astype(np.int32)

    text = open(f"{REF}/bench1_config").read()
    for i in range(6):
        tapf = tmp_path / f"taps{i}.raw"
        taps[i].tofile(tapf)
        text = text.replace(
            f'coeff {i} {{ filename: "dirac pulse"; }};',
            f'coeff {i} {{ filename: "{tapf}"; format: "FLOAT_LE"; }};')
    outp = run_patched(tmp_path, "bench1_full", text, x, 2)

    y = read_s24_4le(outp, 2)
    assert y.shape == (2, n)
    # graph: f2: in0 -> f0; f5: in1 -> f0; f0 -> out0 (coeff 0)
    #        f3: in0 -> f1; f4: in1 -> f1; f1 -> out1 (coeff 1)
    x0 = x[0].astype(np.float64)
    x1 = x[1].astype(np.float64)
    e0 = conv64(conv64(x0, taps[2]) + conv64(x1, taps[5]), taps[0])
    e1 = conv64(conv64(x0, taps[3]) + conv64(x1, taps[4]), taps[1])
    for c, ref in ((0, e0), (1, e1)):
        tol = 2e-5 * np.abs(ref).max() + 4.0
        np.testing.assert_allclose(y[c], ref, rtol=0, atol=tol)
    check_golden("bench1_8192x8_cascade_random", open(outp, "rb").read())


def test_bench4_fullshape_kitchen_sink_random_taps(tmp_path, rng):
    """bench4 at the shipped 4096x13: mixed input formats (S24_4LE with
    channel selection 4/0,3 + many-to-one mapping, S8), per-edge gains
    and polarity, a one-block pre-delay, a shared cascade node, a
    `blocks: 1` coefficient truncation, and the DITHERED S16 output --
    with two DISTINCT random coefficient sets, against a float64 numpy
    oracle (tests/data/bench4_config, real2raw.h:44-59).

    Both output byte streams are pinned by committed goldens: the
    dither generator is seeded with the reference's fixed seed
    (dither.c:105 analog, core/dither.py tausrand_table seed 0->1), so
    the dithered S16 stream is run-to-run reproducible."""
    N, B = 4096, 13
    n = N * 20
    # coeff 0: 13 blocks; coeff 1: a 13-block FILE truncated by the
    # config's `blocks: 1;` -- the truncation semantics at full shape
    h0 = make_taps(rng, N * B, 0.003)
    h1_file = make_taps(rng, N * B, 0.003)
    h1 = h1_file[:N].astype(np.float64)
    x4 = rng.integers(-(1 << 16), 1 << 16, (4, n)).astype(np.int32)
    x8 = rng.integers(-32, 32, (2, n)).astype(np.int32)

    text = open(f"{REF}/bench4_config").read()
    f0p, f1p = tmp_path / "h0.raw", tmp_path / "h1.raw"
    h0.tofile(f0p)
    h1_file.tofile(f1p)
    text = text.replace(
        'coeff 0 { filename: "dirac pulse"; };',
        f'coeff 0 {{ filename: "{f0p}"; format: "FLOAT_LE"; }};')
    text = text.replace(
        'coeff 1 { filename: "dirac pulse"; blocks: 1; };',
        f'coeff 1 {{ filename: "{f1p}"; format: "FLOAT_LE"; '
        f'blocks: 1; }};')
    in1, in2 = tmp_path / "in1.raw", tmp_path / "in2.raw"
    out1, out2 = tmp_path / "out1.raw", tmp_path / "out2.raw"
    write_s24_4le(in1, x4)
    np.ascontiguousarray(x8.T.astype(np.int8)).tofile(in2)
    reps = iter([f'device: "file" {{ path: "{p}"; }}'
                 for p in (in1, in2, out1, out2)])
    text = re.sub(r'device:\s*"file"\s*{[^}]*}', lambda m: next(reps),
                  text)
    text = text.replace('modules_path: ".";', '')
    text = text.replace('convolver_config: ".fftw3wisdom";', '')
    conf = parse_config(text, "bench4_full")
    eng = Engine(conf)
    eng.run()

    # oracle: virtual inputs in the normalized float domain
    s = 1.0 / (1 << 23)
    v = {0: x4[0] * s, 1: x4[3] * s, 2: x4[0] * s, 3: x4[3] * s,
         4: x4[0] * s, 5: x4[3] * s,
         6: x8[0] / 128.0, 7: x8[1] / 128.0}
    v = {k: np.asarray(a, np.float64) for k, a in v.items()}
    g = lambda db: 10 ** (-db / 20.0)

    def delay_blocks(a, blocks):
        d = blocks * N
        return np.concatenate([np.zeros(d), a[: len(a) - d]])

    # filter 0: inputs 0//-1, 1//2, one-block pre-delay, coeff 0. The
    # pre-delay rides the ring offsets, and partitions >= B - delay are
    # clamped to zero exactly like the reference (bfrun.c:1585-1591):
    # the delayed filter's effective response is h0's first B-1 blocks.
    f0 = conv64(delay_blocks(-v[0] + 2.0 * v[1], 1), h0[: N * (B - 1)])
    # filter 1: inputs 6, 2 + filter 0 at -3 dB, coeff 1 (truncated)
    f1 = conv64(v[6] + v[2] + g(3.0) * f0, h1)
    # filter 2: filters 0, 1 + inputs 3,4,5,7, coeff 0
    f2 = conv64(f0 + f1 + v[3] + v[4] + v[5] + v[7], h0)
    y0_f = (g(3.0) * f0 + f2) * (1 << 15)   # S16 integer domain
    y1_f = g(5.32) * f1 + f2                 # FLOAT_NE

    y0 = np.fromfile(out1, "<i2").astype(np.float64)
    y1 = np.fromfile(out2, "<f4").astype(np.float64)
    assert len(y0) == n and len(y1) == n
    tol1 = 1e-7 + 2e-5 * np.abs(y1_f).max()
    np.testing.assert_allclose(y1, y1_f, rtol=0, atol=tol1)
    # dithered S16: HP-TPDF + {1,-1} error feedback bounds the deviation
    # from the ideal value to a few LSB on top of the engine float error
    tol0 = 5.0 + 2e-5 * np.abs(y0_f).max()
    assert np.abs(y0 - y0_f).max() < tol0
    check_golden("bench4_4096x13_dithered_s16", open(out1, "rb").read())
    check_golden("bench4_4096x13_float", open(out2, "rb").read())


def test_bench5_fullshape_crossfade_random_taps(tmp_path, rng):
    """bench5 at the shipped 8192x8 with TWO DISTINCT random coefficient
    sets flipped by the CLI script every block, against an explicit
    time-domain linear-ramp oracle (convolver_crossfade_inplace,
    fftw_convolver.c:330-368; script pacing bflogic_cli.c:872-986)."""
    N, B, C = 8192, 8, 26
    n = N * 12
    taps_a = make_taps(rng, N * B, 0.003)
    taps_b = make_taps(rng, N * B, 0.003)
    x = rng.integers(-(1 << 20), 1 << 20, (C, n)).astype(np.int32)

    text = open(f"{REF}/bench5_config").read()
    fa, fb = tmp_path / "a.raw", tmp_path / "b.raw"
    taps_a.tofile(fa)
    taps_b.tofile(fb)
    text = text.replace(
        'coeff 0 { filename: "dirac pulse"; };',
        f'coeff 0 {{ filename: "{fa}"; format: "FLOAT_LE"; }};\n'
        f'coeff 1 {{ filename: "{fb}"; format: "FLOAT_LE"; }};')
    # the shipped script flips coeff<->dirac(-1); flip between the two
    # real sets instead
    text = text.replace(" -1;", " 1;")
    outp = run_patched(tmp_path, "bench5_full", text, x, C)

    y = read_s24_4le(outp, C)
    assert y.shape == (C, n)
    n_blocks = n // N
    ramp = np.arange(N, dtype=np.float64) / (N - 1)
    for c in range(0, C, 5):   # 6 of 26 channels: full oracle cost control
        ya = conv64(x[c], taps_a)
        yb = conv64(x[c], taps_b)
        expect = np.empty(n, np.float64)
        # script line k executes at block_start of block k (one line per
        # block, wrapping): block 0 sets coeff 0 (already 0: no change),
        # odd blocks crossfade a->b, even blocks >0 crossfade b->a
        for k in range(n_blocks):
            seg = slice(k * N, (k + 1) * N)
            if k == 0:
                expect[seg] = ya[seg]
            elif k % 2 == 1:
                expect[seg] = ya[seg] * (1 - ramp) + yb[seg] * ramp
            else:
                expect[seg] = yb[seg] * (1 - ramp) + ya[seg] * ramp
        tol = 8e-6 * max(np.abs(ya).max(), np.abs(yb).max()) + 4.0
        np.testing.assert_allclose(y[c], expect, rtol=0, atol=tol)
    check_golden("bench5_8192x8_crossfade_random", open(outp, "rb").read())
