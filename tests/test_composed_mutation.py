"""Composed runtime-mutation torture: one file-to-file run driving every
mutation family the reference's filter loop handles in a single pass
(bfrun.c:1574-1777) -- per-block `cfc` coefficient swaps
with `crossfade: true;`, an EQ logic-module re-render hot-swapped through
the coeff_final redirect (bflogic_eq.c:105-120), a `cfd` filter-delay
change, and a `cid` input-delay change -- on a bench1-style cascade
graph, asserted block-by-block against a sequential float64 numpy oracle
and pinned by a committed byte golden.

Crossfade, cascades, EQ re-render, and runtime delay changes are each
tested in isolation elsewhere; THIS file is about their interactions
(xfade program selection x coeff_final redirect x program-variant flips),
which is exactly where a host-selected-variant design can crack.

Regenerate goldens after an intentional numeric change with
BFTPU_UPDATE_GOLDENS=1 (see test_fullshape_parity.py).
"""

import math
import os
import types

import numpy as np
import pytest
import scipy.signal

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime import Engine

from test_fullshape_parity import check_golden

N, B = 8192, 8
FS = 44100
TAPS = N * B


def conv64(x, h):
    return scipy.signal.fftconvolve(
        np.asarray(x, np.float64), np.asarray(h, np.float64))[: len(x)]


def delay_samples(a, d):
    return np.concatenate([np.zeros(d), a[: len(a) - d]])


def xfade_ramp():
    return np.arange(N, dtype=np.float64) / (N - 1)


def render_eq_impulse(mag_db_at_1k: float) -> np.ndarray:
    """The EQ module's own render math (control/eq.py render_impulse,
    rendereq.h:20-102) on the test's band curve: ISO octave bands, all
    magnitudes 0 dB except 1 kHz. The render itself is golden-tested in
    test_eq.py; reusing it here keeps THIS oracle about the composition,
    not the curve math."""
    from brutefir_tpu.control.eq import EqModule, ISO_OCTAVE, _Eq

    bands = [b for b in ISO_OCTAVE if b < FS / 2]
    freq = np.array([0.0] + bands + [FS / 2.0]) / FS
    mag_db = np.zeros(len(freq))
    mag_db[1 + bands.index(1000)] = mag_db_at_1k
    eq = _Eq()
    eq.freq = freq
    eq.mag = np.power(10.0, mag_db / 20.0)
    eq.mag[0] = eq.mag[1]
    eq.mag[-1] = eq.mag[-2]
    eq.phase = np.zeros(len(freq))
    eq.band_count = len(freq)
    eq.taps = TAPS
    stub = types.SimpleNamespace(
        engine=types.SimpleNamespace(rd=np.dtype("float32")))
    return EqModule.render_impulse(stub, eq)


SCRIPT = "\n".join([
    "rpk",                     # block 0 (noop)
    "cid 0 64",                # block 1: input-delay change (input silent)
    "rpk",                     # block 2
    "rpk",                     # block 3 (input 0 signal starts here)
    "cfc 0 1",                 # block 4: pre0 crossfades c0 -> c1
    "rpk",                     # block 5
    "lmc eq 2 mag 1000/6.0",   # block 6: EQ re-render, redirect flip
    "rpk",                     # block 7
    "cfd 2 1",                 # block 8: fin pre-delay 0 -> 1 block
    "rpk",                     # block 9
    "cfc 0 0",                 # block 10: pre0 crossfades back c1 -> c0
    "sleep b1000",             # idle to EOF
])

CONFIG = """
sampling_rate: {fs};
filter_length: {N},{B};
show_progress: false;
logic: "cli" {{ echo: false; script: "{script}"; }},
       "eq" {{ coeff: 2, 3; bands: "ISO octave"; magnitude: 1000/3.0; }};

coeff 0 {{ filename: "{c0}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{c1}"; format: "FLOAT_LE"; }};
coeff 2 {{ filename: "dirac pulse"; blocks: {B}; shared_mem: true; }};
coeff 3 {{ filename: "dirac pulse"; blocks: {B}; shared_mem: true; }};
coeff 4 {{ filename: "{cm}"; format: "FLOAT_LE"; }};

input 0, 1 {{
    device: "file" {{ path: "{inp}"; }};
    sample: "S24_4LE";
    channels: 2;
    maxdelay: 128;
}};
output 0, 1 {{
    device: "file" {{ path: "{outp}"; }};
    sample: "S24_4LE";
    channels: 2;
    dither: false;
}};

filter "pre0" {{
    crossfade: true;
    from_inputs: 0;
    to_filters: 2;
    coeff: 0;
}};
filter "eqf" {{
    crossfade: true;
    from_inputs: 1;
    to_filters: 2;
    to_outputs: 1;
    coeff: 2;
}};
filter "fin" {{
    from_filters: 0, 1;
    to_outputs: 0;
    coeff: 4;
}};
"""


def _run_torture(tmp_path):
    rng = np.random.default_rng(0xC0117)
    n_blocks = 24
    n = N * n_blocks
    h0 = (rng.uniform(-1, 1, TAPS) * 0.003).astype(np.float32)
    h1 = (rng.uniform(-1, 1, TAPS) * 0.003).astype(np.float32)
    hm = (rng.uniform(-1, 1, TAPS) * 0.003).astype(np.float32)
    x = rng.integers(-(1 << 20), 1 << 20, (2, n)).astype(np.int32)
    # input 0 silent until block 3: the cid at block 1 lands on silence,
    # so FIFO-vs-window-gather replay semantics cannot differ
    x[0, : 3 * N] = 0

    c0p, c1p, cmp_ = tmp_path / "c0.raw", tmp_path / "c1.raw", \
        tmp_path / "cm.raw"
    h0.tofile(c0p)
    h1.tofile(c1p)
    hm.tofile(cmp_)
    inp, outp = tmp_path / "in.raw", tmp_path / "out.raw"
    np.ascontiguousarray(x.T.astype("<i4")).tofile(inp)

    text = CONFIG.format(fs=FS, N=N, B=B, script=SCRIPT.replace("\n", "\\n"),
                         c0=c0p, c1=c1p, cm=cmp_, inp=inp, outp=outp)
    conf = parse_config(text, "composed_mutation")
    eng = Engine(conf)
    eng.run()

    y = np.fromfile(outp, "<i4").reshape(-1, 2).T.astype(np.float64)
    assert y.shape[1] == n
    return x, h0, h1, hm, y, n_blocks, n


def _oracle(x, h0, h1, hm, n_blocks, n):
    s = 1.0 / (1 << 23)
    ramp = xfade_ramp()
    # input 0 carries the 64-sample cid delay for its whole non-silent life
    v0 = delay_samples(x[0] * s, 64)
    v1 = np.asarray(x[1] * s, np.float64)

    def blocks(full_a, full_b, swaps):
        """Per-block stream: swaps maps block -> 'ab'/'ba' crossfade."""
        out = np.empty(n, np.float64)
        cur = full_a
        for k in range(n_blocks):
            seg = slice(k * N, (k + 1) * N)
            if k in swaps:
                frm, to = (full_a, full_b) if swaps[k] == "ab" else \
                    (full_b, full_a)
                out[seg] = frm[seg] * (1 - ramp) + to[seg] * ramp
                cur = to
            else:
                out[seg] = cur[seg]
        return out

    # pre0: c0 -> c1 at block 4, back at block 10
    ya = conv64(v0, h0)
    yb = conv64(v0, h1)
    pre0 = blocks(ya, yb, {4: "ab", 10: "ba"})

    # eqf: block 0 crossfades the configured dirac into the init render
    # (the EQ module renders into the inactive slot and flips BEFORE the
    # first block, so the first snapshot sees a redirect on a
    # crossfade-enabled filter -- same as the reference's init-then-loop
    # ordering); block 6 crossfades render(3 dB) -> render(6 dB)
    h_eq1 = render_eq_impulse(3.0)
    h_eq2 = render_eq_impulse(6.0)
    y_dirac = v1.copy()
    y_eq1 = conv64(v1, h_eq1)
    y_eq2 = conv64(v1, h_eq2)
    eqf = np.empty(n, np.float64)
    seg0 = slice(0, N)
    eqf[seg0] = y_dirac[seg0] * (1 - ramp) + y_eq1[seg0] * ramp
    for k in range(1, n_blocks):
        seg = slice(k * N, (k + 1) * N)
        if k < 6:
            eqf[seg] = y_eq1[seg]
        elif k == 6:
            eqf[seg] = y_eq1[seg] * (1 - ramp) + y_eq2[seg] * ramp
        else:
            eqf[seg] = y_eq2[seg]

    # fin: cascade sum through the partition ring with the reference's
    # write-at-(t+delay)/read-at-(t-i) slot semantics (bfrun.c:1600,
    # 1687,1745-1754) and the cblocks clamp (bfrun.c:1585-1591). A cfd
    # change transitions "dirty" over B-1 blocks: slots written before
    # the change keep their old positions, so partition i briefly reads
    # a stale window -- exactly what the engine (and reference) produce.
    w = pre0 + eqf
    hp = np.asarray(hm, np.float64).reshape(B, N)
    slots = np.zeros((B, 2 * N))
    fin = np.empty(n, np.float64)
    prev = np.zeros(N)
    for k in range(n_blocks):
        d = 0 if k < 8 else 1  # cfd 2 1 lands at block 8
        cur = w[k * N:(k + 1) * N]
        win = np.concatenate([prev, cur])
        prev = cur
        slots[(k + d) % B] = win
        acc = np.zeros(N)
        for i in range(B - d):
            acc += scipy.signal.fftconvolve(slots[(k - i) % B],
                                            hp[i])[N:2 * N]
        fin[k * N:(k + 1) * N] = acc

    return fin * (1 << 23), eqf * (1 << 23)


N2, B2 = 1024, 4
TAPS2 = N2 * B2

CONFIG_OFFLINE = """
sampling_rate: {fs};
filter_length: {N},{B};
show_progress: false;

coeff 0 {{ filename: "{c0}"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{c1}"; format: "FLOAT_LE"; }};
coeff 2 {{ filename: "{ce}"; format: "FLOAT_LE"; }};

input 0, 1 {{
    device: "file" {{ path: "{inp}"; }};
    sample: "S24_4LE";
    channels: 2;
    maxdelay: 128;
}};
output 0, 1 {{
    device: "file" {{ path: "{outp}"; }};
    sample: "S24_4LE";
    channels: 2;
    dither: false;
}};

filter "xf"  {{ crossfade: true; from_inputs: 0; to_outputs: 0;
                coeff: 0; }};
filter "dly" {{ from_inputs: 1; to_outputs: 1; coeff: 2; }};
"""


def ring_sim(w, h, n_blocks, N, B, delay_at):
    """Reference partition-ring oracle (write at (t+delay)%B, read at
    (t-i)%B, cblocks clamp -- bfrun.c:1600,1687,1745-1754): models the
    dirty B-1-block transition after a cfd delay change exactly."""
    hp = np.asarray(h, np.float64).reshape(B, N)
    slots = np.zeros((B, 2 * N))
    out = np.empty(n_blocks * N, np.float64)
    prev = np.zeros(N)
    for k in range(n_blocks):
        d = delay_at(k)
        cur = w[k * N:(k + 1) * N]
        win = np.concatenate([prev, cur])
        prev = cur
        slots[(k + d) % B] = win
        acc = np.zeros(N)
        for i in range(B - d):
            acc += scipy.signal.fftconvolve(slots[(k - i) % B],
                                            hp[i])[N:2 * N]
        out[k * N:(k + 1) * N] = acc
    return out


@pytest.mark.parametrize("mac", ["jnp", "triton"])
def test_composed_mutation_offline_grouped(tmp_path, request, mac):
    """The batched offline schedule under the same mutation families:
    coeff swaps with crossfade, a cfd filter-delay change, and a cid
    input-delay change land BETWEEN run_offline segments, so batches
    alternate between the scanned program (no crossfade pending) and the
    per-block xfade program + scanned remainder. Both MACs (the Triton
    kernel interpreted) meet the oracle; the dense MAC's bytes are pinned
    by the committed golden."""
    if mac == "triton":
        request.getfixturevalue("triton_interpret")
    os.environ["BRUTEFIR_TPU_MAC"] = mac
    request.addfinalizer(lambda: os.environ.pop("BRUTEFIR_TPU_MAC", None))

    rng = np.random.default_rng(0xD15C)
    n_blocks = 24
    n = N2 * n_blocks
    h0 = (rng.uniform(-1, 1, TAPS2) * 0.02).astype(np.float32)
    h1 = (rng.uniform(-1, 1, TAPS2) * 0.02).astype(np.float32)
    he = (rng.uniform(-1, 1, TAPS2) * 0.02).astype(np.float32)
    x = rng.integers(-(1 << 20), 1 << 20, (2, n)).astype(np.int32)
    x[0, : 6 * N2] = 0  # silent past the block-4 cid change

    for name, arr in (("c0", h0), ("c1", h1), ("ce", he)):
        arr.tofile(tmp_path / f"{name}.raw")
    inp, outp = tmp_path / "in.raw", tmp_path / "out.raw"
    np.ascontiguousarray(x.T.astype("<i4")).tofile(inp)

    conf = parse_config(
        CONFIG_OFFLINE.format(fs=FS, N=N2, B=B2, c0=tmp_path / "c0.raw",
                              c1=tmp_path / "c1.raw", ce=tmp_path / "ce.raw",
                              inp=inp, outp=outp),
        "composed_mutation_offline")
    eng = Engine(conf)
    eng.setup()
    try:
        eng.run_offline(max_blocks=4, batch_blocks=4, setup=False)
        assert eng.control.set_delay(0, 0, 64)      # cid 0 64 (on silence)
        eng.run_offline(max_blocks=8, batch_blocks=4, setup=False)
        eng.control.change_coeff(0, 1)              # cfc xf 1 -> crossfade
        eng.run_offline(max_blocks=12, batch_blocks=4, setup=False)
        eng.control.change_filter_delay(1, 1)       # cfd dly 1
        eng.run_offline(max_blocks=16, batch_blocks=4, setup=False)
        eng.control.change_coeff(0, 0)              # cfc xf 0 -> crossfade
        eng.run_offline(batch_blocks=4, setup=False)
    finally:
        eng.teardown()

    assert eng.cg.mac == mac

    y = np.fromfile(outp, "<i4").reshape(-1, 2).T.astype(np.float64)
    assert y.shape[1] == n

    s = 1.0 / (1 << 23)
    ramp = np.arange(N2, dtype=np.float64) / (N2 - 1)
    v0 = delay_samples(x[0] * s, 64)
    v1 = np.asarray(x[1] * s, np.float64)

    ya, yb = conv64(v0, h0), conv64(v0, h1)
    ch0 = np.empty(n, np.float64)
    for k in range(n_blocks):
        seg = slice(k * N2, (k + 1) * N2)
        if k == 8:
            ch0[seg] = ya[seg] * (1 - ramp) + yb[seg] * ramp
        elif k == 16:
            ch0[seg] = yb[seg] * (1 - ramp) + ya[seg] * ramp
        else:
            ch0[seg] = (ya if k < 8 or k > 16 else yb)[seg]

    ch1 = ring_sim(v1, he, n_blocks, N2, B2,
                   lambda k: 0 if k < 12 else 1)

    tol0 = 4.0 + 2e-5 * np.abs(ch0).max() / s
    tol1 = 4.0 + 2e-5 * np.abs(ch1).max()
    np.testing.assert_allclose(y[0], ch0 / s, rtol=0, atol=tol0)
    np.testing.assert_allclose(y[1], ch1 / s, rtol=0, atol=tol1)

    if mac == "jnp":
        raw = np.fromfile(outp, np.uint8).tobytes()
        check_golden("composed_mutation_offline_1024x4", raw)


def test_offline_xfade_crossfades_one_block(tmp_path):
    """A coeff swap staged between run_offline calls crossfades exactly
    ONE block, whether the swap batch is (a) a full batch (the split
    dispatch: per-block xfade program + batched remainder) or (b) the
    EOF per-block tail (per-block snapshots) -- both must match the
    per-block run() byte-for-byte (bfrun.c:1695-1777: the crossfade
    rides the snapshot where prevcoeff != coeff, cleared on the next)."""
    Nl, Bl = 128, 2
    rng = np.random.default_rng(7)
    h0 = (rng.uniform(-1, 1, Nl * Bl) * 0.1).astype(np.float32)
    h1 = (rng.uniform(-1, 1, Nl * Bl) * 0.1).astype(np.float32)
    h0.tofile(tmp_path / "c0.raw")
    h1.tofile(tmp_path / "c1.raw")
    x = rng.uniform(-0.5, 0.5, 8 * Nl).astype("<f4")
    x.tofile(tmp_path / "in.raw")

    conf_text = """
sampling_rate: 44100; filter_length: {N},{B}; show_progress: false;
coeff 0 {{ filename: "{d}/c0.raw"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{d}/c1.raw"; format: "FLOAT_LE"; }};
input 0 {{ device: "file" {{ path: "{d}/in.raw"; }};
           sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }};
            sample: "FLOAT_LE"; channels: 1; dither: false; }};
filter 0 {{ crossfade: true; from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""

    def go(mode):
        outp = tmp_path / f"o_{mode}.raw"
        conf = parse_config(conf_text.format(N=Nl, B=Bl, d=tmp_path,
                                             outp=outp), "probe")
        eng = Engine(conf)
        eng.setup()
        try:
            if mode == "perblock":
                eng.run(max_blocks=4, setup=False)
                eng.control.change_coeff(0, 1)
                eng.run(setup=False)
            elif mode == "batch":     # swap batch is a full 4-block batch
                eng.run_offline(max_blocks=4, batch_blocks=4, setup=False)
                eng.control.change_coeff(0, 1)
                eng.run_offline(batch_blocks=4, setup=False)
            else:                     # swap batch is the EOF tail
                eng.run_offline(max_blocks=4, batch_blocks=4, setup=False)
                eng.control.change_coeff(0, 1)
                eng.run_offline(batch_blocks=8, setup=False)
        finally:
            eng.teardown()
        return np.fromfile(outp, "<f4")

    ref = go("perblock")
    assert len(ref) == 8 * Nl
    np.testing.assert_array_equal(go("batch"), ref)
    np.testing.assert_array_equal(go("tail"), ref)


def test_offline_xfade_epoch_not_consumed_at_batch_end(tmp_path,
                                                       monkeypatch):
    """A swap pending at the instant a batch ends ON an xfade block must
    crossfade the NEXT batch's first block, not apply abruptly: the
    xfade-split loop must not take a trailing snapshot() once the batch
    is exhausted (snapshot() advances prev_coeff, bfrun.c:1695-1777 +
    control.py:242, so an undispatched snapshot silently consumes the
    crossfade epoch). Repro from the round-5 review: a concurrent
    mutator swapping coeffs after every dispatched block -- every block
    of the batched run must byte-match the per-block run()."""
    from brutefir_tpu.runtime.device_io import DeviceIO

    Nl, Bl = 128, 2
    rng = np.random.default_rng(21)
    h0 = (rng.uniform(-1, 1, Nl * Bl) * 0.1).astype(np.float32)
    h1 = (rng.uniform(-1, 1, Nl * Bl) * 0.1).astype(np.float32)
    h0.tofile(tmp_path / "c0.raw")
    h1.tofile(tmp_path / "c1.raw")
    n_blocks = 6
    x = rng.uniform(-0.5, 0.5, n_blocks * Nl).astype("<f4")
    x.tofile(tmp_path / "in.raw")

    conf_text = """
sampling_rate: 44100; filter_length: {N},{B}; show_progress: false;
coeff 0 {{ filename: "{d}/c0.raw"; format: "FLOAT_LE"; }};
coeff 1 {{ filename: "{d}/c1.raw"; format: "FLOAT_LE"; }};
input 0 {{ device: "file" {{ path: "{d}/in.raw"; }};
           sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }};
            sample: "FLOAT_LE"; channels: 1; dither: false; }};
filter 0 {{ crossfade: true; from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""

    orig_step = DeviceIO.step

    def go(mode):
        outp = tmp_path / f"o_{mode}.raw"
        conf = parse_config(conf_text.format(N=Nl, B=Bl, d=tmp_path,
                                             outp=outp), "probe")
        eng = Engine(conf)
        swaps = []

        def swapping_step(self, *a, **kw):
            r = orig_step(self, *a, **kw)
            # a concurrent control client lands a cfc swap right after
            # every dispatched block (alternating targets so each one
            # is a real prev!=final epoch); capped so the last block
            # runs swap-free in both modes
            if len(swaps) < n_blocks - 1:
                # seed swap was to coeff 1; keep alternating 0,1,0,...
                swaps.append(eng.control.change_coeff(
                    0, (len(swaps) + 1) % 2))
            return r

        monkeypatch.setattr(DeviceIO, "step", swapping_step)
        eng.setup()
        # seed the chain BEFORE the run: the first batch must take the
        # per-block xfade split (a crossfade-free batch dispatches the
        # batched program, which the spy does not see)
        swaps.append(eng.control.change_coeff(0, 1))
        try:
            if mode == "perblock":
                eng.run(setup=False)
            else:
                eng.run_offline(batch_blocks=2, setup=False)
        finally:
            eng.teardown()
            monkeypatch.setattr(DeviceIO, "step", orig_step)
        assert len(swaps) == n_blocks - 1, (mode, len(swaps))
        return np.fromfile(outp, "<f4")

    ref = go("perblock")
    assert len(ref) == n_blocks * Nl
    np.testing.assert_array_equal(go("batch2"), ref)


@pytest.mark.parametrize("mac", ["jnp", "triton"])
def test_composed_mutation_torture(tmp_path, request, mac):
    """The full mutation storm against the sequential oracle through the
    per-block run() path, with either MAC (the Triton kernel
    interpreted); the dense MAC's bytes are pinned by the committed
    golden."""
    if mac == "triton":
        request.getfixturevalue("triton_interpret")
    os.environ["BRUTEFIR_TPU_MAC"] = mac
    request.addfinalizer(lambda: os.environ.pop("BRUTEFIR_TPU_MAC", None))
    x, h0, h1, hm, y, n_blocks, n = _run_torture(tmp_path)
    fin, eqf = _oracle(x, h0, h1, hm, n_blocks, n)

    tol0 = 4.0 + 2e-5 * np.abs(fin).max()
    tol1 = 4.0 + 2e-5 * np.abs(eqf).max()
    np.testing.assert_allclose(y[0], fin, rtol=0, atol=tol0)
    np.testing.assert_allclose(y[1], eqf, rtol=0, atol=tol1)

    if mac == "jnp":
        raw = np.fromfile(tmp_path / "out.raw", np.uint8).tobytes()
        check_golden("composed_mutation_8192x8", raw)
