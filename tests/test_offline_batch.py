"""The batched offline dispatch (DeviceIO.multi_step: a scan over m
blocks under one control snapshot) against m per-block steps through the
full device program -- decode, FFT, mixes, MAC, inverse FFT, encode and
meters -- including the per-block delay, dither and powersave state that
the scan chains from block to block."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime import Engine


def _mk_engine(tmp_path, delays, tag, C=3, N=256, B=4, fmt="FLOAT_LE",
               dither="false", extra=""):
    rng = np.random.default_rng(abs(hash(tag)) % 2**31)
    coeffs = []
    for i in range(C):
        p = tmp_path / f"c{i}_{tag}.raw"
        (rng.standard_normal(N * 2) * 0.2).astype("<f4").tofile(p)
        coeffs.append(f'coeff {i} {{ filename: "{p}"; format: "FLOAT_LE"; }};')
    chans = ",".join(str(i) for i in range(C))
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
{extra}
{chr(10).join(coeffs)}
input {chans} {{ device: "file" {{ path: "/dev/zero"; }}; sample: "{fmt}"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "/dev/null"; }}; sample: "{fmt}"; channels: {C}; dither: {dither}; }};
""" + "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; "
        f"delay: {delays[i]}; }};"
        for i in range(C)))
    conf.quiet = True
    eng = Engine(conf)
    eng.setup()
    assert eng.dio is not None
    return eng


def _words(eng, m, seed=11, fill=None):
    rng = np.random.default_rng(seed)
    stacks = []
    for i in range(len(eng.dio.in_wire_shape)):
        shp = (m, eng.N) + eng.dio.in_wire_shape[i]
        dt = eng.dio.in_wire_dtype[i]
        if fill is not None:
            words = fill(rng, shp).astype(dt)
        elif np.issubdtype(dt, np.floating):
            words = (rng.standard_normal(shp) * 0.5).astype(dt)
        else:
            info = np.iinfo(dt)
            words = rng.integers(info.min, info.max + 1, shp).astype(dt)
        stacks.append(words)
    return stacks


def _both(eng, m, udelay=False, fill=None):
    """(batched, per-block) outputs, meters and final ring for the same
    m blocks from the same initial state."""
    stacks = _words(eng, m, fill=fill)
    with eng.control_mutex:
        ctrl = eng.control.snapshot()
        g0, g1 = eng._mute_gains()
        uni = eng.control.snapshot_uniform
    dstate0 = jax.tree.map(jnp.copy, eng.dio.dstate)

    mstep = eng.dio.multi_step(m, uniform=uni, udelay=udelay, xfade=False)
    st, outs, meters, nan = mstep(eng.cg.init_state(), ctrl, g0, g1,
                                  eng.bank, [jnp.asarray(s) for s in stacks])
    batched = ([np.asarray(o) for o in outs],
               [np.asarray(md) for md in meters], np.asarray(st.ring),
               bool(nan))

    eng.dio.dstate = jax.tree.map(jnp.copy, dstate0)
    st = eng.cg.init_state()
    per_outs, per_met = [], []
    for b in range(m):
        st, o, md, nan1 = eng.dio.step(st, ctrl, g0, g1, eng.bank,
                                       [jnp.asarray(s[b]) for s in stacks],
                                       uniform=uni, xfade=False)
        assert bool(nan1)
        per_outs.append([np.asarray(x) for x in o])
        per_met.append([np.asarray(x) for x in md])
    eng.dio.dstate = dstate0
    outs_b = [np.stack([po[d] for po in per_outs])
              for d in range(len(per_outs[0]))]
    # meters: clip counts sum over the batch, peaks take the max
    met_b = [np.concatenate([
        np.sum([pm[d][:, :1] for pm in per_met], axis=0),
        np.max([pm[d][:, 1:] for pm in per_met], axis=0)], axis=1)
        for d in range(len(per_met[0]))]
    return batched, (outs_b, met_b, np.asarray(st.ring))


def _assert_close(batched, per_block, tol=0.0):
    outs_a, met_a, ring_a, nan_a = batched
    outs_b, met_b, ring_b = per_block
    assert nan_a
    for a, b in zip(outs_a, outs_b):
        assert a.shape == b.shape
        if np.issubdtype(a.dtype, np.integer):
            assert np.abs(a.astype(np.int64) - b).max() <= tol
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    for a, b in zip(met_a, met_b):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ring_a, ring_b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("m", [2, 3, 4, 12])
@pytest.mark.parametrize("delays,udelay", [
    ([0, 0, 0], False),
    ([0, 0, 0], True),    # scalar-slot ring write variant
    ([0, 1, 2], False),   # mixed pre-delays: per-filter scatter
])
def test_batch_matches_per_block(tmp_path, m, delays, udelay):
    eng = _mk_engine(tmp_path, delays,
                     f"b{m}{''.join(map(str, delays))}{int(udelay)}")
    _assert_close(*_both(eng, m, udelay=udelay))


@pytest.mark.parametrize("m", [4, 12])
def test_batch_matches_per_block_triton(tmp_path, monkeypatch,
                                        triton_interpret, m):
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "triton")
    eng = _mk_engine(tmp_path, [0, 1, 2], f"bt{m}")
    assert eng.cg.mac == "triton"
    _assert_close(*_both(eng, m))


def test_batch_int_dither_matches(tmp_path):
    """Integer output with dither: the Tausworthe windows advance per
    block inside the scan exactly as across per-block dispatches."""
    eng = _mk_engine(tmp_path, [0, 1, 0], "dith", fmt="S24_4LE",
                     dither="true")
    _assert_close(*_both(eng, 4), tol=1)


@pytest.mark.parametrize("m", [2, 4])
def test_batch_single_partition(tmp_path, m):
    """B=1: every block's history is the block itself."""
    eng = _mk_engine(tmp_path, [0, 0], f"b1m{m}", C=2, B=1)
    _assert_close(*_both(eng, m))


def test_batch_powersave_gate_matches(tmp_path):
    """Analog powersave (test_silent, bfrun.c:722-772) gates each block's
    overlap-save frame inside the scan exactly like per-block steps, and
    the gated channels come out exactly zero."""
    eng = _mk_engine(tmp_path, [0, 0, 0], "ps", extra="powersave: -40;")
    assert eng.spec.powersave

    def fill(rng, shp):
        w = np.zeros(shp, np.float32)
        w[..., 0] = rng.standard_normal(shp[:-1]) * 0.5   # loud
        w[..., 1] = rng.standard_normal(shp[:-1]) * 1e-5  # below threshold
        return w                                          # ch 2 silent

    batched, per_block = _both(eng, 4, fill=fill)
    _assert_close(batched, per_block)
    assert np.all(batched[0][0][:, :, 1] == 0.0)
    assert np.all(batched[0][0][:, :, 2] == 0.0)


def test_batch_program_cache_keys(tmp_path):
    """Programs compile lazily per (m, uniform, udelay, xfade) key; the
    legacy dynamic-crossfade program (xfade=None) has its own entry."""
    eng = _mk_engine(tmp_path, [0, 0, 0], "keys")
    eng.dio.multi_step(4, xfade=None)
    eng.dio.multi_step(3, xfade=False)
    assert (4, False, False, None) in eng.dio._multi
    assert (3, False, False, False) in eng.dio._multi
