"""Uniform-delay ring-write program variant (graph/compile.py
``uniform_delay``).

When every filter shares one pre-delay, the offline batched path writes
the spectra ring with a single dynamic_update_slice at a scalar slot
instead of a per-filter scatter (selected via Control.snapshot_uniform_
delay -> DeviceIO.multi_step(udelay=...)). The two program variants must
be bit-identical: they write the same values to the same ring slots.
Reference ring-slot semantics: curblock = (blockcounter + delay) %
n_blocks, bfrun.c:1600.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from brutefir_tpu.config import parse_config  # noqa: E402
from brutefir_tpu.runtime import Engine  # noqa: E402


def _mk_engine(tmp_path, delays, taps_rng, tag):
    N, B, C = 128, 4, 3
    coeffs = "\n".join(
        f'coeff {i} {{ filename: "{tmp_path}/c{i}_{tag}.txt"; format: "text"; }};'
        for i in range(C))
    for i in range(C):
        t = (taps_rng.standard_normal(N * 2) * 0.2).astype(np.float64)
        np.savetxt(tmp_path / f"c{i}_{tag}.txt", t)
    chans = ",".join(str(i) for i in range(C))
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
{coeffs}
input {chans} {{ device: "file" {{ path: "/dev/zero"; }}; sample: "S24_4LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "/dev/null"; }}; sample: "S24_4LE"; channels: {C}; dither: false; }};
""" + "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i}; "
        f"delay: {delays[i]}; }};"
        for i in range(C)))
    conf.quiet = True
    eng = Engine(conf)
    eng.setup()
    return eng, N, C


def _run_batch(eng, N, C, udelay, m=6):
    rng = np.random.default_rng(11)
    with eng.control_mutex:
        ctrl = eng.control.snapshot()
        g0, g1 = eng._mute_gains()
        uni = eng.control.snapshot_uniform
    mstep = eng.dio.multi_step(m, uniform=uni, udelay=udelay)
    shp = (m, N) + eng.dio.in_wire_shape[0]
    dt = eng.dio.in_wire_dtype[0]
    info = np.iinfo(dt)
    words = rng.integers(info.min, info.max + 1, shp).astype(dt)
    st = eng.cg.init_state()
    dstate = jax.tree.map(jnp.copy, eng.dio.dstate)
    try:
        st, outs, meters, nan = mstep(st, ctrl, g0, g1, eng.bank,
                                      [jnp.asarray(words)])
        return [np.asarray(o) for o in outs], np.asarray(st.ring)
    finally:
        eng.dio.dstate = dstate


def test_uniform_delay_variant_bit_identical(tmp_path):
    """Same uniform nonzero pre-delay on every filter: the scalar-slot
    DUS program and the per-filter scatter program produce identical
    outputs and identical ring contents."""
    eng, N, C = _mk_engine(tmp_path, delays=[1, 1, 1], taps_rng=np.random.default_rng(3), tag="u")
    with eng.control_mutex:
        eng.control.snapshot()
        assert eng.control.snapshot_uniform_delay
    outs_a, ring_a = _run_batch(eng, N, C, udelay=False)
    outs_b, ring_b = _run_batch(eng, N, C, udelay=True)
    for a, b in zip(outs_a, outs_b):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ring_a, ring_b)


def test_nonuniform_delay_clears_flag(tmp_path):
    """Distinct per-filter pre-delays must clear snapshot_uniform_delay so
    the engine keeps dispatching the scatter program."""
    eng, N, C = _mk_engine(tmp_path, delays=[0, 1, 2], taps_rng=np.random.default_rng(4), tag="n")
    with eng.control_mutex:
        eng.control.snapshot()
        assert not eng.control.snapshot_uniform_delay


def test_runtime_delay_change_flips_flag(tmp_path):
    """A runtime cfd-style change from uniform to per-filter delays flips
    the flag at the next snapshot (the engine then compiles/dispatches
    the scatter variant for later batches)."""
    eng, N, C = _mk_engine(tmp_path, delays=[0, 0, 0], taps_rng=np.random.default_rng(5), tag="r")
    with eng.control_mutex:
        eng.control.snapshot()
        assert eng.control.snapshot_uniform_delay
        eng.control.change_filter_delay(1, 2)
        eng.control.snapshot()
        assert not eng.control.snapshot_uniform_delay
