"""Multi-device sharding: sharded step == single-device step."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from brutefir_tpu.graph import build_graph_spec, CompiledGraph, make_ctrl
from brutefir_tpu.ops import partconv
from brutefir_tpu.ops.partconv import make_bank
from brutefir_tpu.parallel import make_mesh, ShardedGraph

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def test_sharded_equals_single(rng):
    N, B, C = 128, 4, 8
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = make_bank([partconv.preprocess_coeffs(taps, N, B)])
    ctrl = make_ctrl(
        spec, np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32),
        np.eye(C, dtype=np.float32), np.zeros(C, np.int32),
        np.zeros(C, np.int32), np.ones((C, B), np.float32))
    xs = rng.standard_normal((6, C, N)).astype(np.float32)

    cg = CompiledGraph(spec)
    state = cg.init_state()
    ys_single = []
    for xb in xs:
        state, y = cg.step(state, ctrl, jnp.asarray(bank), jnp.asarray(xb))
        ys_single.append(np.asarray(y))

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg, mesh)
    sstate = sg.init_state()
    sctrl, sbank, _ = sg.place(ctrl, jnp.asarray(bank), jnp.asarray(xs[0]))
    ys_shard = []
    for xb in xs:
        sstate, y = sg.step(sstate, sctrl, sbank, jnp.asarray(xb))
        ys_shard.append(np.asarray(y))

    for a, b in zip(ys_single, ys_shard):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_mesh_axes():
    mesh = make_mesh(jax.devices()[:8], f_axis=4)
    assert mesh.shape["f"] == 4 and mesh.shape["sp"] == 2


def test_sharded_cascade_graph(rng):
    """Cascaded filters (staged DAG) compile and match under sharding."""
    N, B, C = 128, 2, 4
    t1 = rng.standard_normal(N * B).astype(np.float32) * 0.2
    t2 = rng.standard_normal(N * B).astype(np.float32) * 0.2
    # filters 0..3: 0,1 source; 2 takes from 0; 3 takes from 1
    spec = build_graph_spec(N, B, C, C, [[], [], [0], [1]], [False] * 4)
    bank = make_bank([partconv.preprocess_coeffs(t1, N, B),
                      partconv.preprocess_coeffs(t2, N, B)])
    in_mix = np.zeros((4, C), np.float32)
    in_mix[0, 0] = 1.0
    in_mix[1, 1] = 1.0
    fmix = np.zeros((4, 4), np.float32)
    fmix[2, 0] = 1.0
    fmix[3, 1] = 0.5
    out_mix = np.zeros((C, 4), np.float32)
    out_mix[0, 2] = 1.0
    out_mix[1, 3] = 1.0
    ctrl = make_ctrl(spec, in_mix, fmix, out_mix, np.zeros(4, np.int32),
                     np.array([0, 1, 1, 0], np.int32),
                     np.ones((4, B), np.float32))
    xs = rng.standard_normal((4, C, N)).astype(np.float32)

    cg = CompiledGraph(spec)
    st = cg.init_state()
    single = []
    for xb in xs:
        st, y = cg.step(st, ctrl, jnp.asarray(bank), jnp.asarray(xb))
        single.append(np.asarray(y))

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg, mesh)
    sst = sg.init_state()
    sctrl, sbank, _ = sg.place(ctrl, jnp.asarray(bank), jnp.asarray(xs[0]))
    for xb, ref in zip(xs, single):
        sst, y = sg.step(sst, sctrl, sbank, jnp.asarray(xb))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)


def test_engine_on_mesh(tmp_path, rng):
    """Engine(conf, mesh=...) runs the whole file pipeline sharded."""
    import pathlib
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    import scipy.signal

    N, B, C = 128, 4, 8
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = rng.standard_normal((C, N * 5)).astype(np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    np.ascontiguousarray(x.T.astype("<f4")).tofile(inp)
    chans = ",".join(str(i) for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; }};"
        for i in range(C))
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
""")
    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    Engine(conf, mesh=mesh).run()
    y = np.fromfile(outp, dtype="<f4").reshape(-1, C).T
    for c in range(C):
        ref = scipy.signal.fftconvolve(x[c], taps)[: x.shape[1]]
        np.testing.assert_allclose(y[c], ref, rtol=0, atol=2e-3)


def test_sharded_triton_graph_matches_single(rng, triton_interpret):
    """A graph built for the Triton MAC runs the dense MAC under a mesh
    (the Pallas kernel does not partition itself), and the sharded output
    matches the single-device Triton step (interpreted)."""
    N, B, C = 1024, 4, 8
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = make_bank([partconv.preprocess_coeffs(taps, N, B)])
    ctrl = make_ctrl(
        spec, np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32),
        np.eye(C, dtype=np.float32), np.zeros(C, np.int32),
        np.zeros(C, np.int32), np.ones((C, B), np.float32))
    xs = rng.standard_normal((5, C, N)).astype(np.float32)

    cg = CompiledGraph(spec, mac="triton")
    assert cg.mac == "triton"
    state = cg.init_state()
    single = []
    for xb in xs:
        state, y = cg.step(state, ctrl, jnp.asarray(bank), jnp.asarray(xb))
        single.append(np.asarray(y))

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg, mesh)
    assert sg.mac == "jnp"
    sstate = sg.init_state()
    sctrl, sbank, _ = sg.place(ctrl, jnp.asarray(bank), jnp.asarray(xs[0]))
    for xb, ref in zip(xs, single):
        sstate, y = sg.step(sstate, sctrl, sbank, jnp.asarray(xb))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("f_axis", [1, 2, 4, 8])
def test_sharded_mesh_shapes_match_single(rng, f_axis):
    """Every ('f', 'sp') split of the 8 devices gives the single-device
    result: pure bin parallelism (f=1) through pure filter parallelism
    (f=8)."""
    N, B, C = 256, 2, 8
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = jnp.asarray(make_bank([partconv.preprocess_coeffs(taps, N, B)]))
    ctrl = make_ctrl(
        spec, rng.standard_normal((C, C)).astype(np.float32),
        np.zeros((C, C), np.float32),
        rng.standard_normal((C, C)).astype(np.float32),
        np.zeros(C, np.int32), np.zeros(C, np.int32),
        np.ones((C, B), np.float32))
    xs = rng.standard_normal((3, C, N)).astype(np.float32)
    cg = CompiledGraph(spec, mac="jnp")
    st = cg.init_state()
    sg = ShardedGraph(cg, make_mesh(jax.devices()[:8], f_axis=f_axis))
    sst = sg.init_state()
    sctrl, sbank, _ = sg.place(ctrl, bank, jnp.asarray(xs[0]))
    for xb in xs:
        st, y = cg.step(st, ctrl, bank, jnp.asarray(xb))
        sst, ys = sg.step(sst, sctrl, sbank, jnp.asarray(xb))
        np.testing.assert_allclose(np.asarray(ys), np.asarray(y), rtol=0,
                                   atol=1e-4)


def test_sharded_kitchensink_semantics(rng):
    """Crossfade, pre-delay (delayblocks), partition masks (cblocks) and
    the powersave gate all match single-device under the 2x4 mesh
    (the bench4-style semantic surface of bfrun.c:1420-2083)."""
    N, B, C = 128, 4, 8
    t1 = rng.standard_normal(N * B).astype(np.float32) * 0.1
    t2 = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)],
                            [True] * C, powersave=True)
    bank = make_bank([partconv.preprocess_coeffs(t1, N, B),
                      partconv.preprocess_coeffs(t2, N, B)])

    delay = np.array([0, 1, 2, 3, 0, 1, 0, 0], np.int32)   # pre-delay blocks
    mask = np.ones((C, B), np.float32)
    mask[2, 2:] = 0.0                                       # cblocks clamp
    mask[5, 1:] = 0.0
    ps = np.zeros(C, np.float32)
    ps[6] = 1e6  # absurd threshold: channel 6 永 gated to silence
    base = dict(
        in_mix=np.eye(C, dtype=np.float32),
        fmix=np.zeros((C, C), np.float32),
        out_mix=np.eye(C, dtype=np.float32),
        delay=delay, mask=mask)

    ctrl_a = make_ctrl(spec, coeff_idx=np.zeros(C, np.int32),
                       ps_thresh=ps, **base)
    # block 3: filters all swap 0 -> 1 with crossfade
    ctrl_b = make_ctrl(spec, coeff_idx=np.ones(C, np.int32),
                       prev_idx=np.zeros(C, np.int32), prev_mask=mask,
                       xfade=np.ones(C, np.float32), ps_thresh=ps, **base)
    ctrl_c = make_ctrl(spec, coeff_idx=np.ones(C, np.int32),
                       ps_thresh=ps, **base)
    ctrls = [ctrl_a, ctrl_a, ctrl_a, ctrl_b, ctrl_c, ctrl_c]
    xs = rng.standard_normal((6, C, N)).astype(np.float32)

    cg = CompiledGraph(spec, mac="jnp")
    st = cg.init_state()
    single = []
    for xb, ct in zip(xs, ctrls):
        st, y = cg.step(st, ct, jnp.asarray(bank), jnp.asarray(xb))
        single.append(np.asarray(y))
    assert np.allclose(single[0][6], 0.0)  # powersave gate really active

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg, mesh)
    sst = sg.init_state()
    _, sbank, _ = sg.place(ctrls[0], jnp.asarray(bank), jnp.asarray(xs[0]))
    for xb, ct, ref in zip(xs, ctrls, single):
        sct, _, _ = sg.place(ct, sbank, jnp.asarray(xb))
        sst, y = sg.step(sst, sct, sbank, jnp.asarray(xb))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=2e-4)


def test_engine_on_mesh_with_eq_and_cli(tmp_path, rng):
    """Full Engine run under a mesh with EQ rendering and a CLI script
    changing attenuation mid-run: sharded output == single-device output."""
    import scipy.signal  # noqa: F401  (env check)
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine

    N, B, C = 128, 4, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = rng.standard_normal((C, N * 8)).astype(np.float32) * 0.3
    chans = ",".join(str(i) for i in range(C))
    filters = "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
        f"coeff: {'0' if i else '1'}; }};" for i in range(C))

    outs = {}
    for mode in ("single", "mesh"):
        inp, outp = tmp_path / f"in_{mode}.f32", tmp_path / f"out_{mode}.f32"
        np.ascontiguousarray(x.T.astype("<f4")).tofile(inp)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: "eq" {{ coeff: 1, 2; bands: 100, 1000, 10000; magnitude: 1000/-3; }},
       "cli" {{ script: "sleep b3
cfoa 2 2 -6
sleep b20"; }};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
coeff 1 {{ filename: "dirac pulse"; shared_mem: true; }};
coeff 2 {{ filename: "dirac pulse"; shared_mem: true; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
{filters}
""")
        mesh = (make_mesh(jax.devices()[:8], f_axis=2)
                if mode == "mesh" else None)
        Engine(conf, mesh=mesh).run()
        outs[mode] = np.fromfile(outp, dtype="<f4").reshape(-1, C).T
    np.testing.assert_allclose(outs["mesh"], outs["single"],
                               rtol=0, atol=2e-4)
    # the cfoa -6 dB *attenuation* is a 2x boost; late blocks of channel
    # 2 must sit ~2x relative to the plain convolution (script not a no-op)
    import scipy.signal
    full = scipy.signal.fftconvolve(x[2], taps)[: x.shape[1]]
    ratio = (np.sqrt(np.mean(outs["single"][2, 6 * N:] ** 2))
             / np.sqrt(np.mean(full[6 * N:] ** 2)))
    assert 1.9 < ratio < 2.1


def test_dio_runs_sharded(tmp_path, rng):
    """The device-IO wrapper (whole-block program incl. codecs) runs under
    a mesh since round 3: the jit pins the same state/bank shardings as
    ShardedGraph, wire words stay replicated, and the whole
    decode->step->encode program is one sharded dispatch."""
    import jax
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    from brutefir_tpu.runtime.device_io import eligible
    from brutefir_tpu.parallel import make_mesh

    N, B, C = 128, 2, 4
    x = np.clip((rng.standard_normal((N * 4, C)) * 2**20).round(),
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
    assert eligible(conf)
    eng = Engine(conf)
    assert eng.dio is not None
    eng.stop()

    conf2 = parse_config(cfg)
    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    eng2 = Engine(conf2, mesh=mesh)
    assert eng2.dio is not None    # sharded device-IO path active
    eng2.run()
    y = np.fromfile(outp, dtype="<i4").reshape(-1, C)
    # dirac pass-through: sharded reduction order may differ by 1 ulp in
    # the f32 FFT round trip -> at most 1 LSB after quantization
    assert np.abs(y.astype(np.int64) - x.astype(np.int64)).max() <= 1


def test_sharded_crossfade_parity(rng):
    """A live coefficient swap with crossfade on the mesh (both MAC
    passes sharded by the partitioner) matches the single-device path."""
    N, B, C = 1024, 4, 8
    taps_a = rng.standard_normal(N * B).astype(np.float32) * 0.1
    taps_b = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [True] * C)
    bank = make_bank([partconv.preprocess_coeffs(t, N, B)
                      for t in (taps_a, taps_b)])
    xs = rng.standard_normal((4, C, N)).astype(np.float32)

    def ctrl_for(idx, prev, xf):
        return make_ctrl(
            spec, np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32),
            np.eye(C, dtype=np.float32), np.zeros(C, np.int32),
            np.full(C, idx, np.int32), np.ones((C, B), np.float32),
            prev_idx=np.full(C, prev, np.int32),
            xfade=np.full(C, xf, np.float32))

    plans = [ctrl_for(0, 0, 0.0), ctrl_for(1, 0, 1.0),  # swap w/ crossfade
             ctrl_for(1, 1, 0.0), ctrl_for(1, 1, 0.0)]

    cg_ref = CompiledGraph(spec, mac="jnp")
    state = cg_ref.init_state()
    single = []
    for xb, ct in zip(xs, plans):
        state, y = cg_ref.step(state, ct, jnp.asarray(bank), jnp.asarray(xb))
        single.append(np.asarray(y))

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg_ref, mesh)
    sstate = sg.init_state()
    for xb, ct, ref in zip(xs, plans, single):
        sctrl, sbank, sx = sg.place(ct, jnp.asarray(bank), jnp.asarray(xb))
        sstate, y = sg.step(sstate, sctrl, sbank, sx)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)

    # the host-selected program variants (engine dispatch: xfade=True on
    # the swap block, False elsewhere -- the fused time-domain crossfade
    # under shard_map) must match the same reference
    sstate2 = sg.init_state()
    for xb, ct, ref in zip(xs, plans, single):
        xf = bool(np.any(np.asarray(ct.xfade) > 0))
        sctrl, sbank, sx = sg.place(ct, jnp.asarray(bank), jnp.asarray(xb))
        sstate2, y = sg.step(sstate2, sctrl, sbank, sx, xfade=xf)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)

    # and the single-device host-selected programs (CompiledGraph.step
    # xfade flag)
    st2 = cg_ref.init_state()
    for xb, ct, ref in zip(xs, plans, single):
        xf = bool(np.any(np.asarray(ct.xfade) > 0))
        st2, y = cg_ref.step(st2, ct, jnp.asarray(bank), jnp.asarray(xb),
                             xfade=xf)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)


def test_sharded_mixes_match_dense(rng):
    """Dense in/out mixing matrices under the 2x4 mesh (the output mix
    contracts the 'f'-sharded filter axis: a psum) match the
    single-device step."""
    N, B, C = 1024, 2, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = make_bank([partconv.preprocess_coeffs(taps, N, B)])
    in_mix = rng.standard_normal((C, C)).astype(np.float32)
    out_mix = rng.standard_normal((C, C)).astype(np.float32)
    ctrl = make_ctrl(spec, in_mix, np.zeros((C, C), np.float32), out_mix,
                     np.zeros(C, np.int32), np.zeros(C, np.int32),
                     np.ones((C, B), np.float32))
    xs = rng.standard_normal((4, C, N)).astype(np.float32)

    cg = CompiledGraph(spec, mac="jnp")
    st = cg.init_state()
    dense = []
    for xb in xs:
        st, y = cg.step(st, ctrl, jnp.asarray(bank), jnp.asarray(xb))
        dense.append(np.asarray(y))

    mesh = make_mesh(jax.devices()[:8], f_axis=2)
    sg = ShardedGraph(cg, mesh)
    sst = sg.init_state()
    sctrl, sbank, _ = sg.place(ctrl, jnp.asarray(bank), jnp.asarray(xs[0]))
    got = []
    for xb in xs:
        sst, y = sg.step(sst, sctrl, sbank, jnp.asarray(xb))
        got.append(np.asarray(y))
    for a, b in zip(dense, got):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)


def test_sharded_bf16_knobs_smoke(rng, monkeypatch):
    """BRUTEFIR_TPU_BANK/RING_DTYPE=bf16 under a mesh: the sharded step
    compiles and stays within quantization tolerance of the f32 mesh
    run (the knobs target single-chip scale, but must not break mesh
    users)."""
    N, B, C = 1024, 4, 8
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = make_bank([partconv.preprocess_coeffs(taps, N, B)])
    ctrl = make_ctrl(
        spec, np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32),
        np.eye(C, dtype=np.float32), np.zeros(C, np.int32),
        np.zeros(C, np.int32), np.ones((C, B), np.float32))
    xs = rng.standard_normal((3, C, N)).astype(np.float32)
    mesh = make_mesh(jax.devices()[:8], f_axis=2)

    outs = {}
    for knobs in (False, True):
        if knobs:
            monkeypatch.setenv("BRUTEFIR_TPU_BANK_DTYPE", "bf16")
            monkeypatch.setenv("BRUTEFIR_TPU_RING_DTYPE", "bf16")
        cg = CompiledGraph(spec, mac="jnp")
        sg = ShardedGraph(cg, mesh)
        st = sg.init_state()
        if knobs:
            assert st.ring.dtype == jnp.bfloat16
        bk = jnp.asarray(bank, jnp.bfloat16 if knobs else jnp.float32)
        ys = []
        for xb in xs:
            sctrl, sbank, sx = sg.place(ctrl, bk, jnp.asarray(xb))
            st, y = sg.step(st, sctrl, sbank, sx)
            ys.append(np.asarray(y))
        outs[knobs] = np.stack(ys)
    scale = np.abs(outs[False]).max()
    assert np.abs(outs[True] - outs[False]).max() <= 0.01 * scale + 1e-5
