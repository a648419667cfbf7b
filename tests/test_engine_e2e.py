"""End-to-end file-to-file engine tests against convolution oracles."""

import numpy as np
import pytest
import scipy.signal

from brutefir_tpu.config import parse_config, IN, OUT
from brutefir_tpu.core.sampleformat import parse_sample_format
from brutefir_tpu.core.codecs import Overflow, float_to_raw, quantize_no_dither
from brutefir_tpu.runtime import Engine


def write_raw_float(path, x):
    np.asarray(x, dtype="<f4").T.tofile(path)


def read_raw_float(path, channels=1):
    a = np.fromfile(path, dtype="<f4")
    return a.reshape(-1, channels).T


def test_file_to_file_float_oracle(tmp_path, rng):
    N, B = 256, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    x = rng.standard_normal(N * 10 ).astype(np.float32)

    coeff_path = tmp_path / "taps.txt"
    coeff_path.write_text("\n".join(f"{float(v)!r}" for v in taps))
    inp = tmp_path / "in.f32"
    outp = tmp_path / "out.f32"
    write_raw_float(inp, x[None, :])

    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{coeff_path}"; format: "TEXT"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    eng = Engine(conf)
    stats = eng.run()
    assert stats["frames"] == len(x)

    y = read_raw_float(outp)[0]
    ref = scipy.signal.fftconvolve(x, taps)[: len(x)]
    np.testing.assert_allclose(y, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_eof_truncation_partial_block(tmp_path, rng):
    """Output length equals input length even for non-block-multiple input."""
    N = 128
    x = rng.standard_normal(N * 3 + 37).astype(np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    write_raw_float(inp, x[None, :])
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = read_raw_float(outp)[0]
    assert len(y) == len(x)
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-4)


def test_s16_quantized_output_matches_oracle(tmp_path, rng):
    N = 128
    fmt = parse_sample_format("S16_LE")
    x = (rng.standard_normal(N * 4) * 8000).astype(np.float32)
    inp, outp = tmp_path / "in.s16", tmp_path / "out.s16"
    xi = quantize_no_dither(x, fmt, Overflow(max=fmt.imax))
    xi.astype("<i2").tofile(inp)

    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; format: "TEXT"; attenuation: 6.0; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S16_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S16_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype="<i2")
    # dirac with -6 dB attenuation
    scale = 10 ** (-6.0 / 20.0)
    expect = quantize_no_dither(
        xi.astype(np.float32) * np.float32(scale), fmt, Overflow(max=fmt.imax))
    assert np.abs(y.astype(np.int32) - expect).max() <= 1


def test_mapping_gains_polarity_predelay(tmp_path, rng):
    """bench4-style semantics: many-virtual mapping, per-edge gain and
    polarity, filter pre-delay in blocks, virtual->physical output mixing."""
    N, B = 128, 4
    x0 = rng.standard_normal(N * 6).astype(np.float32)
    x1 = rng.standard_normal(N * 6).astype(np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    np.stack([x0, x1], axis=1).astype("<f4").tofile(inp)

    # virtual inputs 0,1,2,3 map to physical 0,1,0,1
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1,2,3 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE";
             channels: 2; mapping: 0,1,0,1; delay: 0,0,{N},0; }};
output 0,1 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 2/0;
           mapping: 0,0; }};
filter 0 {{ from_inputs: 0//-1, 1/6; to_outputs: 0; coeff: 0; delay: 1; }};
filter 1 {{ from_inputs: 2, 3//0.5; to_outputs: 1/-6; coeff: 0; }};
""")
    Engine(conf).run()
    y = read_raw_float(outp, 2)
    got = y[0] + 0  # both virtual outputs mix onto physical 0... see below

    g6 = 10 ** (-6.0 / 20.0)
    a6 = 10 ** (6.0 / 20.0)
    n = len(x0)
    f0 = -x0 + g6 * x1                   # filter 0 mix
    f0 = np.concatenate([np.zeros(N, np.float32), f0[: n - N]])  # delay: 1 block
    x0d = np.concatenate([np.zeros(N, np.float32), x0[: n - N]])  # input 2 delayed N
    f1 = x0d + 0.5 * x1
    expect_phys0 = f0 + a6 * f1          # virt outs 0 and 1 both map to phys 0
    np.testing.assert_allclose(got, expect_phys0, rtol=0, atol=3e-3)
    assert np.abs(y[1]).max() == 0.0     # physical 1 unused


def test_text_io_mode(tmp_path, rng):
    N = 64
    x = rng.standard_normal(N * 2).astype(np.float64)
    inp, outp = tmp_path / "in.txt", tmp_path / "out.txt"
    inp.write_text("\n".join("%+.16e" % v for v in x) + "\n")
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; text: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; text: true; }}; sample: "FLOAT64_NE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.array([float(line) for line in outp.read_text().split()])
    assert len(y) == len(x)
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)


def test_dev_zero_benchmark_blocks():
    conf = parse_config("""
sampling_rate: 44100;
filter_length: 128,2;
benchmark: true;
coeff 0 { filename: "dirac pulse"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "S24_4LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "S24_4LE"; channels: 1; dither: false; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""")
    stats = Engine(conf).run(max_blocks=25)
    assert stats["blocks"] == 25
    assert stats["frames"] == 25 * 128


def test_run_offline_batched_matches_per_block(tmp_path, rng):
    """The scan-batched offline mode produces identical output."""
    N, B, M = 128, 4, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = rng.standard_normal(N * 16).astype(np.float32)

    outs = {}
    for mode in ("per_block", "batched"):
        inp = tmp_path / f"in_{mode}.f32"
        outp = tmp_path / f"out_{mode}.f32"
        x.astype("<f4").tofile(inp)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
        eng = Engine(conf)
        assert eng.dio is not None
        if mode == "batched":
            stats = eng.run_offline(batch_blocks=4)
        else:
            stats = eng.run()
        outs[mode] = np.fromfile(outp, dtype="<f4")
    # batched path drops the non-multiple tail by design; compare overlap.
    # Tolerance instead of bit-equality: XLA fuses the FFT untangle
    # (partconv.rfft_packed) differently inside the scan body than in the
    # single-step program, which perturbs float rounding at the 1e-6
    # level; each mode remains bit-deterministic run-to-run
    # (test_determinism.py).
    nb = len(outs["batched"])
    assert nb == 16 * N  # 16 blocks = 4 full batches
    np.testing.assert_allclose(outs["batched"], outs["per_block"][:nb],
                               rtol=0, atol=2e-6)


def test_device_io_path_matches_host_path(tmp_path, rng):
    """The on-device codec path is sample-identical to the host codec."""
    N, B = 128, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = (rng.standard_normal(N * 6) * 100000).astype(np.float32)

    outs = {}
    for mode in ("dio", "host"):
        inp = tmp_path / f"in_{mode}.raw"
        outp = tmp_path / f"out_{mode}.raw"
        np.round(x).astype("<i4").tofile(inp)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
        eng = Engine(conf)
        if mode == "dio":
            assert eng.dio is not None
        else:
            eng.dio = None
        eng.run()
        outs[mode] = np.fromfile(outp, dtype="<i4")
    # mid-tread quantization on device vs native C host path: identical
    # within 1 LSB (float reduction order in the conv differs by backend op
    # scheduling; quantization semantics are the same)
    assert np.abs(outs["dio"].astype(np.int64)
                  - outs["host"].astype(np.int64)).max() <= 1


def test_device_io_perm_output_mix_matches_matmul(tmp_path, rng,
                                                  monkeypatch):
    """The output-mix perm fast path (every physical output row is
    exactly one virtual channel -> row gather instead of the one-hot
    HIGHEST matmul, runtime/device_io.py) is bit-identical to the
    matmul on a channel-reordering mapping."""
    N, B = 128, 4
    x = (rng.standard_normal((N * 5, 2)) * 1e6).astype("<i4")
    inp = tmp_path / "in.raw"
    x.tofile(inp)
    outs = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("BRUTEFIR_TPU_PERM_OMIX", knob)
        outa = tmp_path / f"outa_{knob}.raw"
        outb = tmp_path / f"outb_{knob}.raw"
        # two single-channel devices: the second device's perm row is
        # global virtual channel 1 (a non-arange gather/slice)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE"; channels: 2; }};
output 0 {{ device: "file" {{ path: "{outa}"; }}; sample: "S32_LE";
           channels: 1; dither: false; }};
output 1 {{ device: "file" {{ path: "{outb}"; }}; sample: "S32_LE";
           channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")
        eng = Engine(conf)
        assert eng.dio is not None
        if knob == "1":
            # the fast path must actually engage, non-trivially
            perms = [d[1] for d in eng.dio._out_devs_dbg]
            assert all(isinstance(p, tuple) for p in perms)
            assert any(not np.array_equal(p[1], np.arange(len(p[1])))
                       for p in perms)
        eng.run()
        outs[knob] = (np.fromfile(outa, dtype="<i4"),
                      np.fromfile(outb, dtype="<i4"))
    assert np.array_equal(outs["1"][0], outs["0"][0])
    assert np.array_equal(outs["1"][1], outs["0"][1])
    # and the routing is real: the devices carry different channels
    assert not np.array_equal(outs["1"][0], outs["1"][1])


def test_engine_dispatches_xfade_program_only_on_swap_blocks(tmp_path, rng,
                                                             monkeypatch):
    """The host-selected crossfade program (graph/compile.py xfade_now)
    must be dispatched exactly on blocks whose snapshot carries a
    crossfade (CLI script coeff flips), the plain program elsewhere --
    and a dirac<->dirac crossfade stays the identity."""
    from brutefir_tpu.runtime.device_io import DeviceIO
    N, B = 128, 4
    x = (rng.integers(-(1 << 20), 1 << 20, (N * 8, 1))).astype("<i4")
    inp = tmp_path / "in.raw"
    x.tofile(inp)
    outp = tmp_path / "out.raw"
    # one NEWLINE-separated script line per block (bench5_config format;
    # ';' only joins commands within a block): flip at blocks 2 and 5
    script = "ppk\nppk\ncfc 0 1\nppk\nppk\ncfc 0 0\nppk\nppk"
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
logic: "cli" {{ script: "{script}"; }};
coeff 0 {{ filename: "dirac pulse"; }};
coeff 1 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; crossfade: true; }};
""")
    keys = []
    orig = DeviceIO._program

    def spy(self, uniform, xfade):
        keys.append((bool(uniform), xfade))
        return orig(self, uniform, xfade)

    monkeypatch.setattr(DeviceIO, "_program", spy)
    eng = Engine(conf)
    assert eng.dio is not None
    eng.run()
    # drop warmup dispatches (engine setup warms both variants on a
    # throwaway state); the run's own dispatches follow
    run_keys = [k[1] for k in keys[-8:]]
    assert True in run_keys and False in run_keys
    # the flips land at blocks 2 and 5 (script line k runs at block k)
    assert run_keys[2] is True and run_keys[5] is True
    assert all(k is False for i, k in enumerate(run_keys)
               if i not in (2, 5))
    y = np.fromfile(outp, dtype="<i4")
    np.testing.assert_allclose(y, x[:, 0], atol=1)


def test_dev_null_run_block_accounting(tmp_path):
    """A file -> /dev/null run counts blocks and frames through the EOF
    tail, and an early stop at max_blocks stops exactly there."""
    rng = np.random.default_rng(7)
    frames_total = 8 * 256 + 100
    x = (rng.standard_normal((frames_total, 2)) * 1e6).astype("<i4")
    inp = tmp_path / "in.raw"
    x.tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: 256,4;
coeff 0 {{ filename: "dirac pulse"; }};
input 0,1 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "/dev/null"; }}; sample: "S32_LE"; channels: 2; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")
    eng = Engine(conf)
    assert eng.dio is not None
    stats = eng.run()
    assert stats["blocks"] == 9          # 8 full + 1 partial block
    assert stats["frames"] == frames_total
    eng2 = Engine(conf)
    stats2 = eng2.run(max_blocks=3)
    assert stats2["blocks"] == 3


def test_device_io_s24_4le_wire_pack_matches_host(tmp_path):
    """S24_4LE inputs ship 3 bytes/sample to the device (wire compaction,
    docs/PARITY.md item 12); for in-range data the result must equal the
    host codec path bit-for-bit (within the usual 1-LSB conv rounding)."""
    rng = np.random.default_rng(5)
    N, B = 256, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    x = np.clip(np.round(rng.standard_normal(N * 6) * 2**20),
                -(2**23), 2**23 - 1).astype("<i4")   # in-range S24

    outs = {}
    for mode in ("dio", "host"):
        inp = tmp_path / f"in24_{mode}.raw"
        outp = tmp_path / f"out24_{mode}.raw"
        x.tofile(inp)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S24_4LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S24_4LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
        eng = Engine(conf)
        if mode == "dio":
            assert eng.dio is not None
            assert eng.dio.in_wire[0] == "p24"
        else:
            eng.dio = None
        eng.run()
        outs[mode] = np.fromfile(outp, dtype="<i4")
    assert outs["dio"].shape == outs["host"].shape
    assert np.abs(outs["dio"].astype(np.int64)
                  - outs["host"].astype(np.int64)).max() <= 1


def _mac_conf(tmp_path, x, float_bits=32):
    inp = tmp_path / "in.raw"
    x.tofile(inp)
    return parse_config(f"""
float_bits: {float_bits};
sampling_rate: 44100;
filter_length: 256,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S32_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path / 'o.raw'}"; }}; sample: "S32_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")


@pytest.mark.parametrize("mac,want", [("auto", "jnp"), ("jnp", "jnp")])
def test_mac_choice_without_triton_route(tmp_path, monkeypatch, mac, want):
    """Where the backend cannot compile the Triton kernel (the CPU),
    auto resolves to the dense MAC -- a capability test, not a platform
    name."""
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", mac)
    x = (np.random.RandomState(3).randn(2 * 256, 1) * 1e6).astype("<i4")
    eng = Engine(_mac_conf(tmp_path, x))
    assert eng.cg.mac == want
    stats = eng.run()
    assert stats["frames"] == 2 * 256
    y = np.fromfile(tmp_path / "o.raw", dtype="<i4")
    assert np.abs(y.astype(np.int64) - x[:, 0].astype(np.int64)).max() <= 1


@pytest.mark.parametrize("mac", ["triton", "pallas", "pallas-interpret"])
def test_mac_choice_refused_is_config_error(tmp_path, monkeypatch, mac):
    """An explicit Triton MAC on a backend without a Triton route, and the
    names of removed kernels, are typed config errors, never a silent
    fallback or an interpreted kernel."""
    from brutefir_tpu.errors import BFError, BF_EXIT_INVALID_CONFIG
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", mac)
    x = np.zeros((256, 1), "<i4")
    with pytest.raises(BFError) as ei:
        Engine(_mac_conf(tmp_path, x))
    assert ei.value.exit_code == BF_EXIT_INVALID_CONFIG


@pytest.mark.parametrize("mac", ["auto", "triton"])
def test_triton_mac_engine_matches_dense(tmp_path, monkeypatch,
                                         triton_interpret, mac):
    """With a Triton route (here the interpreter) auto selects the
    kernel; its file-to-file output matches the dense MAC's."""
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((6 * 256, 1)) * 1e6).astype("<i4")
    outs = {}
    for m in (mac, "jnp"):
        monkeypatch.setenv("BRUTEFIR_TPU_MAC", m)
        eng = Engine(_mac_conf(tmp_path, x))
        assert eng.cg.mac == ("triton" if m != "jnp" else "jnp")
        eng.run()
        outs[m] = np.fromfile(tmp_path / "o.raw", dtype="<i4")
    assert np.abs(outs[mac].astype(np.int64) - outs["jnp"]).max() <= 1


def test_float64_graph_keeps_dense_mac(tmp_path, monkeypatch,
                                       triton_interpret):
    """The Triton kernel accumulates in float32, so a float_bits: 64
    graph resolves auto to the dense MAC even where the kernel exists."""
    import jax
    monkeypatch.setenv("BRUTEFIR_TPU_MAC", "auto")
    x = np.zeros((256, 1), "<i4")
    try:
        eng = Engine(_mac_conf(tmp_path, x, float_bits=64))
        assert eng.cg.mac == "jnp"
    finally:
        # the engine switches 64-bit types on process-wide
        jax.config.update("jax_enable_x64", False)


def test_device_io_s24_3byte_matches_host(tmp_path):
    """3-byte packed S24_LE is device-codec eligible (the file bytes are
    the wire format verbatim); the result must match the host codec."""
    rng = np.random.default_rng(9)
    N, B = 256, 4
    taps = (rng.standard_normal(N * B) * 0.1).astype(np.float32)
    tap_file = tmp_path / "t.txt"
    tap_file.write_text("\n".join(repr(float(v)) for v in taps))
    vals = np.clip(np.round(rng.standard_normal(N * 6) * 2**20),
                   -(2**23), 2**23 - 1).astype("<i4")
    raw3 = vals.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()

    outs = {}
    for mode in ("dio", "host"):
        inp = tmp_path / f"in3_{mode}.raw"
        outp = tmp_path / f"out3_{mode}.raw"
        open(inp, "wb").write(raw3)
        conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "{tap_file}"; format: "TEXT"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "S24_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "S24_LE"; channels: 1; dither: false; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
        eng = Engine(conf)
        if mode == "dio":
            assert eng.dio is not None
            assert eng.dio.in_wire[0] == "raw3"
            assert eng.dio.out_wire[0] == "raw3"
        else:
            eng.dio = None
        eng.run()
        b = np.fromfile(outp, dtype=np.uint8).reshape(-1, 3)
        w = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        outs[mode] = w - ((w & 0x800000) << 1)
    assert outs["dio"].shape == outs["host"].shape == (N * 6,)
    assert np.abs(outs["dio"].astype(np.int64)
                  - outs["host"].astype(np.int64)).max() <= 1


def test_run_offline_enforces_safety_limit(tmp_path, rng):
    """The batched offline writer aborts on safety_limit like write_block_dio
    (reference real2raw.h:32-42)."""
    from brutefir_tpu.runtime.engine import EngineError
    N = 128
    x = np.full(N * 8, 1000.0, np.float32)
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},2;
safety_limit: 20;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    eng = Engine(conf)
    assert eng.dio is not None
    with pytest.raises(EngineError, match="safety limit"):
        eng.run_offline(batch_blocks=4)
