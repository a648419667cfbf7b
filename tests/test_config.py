"""Config-language parser tests against the reference's shipped configs."""

import os

import numpy as np
import pytest

from brutefir_tpu.config.lexer import tokenize, T, ConfigParseError
from brutefir_tpu.config.parser import parse_config, parse_config_file, from_db
from brutefir_tpu.config.model import IN, OUT

REF = os.path.join(os.path.dirname(__file__), "data")


def test_lexer_basics():
    toks = list(tokenize('filter "a" { coeff: -1; attenuation: 3.5; x: 1e+02; }'))
    kinds = [t.kind for t in toks]
    assert kinds == [T.FILTER, T.STRING, T.LBRACE, T.FIELD, T.REAL, T.EOS,
                     T.FIELD, T.REAL, T.EOS, T.FIELD, T.REAL, T.EOS,
                     T.RBRACE, T.EOF]
    assert toks[4].value == -1.0
    assert toks[10].value == 100.0


def test_lexer_string_escapes_and_comments():
    toks = list(tokenize('# comment\nx: "a\\"b\\nc"; # trailing\n'))
    assert toks[1].value == 'a"b\nc'


def test_parse_bench3():
    conf = parse_config_file(f"{REF}/bench3_config")
    assert conf.sampling_rate == 44100
    assert conf.filter_length == 65536 and conf.n_blocks == 1
    assert conf.benchmark is True
    assert len(conf.coeffs) == 1 and conf.coeffs[0].filename == "dirac pulse"
    assert conf.n_channels[IN] == 26 and conf.n_channels[OUT] == 26
    assert len(conf.filters) == 26
    assert conf.filters[5].in_channels == [(5, 1.0)]
    assert conf.filters[5].out_channels == [(5, 1.0)]
    assert conf.iodevs[IN][0].sample_format.name == "S24_4LE"
    assert conf.iodevs[OUT][0].apply_dither is False


def test_parse_bench2_partitioned():
    conf = parse_config_file(f"{REF}/bench2_config")
    assert conf.filter_length == 8192 and conf.n_blocks == 8


def test_parse_bench1_cascade():
    conf = parse_config_file(f"{REF}/bench1_config")
    assert len(conf.filters) == 6
    f0 = conf.filters[0]
    assert f0.in_filters == [(2, 1.0), (5, 1.0)]
    assert f0.out_channels == [(0, 1.0)]
    assert conf.filters[2].out_filters == [0]
    assert len(conf.coeffs) == 6


def test_parse_bench4_kitchen_sink():
    conf = parse_config_file(f"{REF}/bench4_config")
    assert conf.filter_length == 4096 and conf.n_blocks == 13
    assert conf.coeffs[1].n_blocks == 1
    # input 0..5 mapped onto 2 used channels of a 4-channel device
    dev = conf.iodevs[IN][0]
    assert dev.open_channels == 4 and dev.channel_selection == [0, 3]
    assert dev.virt2phys_local == [0, 1, 0, 1, 0, 1]
    assert conf.n_channels[IN] == 8 and conf.n_physical_channels[IN] == 4
    assert conf.virt2phys[IN][:6] == [0, 1, 0, 1, 0, 1]
    assert conf.n_virtperphys[IN][0] == 3 and conf.n_virtperphys[IN][1] == 3
    # S8 device occupies physical channels 2,3
    assert conf.virt2phys[IN][6] == 2 and conf.virt2phys[IN][7] == 3
    # edge gains: 0//-1 -> mult -1 (polarity); 1//2 -> mult 2
    f0 = conf.filters[0]
    assert f0.in_channels[0] == (0, -1.0)
    assert f0.in_channels[1] == (1, 2.0)
    assert f0.delayblocks == 1
    assert f0.out_channels[0][1] == pytest.approx(from_db(-3.0))
    assert f0.out_filters == [2, 1]
    f1 = conf.filters[1]
    assert f1.in_filters[0] == (0, pytest.approx(from_db(-3.0)))
    assert f1.out_channels[0][1] == pytest.approx(from_db(-5.32))
    # outputs: S16_LE dithered + FLOAT_NE undithered
    assert conf.iodevs[OUT][0].apply_dither is True
    assert conf.iodevs[OUT][1].sample_format.is_float


def test_parse_bench5_crossfade_script():
    conf = parse_config_file(f"{REF}/bench5_config")
    assert all(f.crossfade for f in conf.filters)
    assert len(conf.logic_modules) == 1
    name, params = conf.logic_modules[0]
    assert name == "cli"
    fields = [t.value for t in params if t.kind == T.FIELD]
    assert "echo" in fields and "script" in fields


def test_parse_xtc_names():
    conf = parse_config_file(f"{REF}/xtc_config")
    assert conf.filter_length == 64 and conf.n_blocks == 64
    assert conf.channel_names[IN] == ["left", "right"]
    assert len(conf.coeffs) == 2 and conf.coeffs[0].name == "direct path"
    # channels 26/24,25: physical selection 24,25 of 26 open
    dev = conf.iodevs[IN][0]
    assert dev.open_channels == 26 and dev.channel_selection == [24, 25]
    f = conf.filters[1]
    assert f.name == "left speaker cross path"
    assert f.coeff == 1  # "cross path"
    assert f.in_channels == [(1, 1.0)] and f.out_channels == [(0, 1.0)]


def test_parse_massive():
    conf = parse_config_file(f"{REF}/massive_config")
    assert conf.filter_length == 8192 and conf.n_blocks == 16
    assert len(conf.filters) == 26
    assert conf.iodevs[IN][0].device_name == "alsa"


def test_validation_errors():
    base = """
sampling_rate: 44100; filter_length: 1024;
coeff 0 { filename: "dirac pulse"; };
input 0 { device: "file" {}; sample: "S16_LE"; channels: 1; };
output 0 { device: "file" {}; sample: "S16_LE"; channels: 1; };
"""
    with pytest.raises(ConfigParseError, match="out of range"):
        parse_config(base + 'filter 0 { from_inputs: 5; to_outputs: 0; coeff: 0; };')
    with pytest.raises(ConfigParseError, match="does not exist"):
        parse_config(base + 'filter 0 { from_inputs: 0; to_outputs: 0; coeff: "nope"; };')
    with pytest.raises(ConfigParseError, match="must exist"):
        parse_config(base + '''
filter 0 { from_inputs: 0; to_filters: 1; coeff: 0; };
filter 1 { from_inputs: 0; to_outputs: 0; coeff: 0; };''')
    with pytest.raises(ConfigParseError, match="loop"):
        parse_config(base + '''
filter 0 { from_filters: 1; to_filters: 1; coeff: 0; };
filter 1 { from_filters: 0; to_filters: 0; from_inputs: 0; to_outputs: 0; coeff: 0; };''')
    with pytest.raises(ConfigParseError, match="not a power of 2"):
        parse_config('sampling_rate: 1; filter_length: 1000;')


def test_defaults_layering(tmp_path):
    from brutefir_tpu.config.defaults import DEFAULT_CONFIG_TEXT
    main = """
filter "f" { from_inputs: 0; to_outputs: 0; coeff: 0; };
coeff 0 { filename: "dirac pulse"; format: "PROCESSED"; };
input 0, 1 { device: "file" {}; sample: "S16_LE"; channels: 2; };
output 0, 1 { device: "file" {}; sample: "S16_LE"; channels: 2; };
"""
    conf = parse_config(main, defaults_text=DEFAULT_CONFIG_TEXT)
    assert conf.sampling_rate == 44100      # from defaults
    assert conf.filter_length == 65536      # from defaults
    assert conf.realsize == 4
    assert conf.filters[0].crossfade is False


def test_delay_and_subdelay_arrays():
    body = """
sampling_rate: 44100; filter_length: 256;
coeff 0 { filename: "dirac pulse"; };
input 0, 1 { device: "file" {}; sample: "S16_LE"; channels: 2;
             delay: 3, 7; subdelay: 5, -2; maxdelay: 100; };
output 0, 1 { device: "file" {}; sample: "S16_LE"; channels: 2;
              mute: true, false; };
filter 0 { from_inputs: 0, 1; to_outputs: 0, 1; coeff: 0; };
"""
    conf = parse_config("sdf_length: 16;" + body)
    assert conf.delay[IN][:2] == [3, 7]
    assert conf.subdelay[IN][:2] == [5, -2]
    assert conf.maxdelay[IN][:2] == [100, 100]
    assert conf.mute[OUT][:2] == [True, False]
    assert conf.use_subdelay[IN] is True
    # without sdf_length the subdelay subsystem is silently disabled
    # (bfconf.c:2796-2798)
    assert parse_config(body).use_subdelay == [False, False]


def test_processed_roundtrip(rng):
    """PROCESSED on-disk layout round-trips through our spectral form."""
    from brutefir_tpu.config.coeffs import (
        processed_to_spectral, spectral_to_processed)
    N = 64
    H = (rng.standard_normal((3, N + 1)) +
         1j * rng.standard_normal((3, N + 1))).astype(np.complex64)
    H[:, 0] = H[:, 0].real
    H[:, -1] = H[:, -1].real
    cbuf = spectral_to_processed(H)
    assert cbuf.shape == (3, 2 * N)
    back = processed_to_spectral(cbuf)
    np.testing.assert_allclose(back, H, rtol=0, atol=2e-4 * np.abs(H).max())


def test_processed_file_load(tmp_path, rng):
    """A PROCESSED coeff file equals preprocessing the equivalent taps."""
    from brutefir_tpu.config.coeffs import (
        spectral_to_processed, load_coeff_bank_entry)
    from brutefir_tpu.config.model import CoeffDef
    from brutefir_tpu.ops.partconv import preprocess_coeffs, unpack_spectrum
    N, B = 64, 2
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.3
    Hp = preprocess_coeffs(taps, N, B)            # packed [B, N]
    H = unpack_spectrum(Hp)                       # [B, N+1]
    path = tmp_path / "c.proc"
    spectral_to_processed(H).astype(np.float32).tofile(path)
    c = CoeffDef(name="p", intname=0, format="PROCESSED",
                 filename=str(path), n_blocks=B)
    got = load_coeff_bank_entry(c, N, B)
    np.testing.assert_allclose(got, Hp, rtol=0, atol=2e-3 * np.abs(Hp).max())


def test_external_io_module(tmp_path):
    from brutefir_tpu.io import get_io_module, IoModuleError
    mod = tmp_path / "bfio_mymod.py"
    mod.write_text("""
from brutefir_tpu.io import IoDevice, register_io_module
class MyDev(IoDevice):
    pass
register_io_module("mymod", MyDev)
""")
    cls = get_io_module("mymod", str(tmp_path))
    assert cls.__name__ == "MyDev"
    with pytest.raises(IoModuleError):
        get_io_module("nonexistent", str(tmp_path))


def test_benchmark_requires_nodefault():
    from brutefir_tpu.config.defaults import DEFAULT_CONFIG_TEXT
    with pytest.raises(ConfigParseError, match="nodefault"):
        parse_config("""
benchmark: true;
coeff 0 { filename: "dirac pulse"; format: "PROCESSED"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "S16_LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "S16_LE"; channels: 1; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""", defaults_text=DEFAULT_CONFIG_TEXT)


def test_benchmark_powersave_exclusive():
    with pytest.raises(ConfigParseError, match="cannot both"):
        parse_config("""
sampling_rate: 44100; filter_length: 256;
benchmark: true; powersave: true;
coeff 0 { filename: "dirac pulse"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "S16_LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "S16_LE"; channels: 1; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""")


def test_route_alias():
    conf = parse_config("""
sampling_rate: 44100; filter_length: 256;
coeff 0 { filename: "dirac pulse"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "S16_LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "S16_LE"; channels: 1; };
route 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""")
    assert len(conf.filters) == 1


def test_shm_processed_coefficients(rng):
    """filename: shmid/offset/blocks reads PROCESSED data from SysV shm."""
    import ctypes
    from brutefir_tpu.config.coeffs import (
        spectral_to_processed, load_coeff_bank_entry)
    from brutefir_tpu.config.model import CoeffDef
    from brutefir_tpu.ops.partconv import preprocess_coeffs, unpack_spectrum

    libc = ctypes.CDLL(None, use_errno=True)
    libc.shmat.restype = ctypes.c_void_p
    IPC_CREAT, IPC_RMID = 0o1000, 0
    N, B = 64, 2
    taps = rng.standard_normal(N * B).astype(np.float32) * 0.3
    Hp = preprocess_coeffs(taps, N, B)
    payload = spectral_to_processed(unpack_spectrum(Hp)).astype(np.float32)
    data = payload.tobytes()
    shmid = libc.shmget(0, len(data), IPC_CREAT | 0o600)
    if shmid < 0:
        pytest.skip("SysV shm unavailable")
    try:
        ptr = libc.shmat(shmid, None, 0)
        ctypes.memmove(ptr, data, len(data))
        libc.shmdt(ctypes.c_void_p(ptr))
        c = CoeffDef(name="shm", intname=0, format="PROCESSED",
                     shm_parts=[(shmid, 0, B)], n_blocks=B, is_shared=True)
        got = load_coeff_bank_entry(c, N, B)
        np.testing.assert_allclose(got, Hp, rtol=0,
                                   atol=2e-3 * np.abs(Hp).max())
    finally:
        libc.shmctl(shmid, IPC_RMID, None)
