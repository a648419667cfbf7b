"""Frequency-domain module hooks, peak push, and external logic modules.

Mirrors the reference's bfevents table (bfmod.h:192-215): dispatch order
block_start -> input_timed -> input_freqd -> pre_convolve -> post_convolve
-> output_freqd -> output_timed (bfrun.c:1448-1920), the BF_FDEVENT_PEAK
push on overflow change (bfrun.c:589-618), and dlopen-style loading of
third-party logic modules from modules_path (bfconf.c:2172-2198).
"""

import numpy as np
import pytest

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime.engine import Engine

IN, OUT = 0, 1


def simple_conf(tmp_path, x, N=64, extra="", nblocks=1):
    inp, outp = tmp_path / "in.f32", tmp_path / "out.f32"
    x.astype("<f4").tofile(inp)
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{nblocks};
{extra}
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    return conf, outp


def test_hook_dispatch_order(tmp_path, rng):
    # one block: output_timed runs on the writer thread one block behind
    # (the reference's output process is equally pipelined), so a
    # multi-block run interleaves it with the next block_start
    N = 64
    x = rng.standard_normal(N).astype(np.float32) * 0.25
    conf, outp = simple_conf(tmp_path, x, N)
    calls = []

    class AllHooks:
        def block_start(self, k):
            calls.append(("block_start", k))

        def input_timed(self, buf, ch):
            calls.append(("input_timed", ch))

        def input_freqd(self, buf, ch):
            assert buf.shape == (N + 1,) and np.iscomplexobj(buf)
            calls.append(("input_freqd", ch))

        def pre_convolve(self, buf, f):
            calls.append(("pre_convolve", f))

        def post_convolve(self, buf, f):
            calls.append(("post_convolve", f))

        def output_freqd(self, buf, ch):
            calls.append(("output_freqd", ch))

        def output_timed(self, buf, ch):
            calls.append(("output_timed", ch))

    eng = Engine(conf)
    eng.logic.append(AllHooks())
    eng.run()  # attach_logic scans pre-appended modules too
    kinds = [k for k, _ in calls]
    order = ["block_start", "input_timed", "input_freqd", "pre_convolve",
             "post_convolve", "output_freqd", "output_timed"]
    # the writer thread runs one block behind (like the reference's output
    # process), so assert first-occurrence ordering across the kinds
    firsts = [kinds.index(k) for k in order]
    assert all(k in kinds for k in order)
    assert firsts == sorted(firsts)
    # output must be untouched by the pass-through taps
    y = np.fromfile(outp, dtype="<f4")
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_freqd_hook_mutation_flows_back(tmp_path, rng):
    """A hook that scales the output spectrum by 2 doubles the output
    (the reference's buffers are mutable in place)."""
    N = 64
    x = rng.standard_normal(N * 3).astype(np.float32) * 0.1
    conf, outp = simple_conf(tmp_path, x, N)

    class Doubler:
        def output_freqd(self, buf, ch):
            buf *= 2.0

    eng = Engine(conf)
    eng.logic.append(Doubler())
    eng.run()
    y = np.fromfile(outp, dtype="<f4")
    np.testing.assert_allclose(y, 2.0 * x, atol=1e-4)


def test_pre_convolve_mutation_persists_in_ring(tmp_path, rng):
    """Zeroing the newest ring block in pre_convolve silences both the
    current block and its echo in later partitions (the tap writes the
    ring storage, like cbuf[n][curblock] in bfrun.c:1688-1690)."""
    N, B = 64, 4
    x = np.zeros(N * 6, np.float32)
    x[: N] = 0.5  # only block 0 carries signal
    conf, outp = simple_conf(tmp_path, x, N, nblocks=B)

    class Silencer:
        def pre_convolve(self, buf, f):
            buf[:] = 0.0

    eng = Engine(conf)
    eng.logic.append(Silencer())
    eng.run()
    y = np.fromfile(outp, dtype="<f4")
    np.testing.assert_allclose(y, 0.0, atol=1e-6)


def test_peak_push_on_overflow_change(tmp_path):
    N = 64
    x = np.zeros(N * 4, np.float32)
    x[N * 2] = 3.5  # overflow (> 1.0 float max) in block 2 only
    conf, outp = simple_conf(tmp_path, x, N)
    pushes = []

    class PeakWatcher:
        def peak(self):
            pushes.append(True)

    eng = Engine(conf)
    eng.logic.append(PeakWatcher())
    eng.run()
    assert len(pushes) == 1  # exactly one change event, not one per block


def test_external_logic_module_loading(tmp_path, rng):
    """A third-party bflogic_<name>.py on modules_path loads and gets
    block_start + command dispatch (bfconf.c:2172-2198 analog)."""
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "bflogic_blinker.py").write_text("""
from brutefir_tpu.control import register_logic_module

class Blinker:
    instances = []

    def __init__(self, params, engine):
        self.engine = engine
        self.blocks = []
        Blinker.instances.append(self)

    def block_start(self, k):
        self.blocks.append(k)

    def command(self, params):
        return True, f"blink {params}"

register_logic_module("blinker", lambda params, engine: Blinker(params, engine))
""")
    N = 64
    x = rng.standard_normal(N * 3).astype(np.float32) * 0.2
    conf, outp = simple_conf(
        tmp_path, x, N,
        extra=f'modules_path: "{mod_dir}";\nlogic: "blinker" {{ }};')
    Engine(conf).run()
    import sys
    blinker_mod = sys.modules["bflogic_blinker"]
    inst = blinker_mod.Blinker.instances[-1]
    assert inst.blocks[:3] == [0, 1, 2]
    ok, msg = inst.command("hello")
    assert ok and msg == "blink hello"


def _poll_input_cls(x_bytes, drip):
    """A clocked, misaligned input device delivering data in dribs."""
    from brutefir_tpu.io import IoDevice
    from brutefir_tpu.core.sampleformat import parse_sample_format

    class PollIn(IoDevice):
        uses_sample_clock = True
        bad_alignment = True
        calls = {"nonblock": 0, "none": 0}

        def __init__(self, params, io, sample_format, sample_rate,
                     open_channels):
            super().__init__(params, io, parse_sample_format("FLOAT_NE"),
                             sample_rate, open_channels)
            self.pos = 0

        def read_nonblock(self, nbytes):
            PollIn.calls["nonblock"] += 1
            if PollIn.calls["nonblock"] % 3 == 0:
                PollIn.calls["none"] += 1
                return None  # EAGAIN analog
            if self.pos >= len(x_bytes):
                return b""   # EOF
            chunk = x_bytes[self.pos: self.pos + min(drip, nbytes)]
            self.pos += len(chunk)
            return chunk

        def read(self, nbytes):
            raise AssertionError("poll mode must use read_nonblock")

    return PollIn


def test_input_poll_mode(tmp_path, rng):
    """allow_poll_mode + misaligned clocked input: paced nonblocking reads
    assemble full fragments (dai.c:1198-1230)."""
    from brutefir_tpu.io import register_io_module
    N = 64
    x = rng.standard_normal(N * 3).astype("<f4")
    cls = _poll_input_cls(x.tobytes(), drip=100)
    register_io_module("pollin", cls)
    outp = tmp_path / "out.f32"
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
allow_poll_mode: true;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "pollin" {{ }}; sample: "FLOAT_NE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf).run()
    y = np.fromfile(outp, dtype="<f4")
    np.testing.assert_allclose(y, x, atol=1e-5)
    assert cls.calls["none"] > 0  # the EAGAIN path was really exercised


def test_poll_mode_refused_when_not_allowed(tmp_path, rng):
    from brutefir_tpu.io import register_io_module
    from brutefir_tpu.runtime.engine import EngineError
    N = 64
    cls = _poll_input_cls(b"\0" * (N * 4), drip=64)
    register_io_module("pollin2", cls)
    outp = tmp_path / "out.f32"
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N};
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "pollin2" {{ }}; sample: "FLOAT_NE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    with pytest.raises(EngineError, match="poll mode"):
        Engine(conf)
