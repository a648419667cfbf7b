"""Opt-in pre-FFT-hoisted multi_step == default scanned multi_step.

The hoisted variant (BRUTEFIR_TPU_PREFFT=1) batches decode/delay/framing/
forward-rfft of the whole batch before the scan; it is kept as an opt-in
experiment (see device_io.multi_step) and must
stay semantically identical to the default scanned path.
"""

import numpy as np
import pytest

from brutefir_tpu.config import parse_config
from brutefir_tpu.runtime import Engine


def _run(tmp_path, rng, monkeypatch, prefft, dither, tag):
    N, B, C = 128, 4, 2
    nblocks = 12
    x = (rng.standard_normal((N * nblocks, C)) * 0.3).astype("<f4")
    inp = tmp_path / f"in_{tag}.f32"
    outp = tmp_path / f"out_{tag}.raw"
    x.tofile(inp)
    sample_out = "S16_LE" if dither else "FLOAT_LE"
    chans = ",".join(str(i) for i in range(C))
    conf = parse_config(f"""
sampling_rate: 44100;
filter_length: {N},{B};
coeff 0 {{ filename: "dirac pulse"; }};
input {chans} {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: {C}; }};
output {chans} {{ device: "file" {{ path: "{outp}"; }}; sample: "{sample_out}"; channels: {C}; dither: {str(dither).lower()}; }};
""" + "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: 0; }};"
        for i in range(C)))
    conf.quiet = True
    monkeypatch.setenv("BRUTEFIR_TPU_PREFFT", "1" if prefft else "0")
    eng = Engine(conf)
    assert eng.dio is not None
    eng.run_offline(batch_blocks=4)
    if dither:
        return np.fromfile(outp, dtype="<i2")
    return np.fromfile(outp, dtype="<f4")


@pytest.mark.parametrize("dither", [False, True])
def test_prefft_matches_scanned(tmp_path, rng, monkeypatch, dither):
    rng2 = np.random.default_rng(7)
    a = _run(tmp_path, rng2, monkeypatch, prefft=False, dither=dither,
             tag=f"scan{dither}")
    rng2 = np.random.default_rng(7)
    b = _run(tmp_path, rng2, monkeypatch, prefft=True, dither=dither,
             tag=f"pre{dither}")
    assert a.shape == b.shape
    if dither:
        # a 1-ulp fft difference can flip a dithered LSB
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
