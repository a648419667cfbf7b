"""Regression tests for the round-3 ops/core review findings."""

import numpy as np
import jax.numpy as jnp
import pytest

from brutefir_tpu.ops import partconv as pc


@pytest.mark.parametrize("M", [384, 640])
def test_valid_inverse_odd_row_count(M, rng):
    """Bin counts whose half is not a power of two: the valid-half
    inverse (half-size untangle) equals the full inverse's lower half."""
    p = jnp.asarray(rng.standard_normal((2, 2, M)).astype(np.float32))
    ref = np.asarray(pc.irfft_packed(pc.p2c(p)))[..., :M]
    got = np.asarray(pc.irfft_planes_valid(p))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())


def test_complex_mix_keeps_float32_mantissa(rng):
    """The channel mixes run at HIGHEST precision: the result matches a
    float64 contraction to float32 accuracy (a TF32 or bf16 pass would
    be off by ~1e-3 relative)."""
    mix = rng.standard_normal((5, 7)).astype(np.float32)
    x = rng.standard_normal((7, 2, 256)).astype(np.float32)
    got = np.asarray(pc.complex_mix(jnp.asarray(mix), jnp.asarray(x)))
    ref = np.einsum("af,fpn->apn", mix.astype(np.float64), x)
    bound = 8 * 2.0 ** -24 * np.einsum("af,fpn->apn", np.abs(mix), np.abs(x))
    assert np.all(np.abs(got - ref) <= bound)


def test_native_quantize_nan_consistent():
    """NaN input: the scalar and rows no-dither quantizers agree
    (saturate to imin, count an overflow) -- the scalar path used to
    hit an unguarded (int32_t)NaN cast (UB)."""
    from brutefir_tpu.core.codecs import Overflow, quantize_no_dither
    from brutefir_tpu.core.sampleformat import parse_sample_format
    fmt = parse_sample_format("S16_LE")
    x = np.array([0.25 * 32767, np.nan, -0.75 * 32767, np.nan], np.float32)
    ovf = Overflow(max=float(fmt.imax))
    q = quantize_no_dither(x, fmt, ovf)
    imin = -(1 << 15)
    assert q[1] == imin and q[3] == imin
    assert ovf.n_overflows == 2


def test_dither_table_error_names_real_floor():
    """The too-small error message quotes the binding floor (which may
    be max_samples_per_loop, not sample_rate)."""
    from brutefir_tpu.core.dither import DitherTable
    with pytest.raises(ValueError) as e:
        DitherTable(4, 48000, max_size=1000, max_samples_per_loop=65536)
    assert "262144" in str(e.value)  # 4 channels * 65536 floor


def test_s8_device_codec_eligible():
    """1-byte formats have no endianness; S8 must stay device-codec
    eligible regardless of host byte order."""
    from brutefir_tpu.core.sampleformat import parse_sample_format
    from brutefir_tpu.ops.device_codec import device_format_word
    assert device_format_word(parse_sample_format("S8")) == np.dtype(np.int8)
