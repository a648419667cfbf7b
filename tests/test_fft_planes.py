"""The packed real transforms (rfft_planes / irfft_planes /
irfft_planes_valid) against numpy float64, over channel prefixes, bin
counts from 2 to 8192, and both float widths.

Packed convention: the Nyquist bin rides in the imaginary slot of bin 0
(fftw_convfuns.h:503-561 keeps the two real bins together the same way).
Tolerance: ``20 * eps * log2(2M)`` of the oracle's peak -- the textbook
O(eps log n) rounding of an FFT, with margin for XLA's and cuFFT's
different radix orders.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from brutefir_tpu.ops import partconv as pc

SHAPES = [(3, 256), (2, 1024), (1, 8192), (5, 128), (4, 16), (2, 2)]
DTYPES = [np.float32, np.float64]


def _tol(ref, M, dtype):
    eps = np.finfo(dtype).eps
    return 20 * eps * math.log2(2 * M) * max(np.abs(ref).max(), 1e-30)


def np_rfft_planes(x):
    X = np.fft.rfft(np.asarray(x, np.float64), axis=-1)
    M = X.shape[-1] - 1
    packed = np.concatenate(
        [X[..., :1].real + 1j * X[..., M:].real, X[..., 1:M]], axis=-1)
    return np.stack([packed.real, packed.imag], axis=-2)


def np_irfft_planes(p):
    p = np.asarray(p, np.float64)
    z = p[..., 0, :] + 1j * p[..., 1, :]
    full = np.concatenate([z[..., :1].real + 0j, z[..., 1:],
                           z[..., :1].imag + 0j], axis=-1)
    return np.fft.irfft(full, axis=-1)


def _run(fn, a, dtype):
    with jax.enable_x64(dtype == np.float64):
        out = fn(jnp.asarray(a, dtype))
        assert out.dtype == dtype
        return np.asarray(out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,M", SHAPES)
def test_rfft_planes_matches_numpy(rng, C, M, dtype):
    x = rng.standard_normal((C, 2 * M))
    ref = np_rfft_planes(x)
    got = _run(pc.rfft_planes, x, dtype)
    assert got.shape == (C, 2, M)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, M, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_planes_matches_numpy(rng, C, M, dtype):
    p = rng.standard_normal((C, 2, M))
    ref = np_irfft_planes(p)
    got = _run(pc.irfft_planes, p, dtype)
    assert got.shape == (C, 2 * M)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, M, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,M", SHAPES)
def test_irfft_planes_valid_is_lower_half(rng, C, M, dtype):
    p = rng.standard_normal((C, 2, M))
    ref = np_irfft_planes(p)[..., :M]
    got = _run(pc.irfft_planes_valid, p, dtype)
    assert got.shape == (C, M)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, M, dtype))


@pytest.mark.parametrize("M", [256, 2048])
def test_irfft_full_knob_matches_untangle(rng, monkeypatch, M):
    """BRUTEFIR_TPU_IRFFT=full (XLA's full-size inverse, lower half) and
    the default half-size untangle agree to rounding."""
    p = jnp.asarray(rng.standard_normal((3, 2, M)).astype(np.float32))
    a = np.asarray(pc.irfft_planes_valid(p))
    monkeypatch.setenv("BRUTEFIR_TPU_IRFFT", "full")
    b = np.asarray(pc.irfft_planes_valid(p))
    np.testing.assert_allclose(a, b, rtol=0, atol=_tol(a, M, np.float32))


def test_roundtrip_identity(rng):
    x = rng.standard_normal((4, 512)).astype(np.float32)
    back = np.asarray(pc.irfft_planes(pc.rfft_planes(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


def test_multidim_prefix(rng):
    """Any channel prefix is accepted (the crossfade passes [F, 2, N])."""
    p = rng.standard_normal((2, 3, 2, 256))
    ref = np_irfft_planes(p)
    got = _run(pc.irfft_planes, p, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=_tol(ref, 256, np.float32))


def test_pack_unpack_roundtrip(rng):
    """pack_spectrum / unpack_spectrum invert each other on real-DC,
    real-Nyquist spectra (numpy and jnp inputs alike)."""
    X = np.fft.rfft(rng.standard_normal(64))
    packed = pc.pack_spectrum(X)
    assert packed.shape == (32,)
    assert packed[0] == X[0].real + 1j * X[32].real
    np.testing.assert_allclose(pc.unpack_spectrum(packed), X, atol=1e-12)
    pj = pc.pack_spectrum(jnp.asarray(X.astype(np.complex64)))
    np.testing.assert_allclose(np.asarray(pc.unpack_spectrum(pj)), X,
                               rtol=0, atol=1e-4)
