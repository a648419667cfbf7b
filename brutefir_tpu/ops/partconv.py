"""Partitioned overlap-save convolution primitives.

Device formulation of the reference convolver (`fftw_convolver.c`,
`fftw_convfuns.h`). The reference's conventions, restated in rfft terms:

* An input block is the 2N-point frame ``[previous N samples, new N samples]``
  (`convolver_raw2cbuf` fftw_convolver.c:170-194 + bfrun.c double buffering).
* A coefficient partition places its N taps in the *upper* half of a zeroed
  2N buffer before the forward transform (`convolver_coeffs2cbuf`
  fftw_convolver.c:526-573). Equivalently ``H[k] = (-1)^k * rfft(taps, 2N)``.
  The reference folds a 1/n_fft factor into H and uses unnormalized FFTs;
  we use numpy/XLA-normalized irfft instead, so the factor disappears:
  ``time = irfft(X * H_ours)`` with ``H_ours = rfft(shifted taps)``.
* Because of the upper-half placement, the *valid* (non-time-aliased) output
  region after the inverse transform is the **lower** half of the 2N frame.
* The per-block output spectrum is a multiply-accumulate across partitions
  against a ring of the last B input spectra:
  ``Y[t] = sum_i X[(t-i) mod B] * H[i]`` (`bfrun.c:1737-1754`).
* A "dirac pulse" coefficient is the spectrum ``(-1)^k`` (delta at offset N):
  the reference's dirac_convolve multiplies by alternating-sign 1/n_fft
  (`fftw_convfuns.h:592-619`); in our normalization that is just (-1)^k.

**Packed spectra.** Device-side spectra use a packed N-bin layout: the real
Nyquist bin rides in the imaginary slot of the real DC bin
(``Xp[0] = X[0].re + 1j X[N].re``), the same folding the reference's SIMD
layout uses (`fftw_convfuns.h` stores Nyquist at index 4 of group 0 and
special-cases bins 0/N in every convolve kernel). This keeps every spectral
axis a power of two -- a clean block size for GPU kernels and evenly
shardable across devices. Bin 0 of a packed spectral product
multiplies real and imaginary parts *separately* (two independent real
spectra), exactly the d1s/d2s special case of the reference kernels.

The dense jnp MAC below is the production path on every backend; XLA
fuses its bank gather into the partition reduction.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp


def pack_spectrum(H):
    """[..., N+1] rfft spectrum -> packed [..., N] (numpy or jnp)."""
    xp = jnp if isinstance(H, jax.Array) else np
    dc = H[..., :1].real + 1j * H[..., -1:].real
    return xp.concatenate([dc.astype(H.dtype), H[..., 1:-1]], axis=-1)


def unpack_spectrum(Hp):
    """packed [..., N] -> [..., N+1] rfft spectrum (numpy or jnp)."""
    xp = jnp if isinstance(Hp, jax.Array) else np
    dc = Hp[..., :1].real.astype(Hp.dtype)
    nyq = Hp[..., :1].imag.astype(Hp.dtype)
    return xp.concatenate([dc, Hp[..., 1:], nyq], axis=-1)


def rfft_packed(x):
    """rfft of real ``x [..., 2M]`` -> packed spectrum ``[..., M]``: the
    full-size real transform (cuFFT on the GPU) plus the bin-0 pack."""
    return pack_spectrum(jnp.fft.rfft(x, axis=-1))


def irfft_packed(Xp):
    """Inverse of :func:`rfft_packed`: packed ``[..., M]`` -> real
    ``[..., 2M]`` via an M-point complex inverse FFT + interleave."""
    M = Xp.shape[-1]
    if M < 2:
        return jnp.fft.irfft(unpack_spectrum(Xp), axis=-1)
    dc = Xp[..., :1].real
    nyq = Xp[..., :1].imag
    zero = jnp.zeros_like(dc)
    Xfull = jnp.concatenate(
        [jax.lax.complex(dc, zero).astype(Xp.dtype), Xp[..., 1:],
         jax.lax.complex(nyq, zero).astype(Xp.dtype)], axis=-1)  # [..., M+1]
    Xk = Xfull[..., :M]
    Xr = jnp.conj(jnp.flip(Xfull[..., 1:], axis=-1))   # X[M-k], k=0..M-1
    Xe = (Xk + Xr) * 0.5
    k = jnp.arange(M)
    Wp = jnp.exp(1j * jnp.pi * k / M).astype(Xp.dtype)
    Xo = (Xk - Xr) * (0.5 * Wp)
    z = jnp.fft.ifft(Xe + 1j * Xo, axis=-1)
    return jnp.stack([z.real, z.imag], axis=-1).reshape(
        *z.shape[:-1], 2 * M)


# --- dual-plane representation -------------------------------------------
#
# On device, spectra are carried as separate real/imag float planes,
# shape [..., 2, N] (plane axis second-to-last), never as a complex dtype:
# planes keep the MAC and the channel mixes plain real elementwise ops and
# real matmuls over contiguous power-of-two rows.

def c2p(z: jnp.ndarray) -> jnp.ndarray:
    """complex [..., N] -> float planes [..., 2, N]."""
    return jnp.stack([z.real, z.imag], axis=-2)


def p2c(p: jnp.ndarray) -> jnp.ndarray:
    """float planes [..., 2, N] -> complex [..., N]."""
    return jax.lax.complex(p[..., 0, :], p[..., 1, :])


def np_c2p(z: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.stack([z.real, z.imag], axis=-2))


def np_p2c(p: np.ndarray) -> np.ndarray:
    """float planes [..., 2, N] -> packed complex [..., N] (numpy)."""
    return p[..., 0, :] + 1j * p[..., 1, :]


def make_bank(entries) -> np.ndarray:
    """Stack per-coeff packed complex entries [B, N] into the device bank
    layout [n_entries, B, 2, N] float planes."""
    return np_c2p(np.stack(entries))


def rfft_planes(x: jnp.ndarray) -> jnp.ndarray:
    """real ``[..., 2M]`` -> packed spectra planes ``[..., 2, M]``."""
    return c2p(rfft_packed(x))


def irfft_planes(p: jnp.ndarray) -> jnp.ndarray:
    """packed spectra planes ``[..., 2, M]`` -> real ``[..., 2M]``."""
    return irfft_packed(p2c(p))


def irfft_planes_valid(p: jnp.ndarray) -> jnp.ndarray:
    """Valid (lower) half of :func:`irfft_planes`: packed planes
    ``[..., 2, M]`` -> real ``[..., M]`` — the overlap-save step only
    keeps samples 0..M-1, so the upper half's interleave is skipped and
    the untangle runs as two constant complex multiplies
    (``V[k] = a[k] X[k] + b[k] conj(X[M-k])`` with
    ``a = (1 + i W)/2``, ``b = (1 - i W)/2``, ``W[k] = e^{i pi k / M}``)
    instead of the Xe/Xo form.

    ``BRUTEFIR_TPU_IRFFT=full`` takes XLA's full-size inverse and keeps
    the lower half instead (an A/B knob; same result to rounding)."""
    if os.environ.get("BRUTEFIR_TPU_IRFFT", "") == "full":
        return irfft_packed(p2c(p))[..., :p.shape[-1]]
    Xp = p2c(p)
    M = Xp.shape[-1]
    if M < 2:
        return irfft_packed(Xp)[..., :M]
    dc = Xp[..., :1].real
    nyq = Xp[..., :1].imag
    zero = jnp.zeros_like(dc)
    Xk = jnp.concatenate(
        [jax.lax.complex(dc, zero).astype(Xp.dtype), Xp[..., 1:]], axis=-1)
    Xr = jnp.concatenate(
        [jax.lax.complex(nyq, zero).astype(Xp.dtype),
         jnp.conj(jnp.flip(Xp[..., 1:], axis=-1))], axis=-1)
    k = jnp.arange(M)
    W = jnp.exp(1j * jnp.pi * k / M)
    a = ((1.0 + 1j * W) * 0.5).astype(Xp.dtype)
    b = ((1.0 - 1j * W) * 0.5).astype(Xp.dtype)
    z = jnp.fft.ifft(a * Xk + b * Xr, axis=-1)
    h = M // 2
    zv = z[..., :h]
    return jnp.stack([zv.real, zv.imag], axis=-1).reshape(
        *z.shape[:-1], M)


def preprocess_coeffs(
    taps: np.ndarray,
    block_length: int,
    n_blocks: int,
    scale: float = 1.0,
    dtype=np.float32,
) -> np.ndarray:
    """Host-side coefficient preprocessing.

    Splits ``taps`` (1-D) into ``n_blocks`` partitions of ``block_length``,
    zero-padding the tail, and returns the *packed* spectral coefficient
    bank ``H [n_blocks, block_length] complex`` in the engine's convention
    (upper-half placement absorbed as the (-1)^k factor; Nyquist packed
    into bin 0). ``scale`` is the linear attenuation factor applied to the
    taps (`coeffs2cbuf` arg). Raises ValueError on NaN/Inf taps.
    """
    N = block_length
    taps = np.asarray(taps, dtype=dtype) * dtype(scale) if scale != 1.0 else np.asarray(taps, dtype=dtype)
    if not np.all(np.isfinite(taps)):
        raise ValueError("NaN or Inf value among coefficients")
    total = N * n_blocks
    padded = np.zeros(total, dtype=dtype)
    padded[: min(len(taps), total)] = taps[:total]
    parts = padded.reshape(n_blocks, N)
    # taps at offset N in a 2N buffer == (-1)^k * rfft(taps at offset 0)
    buf = np.zeros((n_blocks, 2 * N), dtype=dtype)
    buf[:, N:] = parts
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    return pack_spectrum(np.fft.rfft(buf, axis=1).astype(ctype))


def dirac_bank_entry(block_length: int, n_blocks: int, dtype=np.complex64) -> np.ndarray:
    """Packed bank entry for the pass-through ("dirac pulse") coefficient."""
    N = block_length
    H = np.zeros((n_blocks, N + 1), dtype=dtype)
    signs = np.where(np.arange(N + 1) % 2 == 0, 1.0, -1.0)
    H[0] = signs
    return pack_spectrum(H)


def spectral_mac(ring: jnp.ndarray, H: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Partitioned spectral multiply-accumulate (dual-plane).

    ring: [F, B, 2, N] packed input-spectra ring per filter (re/im planes)
    H:    [F, B, 2, N] packed coefficient partitions (gathered/masked)
    t:    scalar int32 block counter
    Returns packed planes Y [F, 2, N] = sum_i ring[:, (t-i) % B] (*) H[:, i],
    where (*) is complex multiply except bin 0, whose real/imag parts (DC
    and Nyquist) multiply separately (the d1s/d2s special case of
    `fftw_convfuns.h:513-531`).
    """
    B = ring.shape[1]
    rpos = jnp.mod(t - jnp.arange(B, dtype=jnp.int32), B)
    rot = jnp.take(ring, rpos, axis=1)
    rr, ri = rot[:, :, 0], rot[:, :, 1]            # [F, B, N]
    hr, hi = H[:, :, 0], H[:, :, 1]
    yr = jnp.sum(rr * hr - ri * hi, axis=1)        # [F, N]
    yi = jnp.sum(rr * hi + ri * hr, axis=1)
    # bin 0: DC and Nyquist are independent real products
    yr0 = jnp.sum(rr[..., 0] * hr[..., 0], axis=-1)
    yi0 = jnp.sum(ri[..., 0] * hi[..., 0], axis=-1)
    yr = yr.at[..., 0].set(yr0)
    yi = yi.at[..., 0].set(yi0)
    return jnp.stack([yr, yi], axis=1)             # [F, 2, N]


def spectral_mac_rollh(ring: jnp.ndarray, bank: jnp.ndarray,
                       coeff_idx: jnp.ndarray, mask: jnp.ndarray,
                       t: jnp.ndarray) -> jnp.ndarray:
    """spectral_mac with the rotation moved onto the coefficient gather.

    Exact rewrite of ``Y = sum_b ring[:, (t-b)%B] (*) H[:, b]`` as
    ``Y = sum_j ring[:, j] (*) H[:, (t-j)%B]``: the bank-row gather and
    the ring rotation compose into ONE gather on the (small, reused)
    coefficient side, and the (large, per-block-changing) ring is read
    unrotated, so XLA can fuse the single gather into the reduction
    instead of materializing a rotated ring copy. Same terms as
    spectral_mac; the partition summation order differs by the rotation,
    so outputs match to float accumulation tolerance.

    ring: [F, B, 2, N]   bank: [E, B, 2, N]   coeff_idx: [F] i32
    mask: [F, B] partition validity (follows the *coefficient* partition
    index, i.e. it is gathered with the same rotation)   t: scalar i32
    Returns [F, 2, N] packed spectra.
    """
    B = ring.shape[1]
    hpos = jnp.mod(t - jnp.arange(B, dtype=jnp.int32), B)
    # mask stays in the promoted dtype so a bf16 ring/bank (the opt-in
    # reduced-precision knobs) still multiplies and accumulates in f32
    mg = mask[:, hpos].astype(jnp.promote_types(ring.dtype, jnp.float32))
    H = bank[coeff_idx[:, None], hpos[None, :]] * mg[:, :, None, None]
    return _mac_reduce(ring, H)


def spectral_mac_uniform(ring: jnp.ndarray, bank: jnp.ndarray,
                         coeff_idx: jnp.ndarray, mask: jnp.ndarray,
                         t: jnp.ndarray) -> jnp.ndarray:
    """spectral_mac_rollh when every filter uses the SAME coefficient row.

    The reference's massive/bench2 workloads drive every filter from one
    shared coeff (`bench2_config`: 26 filters, `coeff: 0`), and its MAC
    loop re-reads that coeff per filter out of the CPU cache. The device
    analog: gather ONE [B, 2, N] coefficient row and broadcast it across
    the filter axis, cutting the bank-side bytes from F*B*2*N to B*2*N.
    Only valid when coeff_idx and the mask rows are uniform; the host
    picks this program variant from its control snapshot, so no
    device-side conditional carries the ring through branch buffers.
    """
    B = ring.shape[1]
    hpos = jnp.mod(t - jnp.arange(B, dtype=jnp.int32), B)
    mrow = mask[0, hpos].astype(jnp.promote_types(ring.dtype, jnp.float32))
    H = bank[coeff_idx[0], hpos] * mrow[:, None, None]       # [B, 2, N]
    return _mac_reduce(ring, H[None])


def _mac_reduce(ring, H):
    """sum over partitions of ring (*) H; H broadcasts over filters."""
    rr, ri = ring[:, :, 0], ring[:, :, 1]          # [F, B, N]
    hr, hi = H[:, :, 0], H[:, :, 1]                # [F or 1, B, N]
    yr = jnp.sum(rr * hr - ri * hi, axis=1)        # [F, N]
    yi = jnp.sum(rr * hi + ri * hr, axis=1)
    # bin 0: DC and Nyquist are independent real products. A select
    # rather than a scatter: it partitions trivially when the bin axis
    # is sharded
    yr0 = jnp.sum(rr[..., 0] * hr[..., 0], axis=-1)
    yi0 = jnp.sum(ri[..., 0] * hi[..., 0], axis=-1)
    b0 = jnp.arange(ring.shape[-1]) == 0
    yr = jnp.where(b0, yr0[:, None], yr)
    yi = jnp.where(b0, yi0[:, None], yi)
    return jnp.stack([yr, yi], axis=1)             # [F, 2, N]


def crossfade_spectra(y_old: jnp.ndarray, y_new: jnp.ndarray, n_fft2: int) -> jnp.ndarray:
    """Seamless coefficient-change crossfade (`convolver_crossfade_inplace`).

    Inverse-transform both spectra, linearly ramp old->new across the valid
    (lower) half, keep the new upper half, and re-transform. Matches
    fftw_convolver.c:330-368 in our normalization.
    """
    t_old = irfft_planes(y_old)
    t_new = irfft_planes(y_new)
    dt = t_new.dtype
    f = jnp.arange(n_fft2, dtype=dt) / (n_fft2 - 1)
    ramped = t_old[..., :n_fft2] * (1.0 - f) + t_new[..., :n_fft2] * f
    mixed = jnp.concatenate([ramped, t_new[..., n_fft2:]], axis=-1)
    return rfft_planes(mixed)


def convolve_eval(z: jnp.ndarray, eval_prev: jnp.ndarray, n_fft2: int,
                  constrain=None):
    """Filter-cascade re-framing (`convolver_convolve_eval`, fftw 411-433).

    ``z`` is the packed mixed output spectrum of upstream filters [Fc, N].
    Returns
    (E, new_eval_prev): the "input-like" spectrum obtained by taking the
    valid time-domain output, overlap-save framing it with the previous
    block's valid output, and re-transforming.

    ``constrain`` (optional) pins intermediate shardings when the step runs
    over a device mesh: the cascade tensors are tiny ([Fc, ...]) and
    keeping them replicated both avoids pointless collectives and works
    around an XLA:CPU fft layout RET_CHECK that trips when the partitioner
    shards these transforms.
    """
    c = constrain if constrain is not None else (lambda a: a)
    valid = irfft_planes_valid(c(z))
    frame = c(jnp.concatenate([c(eval_prev), valid], axis=-1))
    return c(rfft_planes(frame)), valid


def complex_mix(mix: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Real mixing matrix applied to dual-plane spectra.

    [A, F] @ [F, 2, N] -> [A, 2, N]: one real matmul per plane. HIGHEST
    precision keeps the full float32 mantissa: on the GPU the default
    float32 matmul may run in TF32 (10 mantissa bits), far short of
    24-bit audio.
    """
    return jnp.einsum("af,fpn->apn", mix, x,
                      preferred_element_type=x.dtype,
                      precision=jax.lax.Precision.HIGHEST)
