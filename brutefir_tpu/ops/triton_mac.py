"""Partitioned spectral MAC as one Pallas kernel on the Triton route.

The challenger to the dense ``partconv.spectral_mac_rollh``: the same sum
``Y[f] = sum_j ring[f, j] (*) bank[idx[f], (t-j) % B] * mask[f, (t-j) % B]``
over the flat ``[F, B, 2, K]`` layout, with the packed bin 0 (DC and Nyquist
multiply separately). The grid is (filters, bin blocks). Each block loads
its own coefficient index, walks the B partitions in a loop, and keeps the
real and imaginary sums in registers, so every ring and bank byte is read
once and the gathered coefficients never reach device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_BLOCK = 1024


@functools.lru_cache(maxsize=None)
def available() -> bool:
    """Whether the default backend compiles the kernel: a capability test
    (a tiny instance is lowered and compiled once per process) rather
    than a platform name. Backends without a Triton route refuse it."""
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((1, 1, 2, 16), f32),
            jax.ShapeDtypeStruct((1, 1, 2, 16), f32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
            jax.ShapeDtypeStruct((1, 1), f32),
            jax.ShapeDtypeStruct((), jnp.int32))
    try:
        triton_spectral_mac.lower(*args).compile()
    except Exception:
        return False
    return True


def bin_block(K: int) -> int:
    """Largest power-of-two bin block dividing K, capped at MAX_BLOCK."""
    bk = 1
    while bk < MAX_BLOCK and K % (2 * bk) == 0:
        bk *= 2
    return bk


def _mac_kernel(t_ref, idx_ref, mask_ref, ring_ref, bank_ref, out_ref,
                *, n_blocks, bk):
    f = pl.program_id(0)
    k0 = pl.multiple_of(pl.program_id(1) * bk, bk)
    ks = pl.ds(k0, bk)
    e = idx_ref[f]
    t = t_ref[0] % n_blocks
    lane0 = (k0 + jnp.arange(bk)) == 0
    f32 = jnp.float32

    def body(j, acc):
        yr, yi = acc
        h = t - j
        h = jnp.where(h < 0, h + n_blocks, h)
        m = mask_ref[f, h].astype(f32)
        rr = ring_ref[f, j, 0, ks].astype(f32)
        ri = ring_ref[f, j, 1, ks].astype(f32)
        hr = bank_ref[e, h, 0, ks].astype(f32) * m
        hi = bank_ref[e, h, 1, ks].astype(f32) * m
        rihi = ri * hi
        # bin 0 packs two real spectra: DC in re, Nyquist in im
        yr = yr + rr * hr - jnp.where(lane0, 0.0, rihi)
        yi = yi + jnp.where(lane0, rihi, rr * hi + ri * hr)
        return yr, yi

    zero = jnp.zeros((bk,), f32)
    yr, yi = jax.lax.fori_loop(0, n_blocks, body, (zero, zero))
    out_ref[f, 0, ks] = yr.astype(out_ref.dtype)
    out_ref[f, 1, ks] = yi.astype(out_ref.dtype)


@functools.partial(jax.jit, static_argnames=("interpret",))
def triton_spectral_mac(ring, bank, coeff_idx, mask, t, interpret=False):
    """ring [F, B, 2, K], bank [E, B, 2, K], coeff_idx [F] i32, mask [F, B],
    t scalar i32 -> packed spectra [F, 2, K] (float32 accumulation).
    ``interpret`` runs the kernel in the Pallas interpreter (tests only)."""
    F, B, _, K = ring.shape
    bk = bin_block(K)
    out_dtype = jnp.promote_types(ring.dtype, jnp.float32)
    kernel = functools.partial(_mac_kernel, n_blocks=B, bk=bk)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((F, 2, K), out_dtype),
        grid=(F, K // bk),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="spectral_mac",
    )(jnp.reshape(t, (1,)).astype(jnp.int32), coeff_idx.astype(jnp.int32),
      mask, ring, bank)
