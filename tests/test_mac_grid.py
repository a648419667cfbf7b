"""The partitioned spectral MAC -- the dense jnp MAC and the Pallas Triton
kernel (in the Pallas interpreter) -- against the float64 numpy oracle of
chip_smoke.py, and the block step built on either against time-domain
oracles: uniform and distinct coefficients, partition masks, reduced-
precision banks and rings, pre-delay, live crossfades and edge shapes.

MAC tolerance: the float32 bound ``(2B + 1) * 2^-24 * sum|terms|`` per
element, which holds for any summation order (module docstring of
chip_smoke.py).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal

from chip_smoke import mac_oracle
from brutefir_tpu.graph import build_graph_spec, CompiledGraph, make_ctrl
from brutefir_tpu.ops import partconv
from brutefir_tpu.ops.triton_mac import bin_block, triton_spectral_mac

KERNELS = {
    "dense": partconv.spectral_mac_rollh,
    "triton": functools.partial(triton_spectral_mac, interpret=True),
}

# (F, E, B, K, uniform)
CASES = [
    (3, 2, 4, 256, False),
    (4, 3, 6, 256, True),
    (5, 3, 8, 384, False),
    (1, 2, 1, 256, False),     # single partition (bench3-style)
    (2, 2, 1, 512, False),
    (1, 2, 3, 256, False),     # single filter
    (5, 2, 2, 384, True),
    (2, 4, 16, 1024, False),   # the flagship's partition count
]


def _operands(rng, F, E, B, K, uniform, dtype=np.float32):
    ring = rng.standard_normal((F, B, 2, K)).astype(dtype)
    bank = rng.standard_normal((E, B, 2, K)).astype(dtype)
    if uniform:
        idx = np.full(F, E - 1, np.int32)
        mask = np.tile((rng.uniform(size=B) > 0.3).astype(np.float32),
                       (F, 1))
    else:
        idx = (np.arange(F) % E).astype(np.int32)
        mask = (rng.uniform(size=(F, B)) > 0.3).astype(np.float32)
    return ring, bank, idx, mask


def _check(got, ref, bound):
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= bound + 1e-30)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("F,E,B,K,uniform", CASES)
def test_mac_matches_oracle(rng, kernel, F, E, B, K, uniform):
    ring, bank, idx, mask = _operands(rng, F, E, B, K, uniform)
    for t in (0, B // 2 + 1, 3 * B + 2):
        ref, bound = mac_oracle(ring, bank, idx, mask, t)
        got = KERNELS[kernel](jnp.asarray(ring), jnp.asarray(bank),
                              jnp.asarray(idx), jnp.asarray(mask),
                              jnp.int32(t))
        _check(got, ref, bound)


@pytest.mark.parametrize("F,E,B,K", [(4, 3, 6, 256), (3, 1, 2, 512)])
def test_uniform_mac_matches_oracle(rng, F, E, B, K):
    """The host-selected uniform program gathers one coefficient row."""
    ring, bank, idx, mask = _operands(rng, F, E, B, K, True)
    for t in (0, 5):
        ref, bound = mac_oracle(ring, bank, idx, mask, t)
        got = partconv.spectral_mac_uniform(
            jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
            jnp.asarray(mask), jnp.int32(t))
        _check(got, ref, bound)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("side", ["bank", "ring"])
def test_bf16_operand_matches_oracle(rng, kernel, side):
    """BRUTEFIR_TPU_BANK_DTYPE / RING_DTYPE=bf16: the MAC upconverts on
    load and accumulates in float32, so it meets the oracle of the
    quantized values."""
    ring, bank, idx, mask = _operands(rng, 3, 2, 4, 256, False)
    q = {"ring": ring, "bank": bank}
    q16 = jnp.asarray(q[side], jnp.bfloat16)
    q[side] = np.asarray(q16.astype(jnp.float32))
    ref, bound = mac_oracle(q["ring"], q["bank"], idx, mask, 3)
    args = {"ring": jnp.asarray(ring), "bank": jnp.asarray(bank)}
    args[side] = q16
    got = KERNELS[kernel](args["ring"], args["bank"], jnp.asarray(idx),
                          jnp.asarray(mask), jnp.int32(3))
    assert got.dtype == jnp.float32
    _check(got, ref, bound)


@pytest.mark.parametrize("K,want", [(8192, 1024), (384, 128), (256, 256),
                                    (2, 2)])
def test_bin_block(K, want):
    """Power-of-two bin blocks that divide K, at most 1024 bins."""
    assert bin_block(K) == want


# ------------------------------------------------------------ block step

def _conv(x, h):
    return scipy.signal.fftconvolve(x, h)[: len(x)]


def _delay(x, n):
    return np.concatenate([np.zeros(n), x[: len(x) - n]])


def _run_steps(spec, mac, ctrls, bank, xs, xfade=None, taps_fixture=None):
    cg = CompiledGraph(spec, mac=mac)
    st = cg.init_state()
    ys = []
    for ct, xb in zip(ctrls, xs):
        xf = (bool(np.any(np.asarray(ct.xfade) > 0))
              if xfade == "host" else None)
        st, y = cg.step(st, ct, jnp.asarray(bank), jnp.asarray(xb),
                        xfade=xf)
        ys.append(np.asarray(y, np.float64))
    return np.concatenate(ys, axis=1)


@pytest.mark.parametrize("mac", ["jnp", "triton"])
def test_step_predelay_matches_oracle(rng, request, mac):
    """Filter pre-delay (delayblocks) writes a delayed ring slot; the
    partitions that would reach past the ring are clamped, so filter f
    applies its first B - delay[f] partitions to the delayed input
    (bfrun.c:1585-1591)."""
    if mac == "triton":
        request.getfixturevalue("triton_interpret")
    N, B, C, n_blk = 256, 4, 3, 7
    taps = rng.standard_normal(N * B) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = partconv.make_bank([partconv.preprocess_coeffs(taps, N, B)])
    delay = np.array([0, 1, 3], np.int32)
    mask = np.ones((C, B), np.float32)
    for f, d in enumerate(delay):
        mask[f, B - d:] = 0.0
    ctrl = make_ctrl(spec, np.eye(C, dtype=np.float32),
                     np.zeros((C, C), np.float32),
                     np.eye(C, dtype=np.float32), delay,
                     np.zeros(C, np.int32), mask)
    x = rng.standard_normal((C, N * n_blk))
    xs = np.split(x.astype(np.float32), n_blk, axis=1)
    y = _run_steps(spec, mac, [ctrl] * n_blk, bank, xs)
    for f, d in enumerate(delay):
        ref = _conv(_delay(x[f], d * N), taps[: N * (B - d)])
        np.testing.assert_allclose(y[f], ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("mac", ["jnp", "triton"])
@pytest.mark.parametrize("xfade", ["cond", "host"])
def test_step_crossfade_matches_oracle(rng, request, mac, xfade):
    """A coefficient swap with crossfade ramps old -> new across one block
    (convolver_crossfade_inplace, fftw_convolver.c:330-368), through the
    in-graph conditional or the host-selected crossfade program."""
    if mac == "triton":
        request.getfixturevalue("triton_interpret")
    N, B, C, n_blk, swap = 256, 3, 2, 6, 3
    ha = rng.standard_normal(N * B) * 0.1
    hb = rng.standard_normal(N * B) * 0.1
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [True] * C)
    bank = partconv.make_bank([partconv.preprocess_coeffs(h, N, B)
                               for h in (ha, hb)])

    def ctrl(idx, prev, xf):
        return make_ctrl(
            spec, np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32),
            np.eye(C, dtype=np.float32), np.zeros(C, np.int32),
            np.full(C, idx, np.int32), np.ones((C, B), np.float32),
            prev_idx=np.full(C, prev, np.int32),
            xfade=np.full(C, xf, np.float32))

    ctrls = ([ctrl(0, 0, 0.0)] * swap + [ctrl(1, 0, 1.0)]
             + [ctrl(1, 1, 0.0)] * (n_blk - swap - 1))
    x = rng.standard_normal((C, N * n_blk))
    xs = np.split(x.astype(np.float32), n_blk, axis=1)
    y = _run_steps(spec, mac, ctrls, bank, xs, xfade=xfade)
    ramp = np.arange(N) / (N - 1)
    for c in range(C):
        ya, yb = _conv(x[c], ha), _conv(x[c], hb)
        ref = np.where(np.arange(N * n_blk) < swap * N, ya, yb)
        seg = slice(swap * N, (swap + 1) * N)
        ref[seg] = ya[seg] * (1 - ramp) + yb[seg] * ramp
        np.testing.assert_allclose(y[c], ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("uniform", [False, True])
def test_step_triton_matches_dense(rng, triton_interpret, uniform):
    """The whole block step (mixes, MAC, inverse transform) with the
    Triton kernel equals the dense step to float32 rounding, in both
    host-selected coefficient programs."""
    N, B, C = 256, 4, 4
    hs = [rng.standard_normal(N * B) * 0.1 for _ in range(2)]
    spec = build_graph_spec(N, B, C, C, [[] for _ in range(C)], [False] * C)
    bank = partconv.make_bank([partconv.preprocess_coeffs(h, N, B)
                               for h in hs])
    idx = np.zeros(C, np.int32) if uniform else np.arange(C) % 2
    ctrl = make_ctrl(spec, rng.standard_normal((C, C)).astype(np.float32),
                     np.zeros((C, C), np.float32),
                     rng.standard_normal((C, C)).astype(np.float32),
                     np.zeros(C, np.int32), idx.astype(np.int32),
                     np.ones((C, B), np.float32))
    xs = np.split(rng.standard_normal((C, N * 5)).astype(np.float32), 5,
                  axis=1)
    outs = {}
    for mac in ("jnp", "triton"):
        cg = CompiledGraph(spec, mac=mac)
        st = cg.init_state()
        ys = []
        for xb in xs:
            st, y = cg.step(st, ctrl, jnp.asarray(bank), jnp.asarray(xb),
                            uniform=uniform)
            ys.append(np.asarray(y))
        outs[mac] = np.concatenate(ys, axis=1)
    np.testing.assert_allclose(outs["triton"], outs["jnp"], rtol=0,
                               atol=2e-5 * np.abs(outs["jnp"]).max())


@pytest.mark.gpu
def test_triton_kernel_compiles_on_gpu(gpu, rng):
    """On a card the kernel compiles natively (no interpreter) and meets
    the oracle at a real width; chip_smoke.py's MAC phase runs this."""
    ring, bank, idx, mask = _operands(rng, 26, 1, 16, 8192, True)
    ref, bound = mac_oracle(ring, bank, idx, mask, 5)
    got = triton_spectral_mac(jnp.asarray(ring), jnp.asarray(bank),
                              jnp.asarray(idx), jnp.asarray(mask),
                              jnp.int32(5))
    _check(got, ref, bound)
