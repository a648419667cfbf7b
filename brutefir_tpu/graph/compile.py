"""Compile a GraphSpec into a single jitted per-block device program.

The whole reference filter-process loop (`bfrun.c:1420-2083`) -- input FFTs,
input/filter/output mixing, the partitioned spectral MAC, crossfade and
cascade evaluation, output inverse FFTs -- becomes ONE traced function:

    step(state, ctrl, x) -> (state', y)

* ``state`` (donated): overlap-save tails, the [F, B, 2, N] spectra ring, the
  cascade tails, and the block counter -- all device-resident.
* ``ctrl``: block-boundary snapshot of every runtime control (mix matrices,
  coefficient indices/masks, pre-delays, crossfade flags). Changing controls
  never recompiles.
* ``bank``: the [n_entries, B, 2, N] packed dual-plane coefficient bank. Device-resident;
  hot-swapped by the EQ module via functional update outside the step.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import partconv
from .spec import GraphSpec


class StepState(NamedTuple):
    prev_in: jax.Array    # [C_in, N] previous input block (overlap-save tails)
    ring: jax.Array       # [F, B, 2, N] packed spectra ring (re/im planes)
    eval_prev: jax.Array  # [n_casc, N] cascade valid-output tails
    t: jax.Array          # scalar int32 block counter


class StepCtrl(NamedTuple):
    in_mix: jax.Array     # [F, C_in] input mix gains (incl. format scale)
    fmix: jax.Array       # [F, F] filter->filter mix gains
    out_mix: jax.Array    # [C_out, F] output mix gains (incl. 1/format scale)
    delay: jax.Array      # [F] int32 pre-delay in blocks (clamped 0..B-1)
    coeff_idx: jax.Array  # [F] int32 index into the bank (dirac = last entry)
    mask: jax.Array       # [F, B] partition validity (cblocks clamp)
    prev_idx: jax.Array   # [F] int32 previous coefficient (crossfade source)
    prev_mask: jax.Array  # [F, B]
    xfade: jax.Array      # [F] 1.0 where a crossfade happens this block
    any_xfade: jax.Array  # scalar bool
    ps_thresh: jax.Array  # [C_in] analog-powersave gate threshold (0 = off)


MAC_KINDS = ("jnp", "triton")


def resolve_mac(mac: str, real_dtype=np.float32) -> str:
    """``BRUTEFIR_TPU_MAC`` value -> MAC implementation.

    "triton" is the Pallas Triton kernel (ops/triton_mac.py): one pass
    over the ring and bank per block, where XLA's dense MAC reads both
    twice (once per output plane). It accumulates in float32 and compiles
    only where the backend has a Triton route. "jnp" is the dense gather
    + reduce that XLA fuses. "auto" takes the kernel wherever it compiles
    and the graph is float32, else the dense MAC."""
    from ..ops import triton_mac
    if mac not in ("auto",) + MAC_KINDS:
        from ..errors import BFError, BF_EXIT_INVALID_CONFIG
        raise BFError(f"BRUTEFIR_TPU_MAC={mac!r}: expected 'auto' or one "
                      f"of {', '.join(MAC_KINDS)}",
                      exit_code=BF_EXIT_INVALID_CONFIG)
    if mac == "jnp":
        return mac
    if np.dtype(real_dtype) == np.float32 and triton_mac.available():
        return "triton"
    if mac == "triton":
        from ..errors import BFError, BF_EXIT_INVALID_CONFIG
        raise BFError("BRUTEFIR_TPU_MAC=triton: the Triton MAC needs a "
                      "float32 graph on a backend with a Triton route",
                      exit_code=BF_EXIT_INVALID_CONFIG)
    return "jnp"


class CompiledGraph:
    """Owns the jitted step and state initialization for one GraphSpec.

    ``mac``: "auto", "jnp" (dense gather + reduce) or "triton" (see
    :func:`resolve_mac`).
    """

    def __init__(self, spec: GraphSpec, mac: str = "auto", taps=None):
        self.spec = spec
        self.taps = taps
        self.mac = resolve_mac(mac, spec.real_dtype)
        # Opt-in reduced-precision spectra ring (the input-history side
        # of the MAC's device-memory traffic; the bank side is
        # BRUTEFIR_TPU_BANK_DTYPE, runtime/engine.py): the persistent
        # [F, B, 2, N] ring is stored bfloat16 and upconverted on load,
        # halving ring-side bytes at ~0.2% signal quantization -- NOT
        # the bit-parity contract, so default stays the graph dtype.
        ring_env = os.environ.get("BRUTEFIR_TPU_RING_DTYPE", "")
        if ring_env in ("bf16", "bfloat16") and spec.real_dtype == np.float32:
            self.ring_dtype = jnp.bfloat16
        else:
            self.ring_dtype = spec.real_dtype
        # Host-selected program variants, compiled lazily per key:
        # ``uniform`` (all filters share one coeff/mask row) and
        # ``xfade`` (None = legacy dynamic lax.cond; True/False = the
        # host asserts whether this block crossfades -- see _step_impl).
        self._programs = {}
        self._step = self._program(False, None)    # eager: the base program
        self._step_u = self._program(True, None)

    def _program(self, uniform: bool, xfade):
        key = (uniform, xfade)
        if key not in self._programs:
            self._programs[key] = jax.jit(
                functools.partial(_step_impl, self.spec, self.mac,
                                  taps=self.taps, uniform=uniform,
                                  xfade_now=xfade),
                donate_argnums=(0,))
        return self._programs[key]

    def init_state(self) -> StepState:
        s = self.spec
        rd = s.real_dtype
        return StepState(
            prev_in=jnp.zeros((s.n_inputs, s.block_length), rd),
            ring=jnp.zeros(s.ring_shape(), self.ring_dtype),
            eval_prev=jnp.zeros((s.n_casc, s.block_length), rd),
            t=jnp.zeros((), jnp.int32),
        )

    def step(self, state: StepState, ctrl: StepCtrl, bank: jax.Array,
             x: jax.Array, uniform: bool = False, xfade=None):
        """One block: x [C_in, N] -> (state', y [C_out, N]).

        ``xfade``: host-selected crossfade variant (True/False when the
        caller knows whether ctrl carries a crossfade this block --
        Control.snapshot_xfade; None keeps the legacy in-graph cond)."""
        return self._program(uniform, xfade)(state, ctrl, bank, x)


def _step_impl(spec: GraphSpec, mac: str, state: StepState, ctrl: StepCtrl,
               bank: jax.Array, x: jax.Array, constrain=None, mesh=None,
               taps=None, uniform=False, pre_X=None,
               uniform_delay=False, xfade_now=None):
    """One block step. ``pre_X``: precomputed input spectra [C_in, 2, N]
    (planes) -- the offline batched path hoists decode+framing+rfft of a
    whole batch out of its scan (they depend only on the input stream,
    not the ring) and feeds each block's spectra here; ``x`` then only
    carries the block's time samples for the prev_in state.

    ``xfade_now``: host-selected crossfade program variant (like
    ``uniform``; the host knows at dispatch time whether any filter
    crossfades this block, Control.snapshot_xfade). ``None`` keeps the
    legacy dynamic program -- a ``lax.cond`` on ctrl.any_xfade inside
    the step, correct for any control stream. ``False`` compiles the
    plain program with no crossfade branch at all (the caller guarantees
    ctrl.xfade is all-zero). ``True`` compiles the always-crossfading
    program; on single-full-stage graphs this takes the fused
    time-domain crossfade path below. The host-selected split keeps the
    ring out of conditional branch operands on quiet blocks.

    ``uniform_delay``: host-selected program variant (like ``uniform``)
    for the case where every filter shares one pre-delay -- the spectra
    ring is then written with a single dynamic_update_slice at the
    scalar slot instead of a per-filter scatter. Only taken when a
    stage covers every filter in order, so the slice spans the whole
    filter axis; partial stages keep the scatter."""
    def tap(name, planes, idx):
        # opt-in frequency-domain module hooks (bfevents input_freqd /
        # pre_convolve / post_convolve / output_freqd, bfmod.h:192-215,
        # dispatched like bfrun.c:1533-1557,1688-1690,1839-1884): an
        # ordered host callback receives the spectra (mutable, like the
        # reference's in-place buffers) and its result flows back into the
        # graph. Only traced when a module registered the hook.
        if not taps or taps.get(name) is None:
            return planes
        from jax.experimental import io_callback
        fn = functools.partial(taps[name], idx=np.asarray(idx))
        return io_callback(
            fn, jax.ShapeDtypeStruct(planes.shape, planes.dtype),
            planes, ordered=True)
    def run_mac(ring_s, coeff_idx, msk, t):
        if mac == "triton" and mesh is None:
            from ..ops.triton_mac import triton_spectral_mac
            return triton_spectral_mac(ring_s, bank, coeff_idx, msk, t)
        # rotation composed into the coefficient gather (see
        # partconv.spectral_mac_rollh). The ``uniform`` program variant
        # (host-selected when every filter shares one coeff row + mask
        # row, like bench2/massive) gathers ONE coefficient row and
        # broadcasts it. Under a mesh the dense MAC is sharded by XLA's
        # partitioner like any other HLO.
        if uniform and mesh is None:
            return partconv.spectral_mac_uniform(ring_s, bank, coeff_idx,
                                                 msk, t)
        return partconv.spectral_mac_rollh(ring_s, bank, coeff_idx, msk, t)

    N = spec.block_length
    B = spec.n_blocks
    F = spec.n_filters
    rd = spec.real_dtype

    if mesh is not None:
        # Under a mesh the channel transforms run as shard_map-local
        # computations on replicated operands: every device computes its
        # own full copy (they are replicated anyway -- the MAC/ring is
        # where the sharding lives), the partitioner never rewrites the
        # fft, and the XLA:CPU test backend's fft layout RET_CHECK (which
        # otherwise trips at small channel counts, where the layout cost
        # model picks a transposed fft operand) cannot be hit.
        from jax.sharding import PartitionSpec as _P

        def rfft_fn(a):
            return jax.shard_map(partconv.rfft_planes, mesh=mesh,
                                 in_specs=_P(), out_specs=_P(),
                                 check_vma=False)(a)

        def irfft_fn(a):
            return jax.shard_map(partconv.irfft_planes_valid, mesh=mesh,
                                 in_specs=_P(), out_specs=_P(),
                                 check_vma=False)(a)
    else:
        rfft_fn = partconv.rfft_planes
        irfft_fn = partconv.irfft_planes_valid

    if pre_X is None:
        frame = jnp.concatenate([state.prev_in, x], axis=-1)
        if spec.powersave:
            # analog powersave gate (test_silent, bfrun.c:722-772): the
            # whole 2N overlap-save frame must be quiet; it is then made
            # truly zero for this transform (history in the double buffer
            # is untouched)
            peak = jnp.max(jnp.abs(frame), axis=1, keepdims=True)
            frame = jnp.where((ctrl.ps_thresh[:, None] > 0)
                              & (peak < ctrl.ps_thresh[:, None]),
                              jnp.zeros_like(frame), frame)
        X = rfft_fn(frame)                                # [C_in, 2, N]
    else:
        X = pre_X
    X = tap("input_freqd", X, np.arange(spec.n_inputs))
    ring = state.ring
    eval_prev = state.eval_prev
    t = state.t

    def write_ring(ring, blk, idx):
        """Write a stage's frequency block into the persistent ring at
        each filter's delayed slot (delayblocks, the cbuf curblock+delay
        of bfrun.c:1688-1690): one dynamic_update_slice when the stage
        covers every filter and all delays equal delay[0] (the host-
        detected uniform_delay program variant), else a per-filter
        scatter. Shared by the fused crossfade path and the stage loop."""
        blk = blk.astype(ring.dtype)   # bf16 ring opt-in casts on write
        if (uniform_delay and idx.size == F
                and np.array_equal(idx, np.arange(F))):
            # one index dtype for every start index, also when float_bits:
            # 64 has switched Python ints to int64
            wpos0 = jnp.mod(t + ctrl.delay[0], B).astype(jnp.int32)
            zero = jnp.zeros((), jnp.int32)
            return jax.lax.dynamic_update_slice(
                ring, blk[:, None], (zero, wpos0) + (zero,) * (blk.ndim - 1))
        wpos = jnp.mod(t + ctrl.delay[idx], B)
        return ring.at[idx, wpos].set(blk)

    # Gather-scale channel mixes (the reference's unrolled n_bufs=1
    # mixnscale special case, fftw_convfuns.h:7-501): when the static
    # graph says every filter draws from at most one input channel
    # (spec.in_src) / every output mixes at most one filter
    # (spec.out_src), the [F, C] / [C, F] mix matmuls collapse to a
    # static gather + per-row scale -- numerically identical (the matmul
    # rows have a single nonzero). Opt-in (BRUTEFIR_TPU_SPARSE_MIX=
    # 1|in|out); default is the matmul. Mesh paths always keep the
    # matmul: its contraction is where the partitioner inserts the psum
    # over 'f'.
    _sm = os.environ.get("BRUTEFIR_TPU_SPARSE_MIX", "0")
    sparse_in = mesh is None and _sm in ("1", "in")
    sparse_out = mesh is None and _sm in ("1", "out")

    def in_mix_stage(idx, X):
        if sparse_in and spec.in_src is not None:
            src = np.asarray(spec.in_src, np.int32)[np.asarray(idx)]
            g = ctrl.in_mix[np.asarray(idx), src]
            return X[src] * g[:, None, None]
        return partconv.complex_mix(ctrl.in_mix[idx], X)

    def out_mix_apply(y_all):
        if sparse_out and spec.out_src is not None:
            srcf = np.asarray(spec.out_src, np.int32)
            g = ctrl.out_mix[np.arange(srcf.size), srcf]
            return y_all[srcf] * g[:, None, None]
        return partconv.complex_mix(ctrl.out_mix, y_all)

    # Fused time-domain crossfade: crossfade_spectra pays two
    # full-size inverse transforms plus a full-size forward re-transform
    # across all F filter rows, only for the result to be output-mixed
    # and inverse-transformed again. The output mix is linear and acts
    # per spectral bin, so it commutes with the transforms:
    #   irfft_valid(mix(rfft([ramped, tail]))) == mix_time(ramped)
    # For a single full stage with no cascades or spectral taps (the
    # crossfaded spectra feed nothing but the output mix), the whole
    # crossfade collapses to: two MAC passes -> THREE mixed spectra
    # (old*sel, new*sel, new*(1-sel), batched into two matmuls) -> ONE
    # batched valid-half inverse transform -> the linear ramp applied in
    # the time domain. Per crossfade block this removes ~3 full-size
    # F-row transforms. Matches convolver_crossfade_inplace
    # (fftw_convolver.c:330-368) up to the removed transform round-trip's
    # rounding. Only compiled
    # into the host-selected xfade_now=True program -- no lax.cond.
    fused_xf = (xfade_now is True and not taps and len(spec.stages) == 1
                and spec.stages[0].casc_local.size == 0
                and spec.stages[0].any_crossfade
                and np.array_equal(spec.stages[0].idx, np.arange(F))
                and os.environ.get("BRUTEFIR_TPU_TD_XFADE", "1") != "0")
    if fused_xf:
        idx = spec.stages[0].idx
        mixed = in_mix_stage(idx, X)
        mixed = tap("pre_convolve", mixed, idx)  # taps is empty; keep parity
        ring = write_ring(ring, mixed, idx)
        cst = constrain if constrain is not None else (lambda a: a)
        C_out = ctrl.out_mix.shape[0]
        y_new = run_mac(ring, ctrl.coeff_idx, ctrl.mask, t)
        y_old = run_mac(ring, ctrl.prev_idx, ctrl.prev_mask, t)

        # three mixed spectra in two matmuls, one batched valid-half
        # inverse transform, ramp in time: sel-scaled columns express
        # the per-filter crossfade selection through the linear mix
        sel = (ctrl.xfade > 0).astype(y_new.dtype)           # [F]
        w_sel = ctrl.out_mix * sel[None, :]
        w_rest = ctrl.out_mix - w_sel
        o_old = partconv.complex_mix(w_sel, y_old)           # [C, 2, N]
        o_new = partconv.complex_mix(
            jnp.concatenate([w_sel, w_rest], axis=0), y_new)
        tv = irfft_fn(cst(jnp.concatenate([o_old, o_new], axis=0)))
        a, b, c = tv[:C_out], tv[C_out:2 * C_out], tv[2 * C_out:]
        r = jnp.arange(N, dtype=rd) / (N - 1)        # crossfade_spectra ramp
        y_time = a * (1.0 - r) + b * r + c
        return StepState(prev_in=x, ring=ring, eval_prev=eval_prev,
                         t=t + 1), y_time

    # Per-stage filter-output spectra, concatenated once at the end instead
    # of scattered into a preallocated array (fewer copies, friendlier
    # layouts under sharding). stage_idx/stage_ys run in stage order; the
    # final permutation restores global filter order.
    stage_ys = []
    done_idx = []

    for stage in spec.stages:
        idx = stage.idx                                    # static np array
        mixed = in_mix_stage(idx, X)                       # [Fs, 2, N]

        if stage.casc_local.size:
            # upstream spectra from already-computed stages: contract each
            # prior stage's block against its static column slice of fmix
            cidx = idx[stage.casc_local]
            z = None
            for pidx, py in zip(done_idx, stage_ys):
                zc = partconv.complex_mix(ctrl.fmix[cidx][:, pidx], py)
                z = zc if z is None else z + zc
            e, tails = partconv.convolve_eval(z, eval_prev[stage.casc_slots], N,
                                              constrain)
            eval_prev = eval_prev.at[stage.casc_slots].set(tails)
            mixed = mixed.at[stage.casc_local].add(e)

        # pre_convolve taps the block being written into the ring, so a
        # mutation persists in the spectra history like the reference's
        # in-place cbuf[n][curblock] (bfrun.c:1688-1690)
        mixed = tap("pre_convolve", mixed, idx)
        ring = write_ring(ring, mixed, idx)

        # when the stage covers every filter in order, skip the gather copy
        full = idx.size == F and np.array_equal(idx, np.arange(F))
        ring_s = ring if full else ring[idx]
        y = run_mac(ring_s, ctrl.coeff_idx[idx], ctrl.mask[idx], t)

        # xfade_now=False (host-selected no-crossfade program) drops the
        # whole branch: the caller guarantees ctrl.xfade is all-zero.
        if stage.any_crossfade and xfade_now is not False:
            def do_xfade(y, _idx=idx, _ring_s=ring_s):
                y_old = run_mac(_ring_s, ctrl.prev_idx[_idx],
                                ctrl.prev_mask[_idx], t)
                y_xf = partconv.crossfade_spectra(y_old, y, N)
                sel = ctrl.xfade[_idx][:, None, None] > 0
                return jnp.where(sel, y_xf, y)

            y = jax.lax.cond(ctrl.any_xfade, do_xfade, lambda v: v, y)

        # the rebuild passes the convolution *result* (PARITY: the
        # reference hands the filter's current ring block, which only
        # holds the result in the single-partition in-place path)
        y = tap("post_convolve", y, idx)
        stage_ys.append(y)
        done_idx.append(idx)

    if len(stage_ys) == 1:
        y_all = stage_ys[0]
        order = done_idx[0]
    else:
        y_all = jnp.concatenate(stage_ys, axis=0)
        order = np.concatenate(done_idx)
    inv = np.argsort(order)
    if not np.array_equal(order, np.arange(F)):
        y_all = y_all[inv]

    out_spec = out_mix_apply(y_all)                        # [C_out, 2, N]
    out_spec = tap("output_freqd", out_spec, np.arange(spec.n_outputs))
    if constrain is not None:
        # pin the mixed output spectra replicated before the inverse
        # transform: the all-gather lands here (once, [C_out, 2, N])
        out_spec = constrain(out_spec)
    y_time = irfft_fn(out_spec)                            # valid lower half

    new_state = StepState(prev_in=x, ring=ring, eval_prev=eval_prev, t=t + 1)
    return new_state, y_time


def make_ctrl(
    spec: GraphSpec,
    in_mix: np.ndarray,
    fmix: np.ndarray,
    out_mix: np.ndarray,
    delay: np.ndarray,
    coeff_idx: np.ndarray,
    mask: np.ndarray,
    prev_idx=None,
    prev_mask=None,
    xfade=None,
    ps_thresh=None,
) -> StepCtrl:
    """Assemble a StepCtrl from host arrays (defaults: no crossfade)."""
    rd = spec.real_dtype
    F, B = spec.n_filters, spec.n_blocks
    if prev_idx is None:
        prev_idx = coeff_idx
    if prev_mask is None:
        prev_mask = mask
    if xfade is None:
        xfade = np.zeros(F, rd)
    if ps_thresh is None:
        ps_thresh = np.zeros(spec.n_inputs, rd)
    any_xfade = bool(np.any(np.asarray(xfade) > 0))
    return StepCtrl(
        in_mix=jnp.asarray(in_mix, rd),
        fmix=jnp.asarray(fmix, rd),
        out_mix=jnp.asarray(out_mix, rd),
        delay=jnp.asarray(delay, jnp.int32),
        coeff_idx=jnp.asarray(coeff_idx, jnp.int32),
        mask=jnp.asarray(mask, rd),
        prev_idx=jnp.asarray(prev_idx, jnp.int32),
        prev_mask=jnp.asarray(prev_mask, rd),
        xfade=jnp.asarray(xfade, rd),
        any_xfade=jnp.asarray(any_xfade),
        ps_thresh=jnp.asarray(ps_thresh, rd),
    )
