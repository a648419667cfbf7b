"""Device-side I/O path: the whole block program including sample codecs.

When every device format is word-addressable (see ``eligible`` below), the
engine swaps its host codec for this wrapper: one jitted function takes the
raw input words of every input device and returns the raw output words of
every output device plus per-channel meters. Dither (ops/device_dither.py),
integer delay lines (device-resident window gather) and subsample delays
all run inside the same program; only exotic formats force the host codec.
Host work per block collapses to file reads/writes and transfers shrink to
wire format width.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..config.model import BFConfig, IN, OUT
from ..graph.compile import _step_impl
from ..ops.device_codec import (device_format_word, decode_words,
                                encode_words, scatter_words)
from ..ops.device_dither import dither_window, dither_quantize


def _wire3(fmt) -> bool:
    """3-byte packed S24: the file bytes are the wire format verbatim
    (sign-extended on device) -- bit-exact, so always device-eligible."""
    return (not fmt.is_float and fmt.bytes == 3 and fmt.sbytes == 3
            and fmt.little_endian and np.little_endian)


def _agg_meters(meters):
    """Collapse a scan's per-block meter stacks [m, ch, 3] into one
    block-shaped meter per device: clip counts sum, peaks max."""
    return tuple(
        jnp.concatenate([
            jnp.sum(md[:, :, :1], axis=0),
            jnp.max(md[:, :, 1:], axis=0),
        ], axis=1)
        for md in meters)


def eligible(conf: BFConfig) -> bool:
    for io in (IN, OUT):
        for dev in conf.iodevs[io]:
            if (device_format_word(dev.sample_format) is None
                    and not _wire3(dev.sample_format)):
                return False
    return True


class DeviceIO:
    def __init__(self, engine):
        conf = engine.conf
        self.conf = conf
        self.N = engine.N
        self.rd = engine.rd
        spec = engine.spec
        self.mesh = getattr(engine, "mesh", None)
        if self.mesh is not None:
            # sharded engine: the step inside this program uses the MAC
            # the ShardedGraph resolved, and the jit below pins the same
            # state/bank shardings -- decode/encode/meters stay
            # replicated (tiny next to the MAC)
            mac = engine._sharded.mac
        else:
            mac = engine.cg.mac

        self.in_words = [device_format_word(d.sample_format)
                         for d in conf.iodevs[IN]]
        self.out_words = [device_format_word(d.sample_format)
                          for d in conf.iodevs[OUT]]

        # Wire compaction: S24-in-4-byte inputs ship only the 3
        # significant bytes and are sign-extended on device -- 25% less
        # host->device traffic for the block's audio payload. Exact for
        # in-range data; inputs whose
        # padding byte is not the sign extension (out-of-spec S24) decode
        # differently from the reference's raw int32 read
        # (raw2real.h:143-153) -- see docs/PARITY.md. Kill switch:
        # BRUTEFIR_TPU_WIRE_PACK24=0.
        pack24 = os.environ.get("BRUTEFIR_TPU_WIRE_PACK24", "1") != "0"

        def _p24(fmt):
            return (pack24 and not fmt.is_float and fmt.bytes == 4
                    and fmt.sbytes == 3 and fmt.little_endian
                    and np.little_endian)

        self.in_wire = []       # per input device: "word" | "p24" | "raw3"
        self.in_wire_dtype = []
        self.in_wire_shape = []  # per-frame trailing shape
        for di, dev in enumerate(conf.iodevs[IN]):
            fmt = dev.sample_format
            if _wire3(fmt) or _p24(fmt):
                self.in_wire.append("raw3" if _wire3(fmt) else "p24")
                self.in_words[di] = np.dtype(np.int32)  # decoded word type
                self.in_wire_dtype.append(np.dtype(np.uint8))
                self.in_wire_shape.append((dev.open_channels, 3))
            else:
                self.in_wire.append("word")
                self.in_wire_dtype.append(self.in_words[di])
                self.in_wire_shape.append((dev.open_channels,))
        # symmetric packing on the way out (device->host)
        self.out_wire = []
        for di, dev in enumerate(conf.iodevs[OUT]):
            fmt = dev.sample_format
            if _wire3(fmt):
                self.out_wire.append("raw3")
                self.out_words[di] = np.dtype(np.int32)  # encode word type
            elif _p24(fmt):
                self.out_wire.append("p24")
            else:
                self.out_wire.append("word")

        # static per-device decode/encode wiring
        in_devs = []
        for dev in conf.iodevs[IN]:
            sel = np.asarray(dev.channel_selection, np.int32)
            vmap = np.asarray(dev.virt2phys_local, np.int32)
            in_devs.append((sel, vmap))
        out_devs = []
        for dev in conf.iodevs[OUT]:
            sel = np.asarray(dev.channel_selection, np.int32)
            # virtual rows summing into each used physical row
            rows = []
            for i in range(dev.used_channels):
                phys = dev.phys_base + i
                rows.append(np.asarray(conf.phys2virt[OUT][phys], np.int64))
            if (all(len(v) == 1 for v in rows)
                    and os.environ.get("BRUTEFIR_TPU_PERM_OMIX",
                                       "1") != "0"):
                # every physical row is exactly one virtual channel (no
                # fan-in): a row gather replaces the [used, C] x [C, N]
                # matmul -- bit-identical (a one-hot HIGHEST matmul row
                # reduces to the single element) and one pass less over
                # device memory at scale shapes (256x256 x 256x8192)
                mix = ("perm", np.asarray([v[0] for v in rows], np.int32))
            else:
                mix = np.zeros((dev.used_channels, conf.n_channels[OUT]),
                               engine.rd)
                for i, virts in enumerate(rows):
                    mix[i, virts] = 1.0
            out_devs.append((sel, mix, dev.open_channels,
                             dev.sample_format))
        self._out_devs_dbg = out_devs     # introspection (tests)

        # --- device-resident integer delay lines ---
        # per-virtual-channel windows of the last W pre-delay samples;
        # out[n] = window[W + n - delay]. Runtime changes keep the
        # reference semantics (delay.c:283-317) via update_delays():
        # a decrease skips the oldest samples (the gather does this
        # naturally), an increase splices zeros into the window.
        self._dly = [None, None]
        for io in (IN, OUT):
            caps = []
            for ch in range(conf.n_channels[io]):
                md = conf.maxdelay[io][ch]
                d0 = conf.delay[io][ch]
                # capacity: maxdelay when runtime-changeable, else the
                # fixed initial delay; `cur = min(delay, caps)` below is
                # the init clamp (delay.c:351-362)
                caps.append(md if md >= 0 else d0)
            W = max(caps) if caps else 0
            if W > 0:
                cur = [min(conf.delay[io][ch], caps[ch])
                       for ch in range(conf.n_channels[io])]
                self._dly[io] = {
                    "W": W,
                    "cur": cur,
                    "max": list(conf.maxdelay[io]),
                    "arr": jnp.asarray(np.asarray(cur, np.int32)),
                }

        # --- device-resident subsample delay ---
        # overlap-save filtering with the host bank (runtime/subdelay.py):
        # within one block the chunk "rest" is just the previous chunk,
        # so all N/B_sd chunks batch into one rfft. On a subdelay-active
        # side, initially-undefined channels run the sd=0 (centered
        # dirac) row -- the same +sdf_length latency as the host's
        # compensating integer delay (bfrun.c:1512-1516); runtime
        # out-of-range values bypass entirely, like
        # delay_subsample_update (delay.c:424).
        self._sd = [None, None]
        if engine.subdelay is not None:
            from ..config.model import BF_UNDEFINED_SUBDELAY
            sdh = engine.subdelay
            for io in (IN, OUT):
                if not conf.use_subdelay[io]:
                    continue
                C = conf.n_channels[io]
                defined = np.asarray(
                    [conf.subdelay[io][ch] != BF_UNDEFINED_SUBDELAY
                     for ch in range(C)])
                cur = [conf.subdelay[io][ch] if defined[ch] else 0
                       for ch in range(C)]
                d = {
                    "B": sdh.blocklen,
                    "steps": sdh.steps,
                    "H": jnp.asarray(sdh.H),      # [2s-1, B+1] complex
                    "defined": defined,
                    "cur": cur,
                }
                self._sd[io] = d
                self._sd_refresh(io)

        # --- device-resident dither (ops/device_dither.py) ---
        # same channel rule and table indexing as the host path
        # (engine.py dither_init analog): int formats with sbytes < 4 on
        # apply_dither devices, one shared Tausworthe table, channel j's
        # pointer starting at j * spacing + 1 in sorted-phys order.
        dith_phys = []
        self._dev_dither = []            # per out device: bool
        for dev in conf.iodevs[OUT]:
            fmt = dev.sample_format
            dithers = bool(dev.apply_dither and not fmt.is_float
                           and fmt.sbytes < 4)
            self._dev_dither.append(dithers)
            if dithers:
                for i in range(dev.used_channels):
                    dith_phys.append(dev.phys_base + i)
        self._dith_rows = []             # per out device: [used] -> D idx
        self.dstate = {}
        self._staged = self._staged_src = None   # see _stage_ctrl
        self._dith_tab = None
        if dith_phys:
            order = {p: j for j, p in enumerate(sorted(dith_phys))}
            # the engine already built the identical table for the host
            # path (same channel set by the same config condition) --
            # reuse it rather than regenerating tens of MB of randoms
            table = engine._dither_table
            if table is None:
                from ..core.dither import DitherTable
                table = DitherTable(len(dith_phys), conf.sampling_rate,
                                    conf.max_dither_table_size, self.N,
                                    engine.rd.type)
            self._dith_tab = jnp.asarray(table.tab)
            self._dith_randmap = jnp.asarray(table.randmap)
            self._dith_size = table.size
            for dev, dithers in zip(conf.iodevs[OUT], self._dev_dither):
                if not dithers:
                    self._dith_rows.append(None)
                    continue
                rows = np.asarray([order[dev.phys_base + i]
                                   for i in range(dev.used_channels)],
                                  np.int32)
                self._dith_rows.append(rows)
            D = len(dith_phys)
            ptr0 = np.asarray([j * table.spacing + 1 for j in range(D)],
                              np.int32)
            last0 = np.asarray([int(table.tab[p - 1]) for p in ptr0],
                               np.int32)
            self.dstate = {
                "ptr": jnp.asarray(ptr0),
                "last": jnp.asarray(last0),
                "sf": jnp.zeros((D, 2), engine.rd),
            }
        else:
            self._dith_rows = [None] * len(conf.iodevs[OUT])
        for io, key in ((IN, "dlw_in"), (OUT, "dlw_out")):
            if self._dly[io] is not None:
                self.dstate[key] = jnp.zeros(
                    (conf.n_channels[io], self._dly[io]["W"]), engine.rd)
        for io, key in ((IN, "sdr_in"), (OUT, "sdr_out")):
            if self._sd[io] is not None:
                self.dstate[key] = jnp.zeros(
                    (conf.n_channels[io], self._sd[io]["B"]), engine.rd)

        spec_ = spec
        in_wire = list(self.in_wire)
        out_wire = list(self.out_wire)

        dith_tab = self._dith_tab
        dith_rows = list(self._dith_rows)
        dev_dither = list(self._dev_dither)
        if dith_tab is not None:
            dith_randmap = self._dith_randmap
            dith_size = self._dith_size

        dly_in = self._dly[IN]
        dly_out = self._dly[OUT]
        sd_in = self._sd[IN]
        sd_out = self._sd[OUT]
        N_ = self.N

        mesh_ = self.mesh
        if mesh_ is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def constrain_(a):
                # cascade intermediates replicated (see parallel/mesh.py)
                return jax.lax.with_sharding_constraint(
                    a, NamedSharding(mesh_, P(*([None] * a.ndim))))
        else:
            constrain_ = None

        def apply_subdelay(x, rest, hrows, byp, B):
            C, Nn = x.shape
            n = Nn // B
            frames = jnp.concatenate([rest, x], axis=1)      # [C, N+B]
            lo = frames[:, :Nn].reshape(C, n, B)
            hi = frames[:, B:].reshape(C, n, B)
            w = jnp.concatenate([lo, hi], axis=2)            # [C, n, 2B]
            Y = jnp.fft.rfft(w, axis=2) * hrows[:, None, :]
            y = jnp.fft.irfft(Y, axis=2)[:, :, :B].reshape(C, Nn)
            y = jnp.where(byp[:, None], x, y.astype(x.dtype))
            return y, frames[:, Nn:]

        def apply_delay(x, win, dvec, W):
            joined = jnp.concatenate([win, x], axis=1)
            idx = (W + jnp.arange(x.shape[1], dtype=jnp.int32)[None, :]
                   - dvec[:, None])
            return jnp.take_along_axis(joined, idx, axis=1), joined[:, -W:]

        def sext24(w):
            # [.., 3] le bytes -> sign-extended int32 words
            w = w.astype(jnp.int32)
            w = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
            return w - ((w & 0x800000) << 1)

        def input_half(in_words, dstate, new_dstate, in_gain, dvec_in,
                       sdrows_in, sdbyp_in):
            """decode -> mute gains -> input delay/subdelay. Works on one
            block ([N, open] words -> [C, N]) or, in the batched offline
            path, a whole stream ([C, m*N]) -- delay gathers and the
            blockwise subdelay filter are length-agnostic."""
            xs = []
            for di, (sel, vmap) in enumerate(in_devs):
                w = in_words[di]
                if in_wire[di] in ("p24", "raw3"):
                    w = sext24(w)
                xs.append(decode_words(w, sel, vmap, spec_.real_dtype))
            x = jnp.concatenate(xs, axis=0)
            # mute gain at decode, BEFORE the delay/subdelay state: the
            # delay windows keep advancing on zeros while muted, so
            # unmute does not replay audio captured during the mute --
            # same order as the host path (engine.read_block)
            x = x * in_gain[:, None]
            if dly_in is not None:
                x, new_dstate["dlw_in"] = apply_delay(
                    x, dstate["dlw_in"], dvec_in, dly_in["W"])
            if sd_in is not None:
                x, new_dstate["sdr_in"] = apply_subdelay(
                    x, dstate["sdr_in"], sdrows_in, sdbyp_in, sd_in["B"])
            return x

        def output_half(y, dstate, new_dstate, out_gain, dvec_out,
                        sdrows_out, sdbyp_out):
            """NaN gate -> output delay/subdelay -> gains -> per-device
            mix + (dithered) quantize + wire packing + meters."""
            nan_ok = (jnp.all(jnp.isfinite(y[:, 0])) if y.shape[0]
                      else jnp.bool_(True))
            if sd_out is not None:
                y, new_dstate["sdr_out"] = apply_subdelay(
                    y, dstate["sdr_out"], sdrows_out, sdbyp_out,
                    sd_out["B"])
            if dly_out is not None:
                y, new_dstate["dlw_out"] = apply_delay(
                    y, dstate["dlw_out"], dvec_out, dly_out["W"])
            y = y * out_gain[:, None]
            if dith_tab is not None:
                # one shared window per block advances every dithered
                # channel's pointer by N (host-path parity)
                d_all, nptr, nlast = dither_window(
                    dith_tab, dith_randmap, dstate["ptr"], dstate["last"],
                    spec_.block_length, dith_size)
                sf_all = dstate["sf"]
            outs = []
            meters = []
            for di, ((sel, mixm, open_ch, fmt), wdt) in enumerate(
                    zip(out_devs, self.out_words)):
                if isinstance(mixm, tuple):           # ("perm", rows)
                    phys = y[mixm[1]]
                else:
                    # HIGHEST: full float32, not TF32 (see
                    # partconv.complex_mix)
                    phys = jnp.matmul(mixm, y,
                                      precision=jax.lax.Precision.HIGHEST)
                peak = jnp.max(jnp.abs(phys), axis=1)
                if dev_dither[di]:
                    rows = dith_rows[di]
                    q, sf_new, m = dither_quantize(
                        phys, d_all[rows], sf_all[rows],
                        fmt.imin, fmt.imax)
                    sf_all = sf_all.at[rows].set(sf_new)
                    words = scatter_words(q, sel, open_ch, wdt)
                else:
                    words, m = encode_words(phys, fmt, sel, open_ch, wdt)
                if out_wire[di] in ("p24", "raw3"):
                    # [N, open] int32 -> [N, open, 3] le bytes on the wire
                    w32 = words.astype(jnp.int32)
                    words = jnp.stack(
                        [(w32 >> s) & 0xFF for s in (0, 8, 16)],
                        axis=-1).astype(jnp.uint8)
                outs.append(words)
                meters.append(jnp.concatenate([m, peak[:, None]], axis=1))
            if dith_tab is not None:
                new_dstate.update(ptr=nptr, last=nlast, sf=sf_all)
            return outs, meters, nan_ok, new_dstate

        self._input_half = input_half
        self._output_half = output_half
        self._core_refs = (mac, mesh_, constrain_, spec_)

        def full_step(state, ctrl, in_gain, out_gain, bank, in_words,
                      dstate, dvec_in=None, dvec_out=None,
                      sdrows_in=None, sdbyp_in=None,
                      sdrows_out=None, sdbyp_out=None, uniform=False,
                      uniform_delay=False, xfade_now=None):
            new_dstate = dict(dstate)
            x = input_half(in_words, dstate, new_dstate, in_gain, dvec_in,
                           sdrows_in, sdbyp_in)
            if constrain_ is not None:
                # pin the time-domain block replicated before the rfft:
                # the partitioner otherwise picks fft layouts the XLA:CPU
                # test backend rejects (see parallel/mesh.py docstring)
                x = constrain_(x)
            state, y = _step_impl(spec_, mac, state, ctrl, bank, x,
                                  uniform=uniform,
                                  mesh=mesh_, constrain=constrain_,
                                  uniform_delay=uniform_delay,
                                  xfade_now=xfade_now)
            if constrain_ is not None:
                y = constrain_(y)
            outs, meters, nan_ok, new_dstate = output_half(
                y, dstate, new_dstate, out_gain, dvec_out, sdrows_out,
                sdbyp_out)
            return state, tuple(outs), tuple(meters), nan_ok, new_dstate

        self._full_step = full_step
        if mesh_ is not None:
            # pin the persistent state/ctrl/bank shardings; everything
            # else (wire words, meters, dither/delay state) is replicated
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.mesh import step_shardings
            st_s, ct_s, bank_s, _, _ = step_shardings(mesh_)
            repl = NamedSharding(mesh_, P())
            self._in_sh = (st_s, ct_s, repl, repl, bank_s,
                           repl, repl, repl, repl, repl, repl, repl, repl)
            self._out_sh = (st_s, repl, repl, repl, repl)
            self._jit_kw = dict(in_shardings=self._in_sh,
                                out_shardings=self._out_sh,
                                donate_argnums=(0, 6))
        else:
            self._in_sh = self._out_sh = None
            self._jit_kw = dict(donate_argnums=(0, 6))
        # host-selected program variants, compiled lazily per
        # (uniform, xfade) key -- see graph/compile._step_impl
        self._steps = {}
        self._step = self._program(False, None)
        self._multi = {}

    def _program(self, uniform: bool, xfade):
        key = (uniform, xfade)
        if key not in self._steps:
            self._steps[key] = jax.jit(
                functools.partial(self._full_step, uniform=key[0],
                                  xfade_now=key[1]), **self._jit_kw)
        return self._steps[key]

    def _dvecs(self):
        return (self._dly[IN]["arr"] if self._dly[IN] else None,
                self._dly[OUT]["arr"] if self._dly[OUT] else None)

    def _sd_refresh(self, io):
        d = self._sd[io]
        steps = d["steps"]
        rows, byp = [], []
        for ch, v in enumerate(d["cur"]):
            in_range = -steps < v < steps
            if not d["defined"][ch]:
                rows.append(steps - 1)          # centered dirac row
                byp.append(False)
            elif in_range:
                rows.append(v + steps - 1)
                byp.append(False)
            else:
                rows.append(steps - 1)
                byp.append(True)                # out of range: bypass
        d["hrows"] = d["H"][jnp.asarray(np.asarray(rows, np.int32))]
        d["byp"] = jnp.asarray(np.asarray(byp))

    def _sdvecs(self):
        out = []
        for io in (IN, OUT):
            d = self._sd[io]
            out += ([d["hrows"], d["byp"]] if d else [None, None])
        return out

    def update_subdelays(self, in_vals, out_vals):
        for io, vals in ((IN, in_vals), (OUT, out_vals)):
            d = self._sd[io]
            if d is None:
                continue
            vals = list(vals)
            if vals != d["cur"]:
                d["cur"] = vals
                self._sd_refresh(io)

    def update_delays(self, in_delays, out_delays):
        """Apply runtime delay changes with the reference's change_delay
        semantics (delay.c:283-317, golden-pinned on the host DelayLine):
        silently refuse > maxdelay or fixed (-1) channels; an increase
        zeroes the channel's ENTIRE effective history -- the next
        ``new`` output samples are silence, exactly like the reference's
        buffer memsets. A decrease keeps the true last samples (FIFO
        drop-oldest); the reference instead replays stale buffer contents
        for one pipeline refill -- a curbuf-reset artifact the windowed
        gather deliberately does not copy (docs/PARITY.md)."""
        for io, vals, key in ((IN, in_delays, "dlw_in"),
                              (OUT, out_delays, "dlw_out")):
            d = self._dly[io]
            if d is None:
                continue
            changed = False
            for ch, new in enumerate(vals):
                old = d["cur"][ch]
                md = d["max"][ch]
                if new == old or md < 0 or new > md:
                    continue
                if new > old:
                    W = d["W"]
                    self.dstate[key] = (self.dstate[key]
                                        .at[ch, W - new:].set(0.0))
                d["cur"][ch] = new
                changed = True
            if changed:
                d["arr"] = jnp.asarray(np.asarray(d["cur"], np.int32))

    def _stage_ctrl(self, ctrl):
        """Pre-stage the control pytree on device, reused while the
        snapshot object is unchanged (RuntimeControl.snapshot returns a
        cached instance between control changes). Saves ~11 small host
        uploads per block on the realtime path."""
        if ctrl is not self._staged_src:
            if self._in_sh is not None:
                self._staged = jax.device_put(ctrl, self._in_sh[1])
            else:
                self._staged = jax.tree_util.tree_map(jnp.asarray, ctrl)
            self._staged_src = ctrl
        return self._staged

    def step(self, state, ctrl, in_gain, out_gain, bank, in_words,
             uniform=False, xfade=None):
        fn = self._program(uniform, xfade)
        di, do = self._dvecs()
        sri, sbi, sro, sbo = self._sdvecs()
        state, outs, meters, nan_ok, self.dstate = fn(
            state, self._stage_ctrl(ctrl), in_gain, out_gain, bank,
            in_words, self.dstate, di, do, sri, sbi, sro, sbo)
        return state, outs, meters, nan_ok

    def multi_step(self, m: int, uniform: bool = False,
                   udelay: bool = False, xfade=None):
        """A scan over m blocks per dispatch (offline throughput mode).

        Controls are frozen across the m blocks; the host amortizes the
        dispatch/transfer round trip. Inputs are per-device stacked words
        [m, N, open_ch]; outputs stacked likewise, meters aggregated.

        ``udelay``: caller asserts every filter shares one pre-delay for
        the batch (Control.snapshot_uniform_delay) -- selects the
        scalar-slot ring-write program variant (graph/compile.py
        ``uniform_delay``). Like ``uniform`` it is part of the compiled-
        program cache key; programs compile lazily per key, so this adds
        no setup cost for configs that never flip it.

        BRUTEFIR_TPU_PREFFT=1 opts into the pre-FFT-hoisted variant:
        decode, input delay/subdelay, gains, framing and the forward rfft
        of all m blocks run as one batched computation before the scan
        (they depend only on the input stream, not the ring). An opt-in
        experiment; the scanned path is the default.
        """
        key = (m, uniform, bool(udelay), xfade)
        if key not in self._multi:
            if os.environ.get("BRUTEFIR_TPU_PREFFT", "0") != "1":
                return self._multi_step_scanned(m, key)
            N = self.N
            input_half = self._input_half
            output_half = self._output_half
            mac, mesh_, constrain_, ps_spec = self._core_refs
            if mesh_ is not None:
                from jax.sharding import PartitionSpec as _P
                from ..ops import partconv as _pc
                rfft_b = jax.shard_map(_pc.rfft_planes, mesh=mesh_,
                                       in_specs=_P(), out_specs=_P(),
                                       check_vma=False)
            else:
                from ..ops import partconv as _pc
                rfft_b = _pc.rfft_planes

            def multi(state, ctrl, in_gain, out_gain, bank, in_words,
                      dstate, dvec_in, dvec_out, sri, sbi, sro, sbo):
                # ---- batched front half over the whole m-block stream
                new_dstate = dict(dstate)
                stream_words = [
                    w.reshape((w.shape[0] * w.shape[1],) + w.shape[2:])
                    for w in in_words]
                xs = input_half(stream_words, dstate, new_dstate, in_gain,
                                dvec_in, sri, sbi)          # [C, m*N]
                C = xs.shape[0]
                swp = jnp.concatenate([state.prev_in, xs], axis=1)
                lo = swp[:, :m * N].reshape(C, m, N)
                hi = swp[:, N:].reshape(C, m, N)
                frames = jnp.concatenate([lo, hi], axis=2)  # [C, m, 2N]
                frames = jnp.moveaxis(frames, 1, 0)         # [m, C, 2N]
                if ps_spec.powersave:
                    thr = ctrl.ps_thresh[None, :, None]
                    peak = jnp.max(jnp.abs(frames), axis=2, keepdims=True)
                    frames = jnp.where((thr > 0) & (peak < thr),
                                       jnp.zeros_like(frames), frames)
                if constrain_ is not None:
                    frames = constrain_(frames)
                X_all = rfft_b(frames)                      # [m, C, 2, N]
                x_seq = jnp.moveaxis(xs.reshape(C, m, N), 1, 0)

                # ---- sequential half: ring/MAC/mix/irfft/encode
                def body(carry, inp):
                    st, ds = carry
                    Xk, xk = inp
                    st, y = _step_impl(ps_spec, mac, st, ctrl, bank, xk,
                                       uniform=key[1],
                                       mesh=mesh_, constrain=constrain_,
                                       pre_X=Xk, uniform_delay=key[2],
                                       xfade_now=key[3])
                    if constrain_ is not None:
                        y = constrain_(y)
                    nd = dict(ds)
                    outs, meters, nan, nd = output_half(
                        y, ds, nd, out_gain, dvec_out, sro, sbo)
                    return (st, nd), (tuple(outs), tuple(meters), nan)

                (state, dstate), (outs, meters, nans) = jax.lax.scan(
                    body, (state, new_dstate), (X_all, x_seq))
                return (state, outs, _agg_meters(meters), jnp.all(nans),
                        dstate)

            self._register_multi(key, multi)
        return self._multi[key]

    def _register_multi(self, key, multi):
        """jit a batched ``multi`` body under the engine's sharding/
        donation profile and install the dvec/dstate plumbing wrapper.
        Shared by the default scanned variant and the opt-in pre-FFT
        variant so their dispatch contracts cannot diverge."""
        if self._in_sh is not None:
            jfn = jax.jit(multi, in_shardings=self._in_sh,
                          out_shardings=self._out_sh,
                          donate_argnums=(0, 6))
        else:
            jfn = jax.jit(multi, donate_argnums=(0, 6))

        def wrapped(state, ctrl, in_gain, out_gain, bank, in_words,
                    _fn=jfn):
            di, do = self._dvecs()
            sri, sbi, sro, sbo = self._sdvecs()
            state, outs, agg, nan, self.dstate = _fn(
                state, self._stage_ctrl(ctrl), in_gain, out_gain, bank,
                in_words, self.dstate, di, do, sri, sbi, sro, sbo)
            return state, outs, agg, nan

        self._multi[key] = wrapped
        return wrapped

    def _multi_step_scanned(self, m: int, key):
        """Default batched dispatch: the whole per-block step (incl.
        decode and forward rfft) inside the scan body."""
        fs = functools.partial(self._full_step, uniform=key[1],
                               uniform_delay=key[2], xfade_now=key[3])

        def multi(state, ctrl, in_gain, out_gain, bank, in_words,
                  dstate, dvec_in, dvec_out, sri, sbi, sro, sbo):
            def body(carry, words):
                st, ds = carry
                st, outs, meters, nan, ds = fs(st, ctrl, in_gain,
                                               out_gain, bank,
                                               list(words), ds,
                                               dvec_in, dvec_out,
                                               sri, sbi, sro, sbo)
                return (st, ds), (outs, meters, nan)

            (state, dstate), (outs, meters, nans) = jax.lax.scan(
                body, (state, dstate), tuple(in_words))
            return state, outs, _agg_meters(meters), jnp.all(nans), dstate

        return self._register_multi(key, multi)
