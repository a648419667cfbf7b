"""The engine: host pipeline around the jitted device step.

The reference's three forked processes and token pipes (`bfrun.c:774-964`,
SURVEY 2.3) collapse into one host loop that overlaps stages through JAX's
asynchronous dispatch: while the device computes block k, the host decodes
block k+1 and encodes block k-1. The fixed-latency contract (output frame m
is the convolution of input frames <= m; file-to-file output length equals
input length, with the EOF tail truncated like dai.c:1423-1439) is preserved.

Per block:
  host   decode: device read -> raw2float -> per-virtual delay/mute -> [C,N]
  device step:   rfft -> mix -> partitioned spectral MAC -> crossfade ->
                 cascades -> out mix -> irfft  (graph/compile.py)
  host   encode: NaN/safety checks -> per-virtual delay/mute -> virt->phys
                 mix -> dither/quantize -> device write
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config.model import BFConfig, IN, OUT
from ..config.coeffs import build_bank
from ..core.codecs import Overflow, raw_to_float, float_to_raw
from ..core.delayline import DelayLine
from ..core.dither import DitherTable
from ..errors import BFError, BF_EXIT_INVALID_INPUT
from ..graph.compile import CompiledGraph
from ..graph.spec import build_graph_spec
from ..io import get_io_module
from .control import RuntimeControl


class EngineError(BFError):
    pass


def _expand_p24(raw: np.ndarray) -> np.ndarray:
    """[..., open, 3] le wire bytes -> [..., open] int32 container words
    (sign-extended), the inverse of the device's S24 wire packing."""
    w = (raw[..., 0].astype(np.int32)
         | (raw[..., 1].astype(np.int32) << 8)
         | (raw[..., 2].astype(np.int32) << 16))
    return w - ((w & 0x800000) << 1)


class Engine:
    """Runs a parsed config. ``mesh``: an optional jax.sharding.Mesh with
    ('f', 'sp') axes -- the block step then shards the filter and
    frequency-bin axes across the mesh's devices (parallel/mesh.py); the
    host I/O paths are unchanged."""

    def __init__(self, conf: BFConfig, bank: Optional[np.ndarray] = None,
                 mesh=None):
        self.conf = conf
        # persistent compile cache (the FFTW-wisdom analog,
        # fftw_convolver.c:809-848): later runs skip compilation
        from .compile_cache import configure_compile_cache
        configure_compile_cache()
        self.N = conf.filter_length
        self.B = conf.n_blocks
        self.rd = np.dtype(np.float32 if conf.realsize == 4 else np.float64)
        # Full float32 matmuls engine-wide: on the GPU the default float32
        # matmul precision may run in TF32 (10 mantissa bits), far short of
        # 24-bit audio. HIGHEST is also set at each matmul site; this
        # covers any other op XLA lowers to a matrix unit.
        jax.config.update("jax_default_matmul_precision", "highest")
        if conf.realsize == 8 and not jax.config.jax_enable_x64:
            # float_bits: 64 needs 64-bit jax types engine-wide
            jax.config.update("jax_enable_x64", True)

        filter_inputs = [[src for src, _ in f.in_filters] for f in conf.filters]
        channel_inputs = [[ch for ch, _ in f.in_channels] for f in conf.filters]
        output_sources = [[] for _ in range(conf.n_channels[OUT])]
        for n, f in enumerate(conf.filters):
            for ch, _ in f.out_channels:
                output_sources[ch].append(n)
        crossfades = [f.crossfade for f in conf.filters]

        # manual filter->process placement (`filter { process: N; }`,
        # bfconf.c:1024-1036): the parser enforces all-or-none and the
        # cross-process mixing constraints (bfconf.c:2893-2931)
        manual_proc = [f.process for f in conf.filters]
        manual = bool(conf.filters) and all(p >= 0 for p in manual_proc)
        n_proc = (max(manual_proc) + 1) if manual else 0

        self._mesh_auto = False
        if mesh is None:
            # multi-device hosts shard by default, like the reference's
            # one-filter-process-per-CPU default with its automatic load
            # balancer (bfconf.c:2227-2318); BRUTEFIR_TPU_MESH overrides
            # ("off", "2x4", ...). An explicit mesh= argument wins.
            from ..parallel.mesh import auto_mesh
            self._mesh_auto = (os.environ.get("BRUTEFIR_TPU_MESH", "auto")
                               .strip().lower() in ("", "auto"))
            try:
                mesh = auto_mesh(max(len(conf.filters), 1), self.N, self.rd,
                                 f_pref=n_proc if manual else 0)
            except BFError:
                raise   # malformed BRUTEFIR_TPU_MESH: typed config error
            except RuntimeError:
                if not self._mesh_auto:
                    # an explicitly requested BRUTEFIR_TPU_MESH=FxS must
                    # not silently degrade to single-device
                    raise
                mesh = None   # no backend yet (import-time probing)
            if mesh is not None and not getattr(conf, "quiet", False):
                sys.stderr.write(
                    f"Multi-device mesh: f={mesh.shape['f']} x "
                    f"sp={mesh.shape['sp']} over "
                    f"{mesh.devices.size} devices\n")

        # honor manual pins as grouped shard assignment on the 'f' axis:
        # permute the filter axis so each process group occupies its own
        # contiguous shard chunk (padding groups to equal size with inert
        # rows -- zero in_mix/mask/out_mix), process id -> shard
        # round-robin like the reference folds processes onto CPUs
        # (bfconf.c:2304-2316). f2spec maps config filter index -> spec
        # row; None = identity (auto placement / single device).
        self.f2spec = None
        self.spec_rows = None          # spec row -> config idx (-1 = pad)
        if manual and mesh is not None and mesh.shape["f"] > 1:
            f_n = mesh.shape["f"]
            groups = [[] for _ in range(f_n)]
            for nf, p in enumerate(manual_proc):
                groups[p % f_n].append(nf)
            gsize = max(len(g) for g in groups)
            rows = []
            for g in groups:
                rows.extend(g + [-1] * (gsize - len(g)))
            f2spec = np.full(len(conf.filters), -1, np.int32)
            for row, nf in enumerate(rows):
                if nf >= 0:
                    f2spec[nf] = row
            self.f2spec = f2spec
            self.spec_rows = rows
            filter_inputs = [
                ([int(f2spec[s]) for s in filter_inputs[nf]] if nf >= 0
                 else []) for nf in rows]
            channel_inputs = [
                (channel_inputs[nf] if nf >= 0 else []) for nf in rows]
            crossfades = [(crossfades[nf] if nf >= 0 else False)
                          for nf in rows]
            output_sources = [[int(f2spec[s]) for s in srcs]
                              for srcs in output_sources]
            if not getattr(conf, "quiet", False):
                sys.stderr.write(
                    f"Manual process placement: {n_proc} process group(s) "
                    f"onto the {f_n}-way 'f' mesh axis "
                    f"({len(rows)} filter rows incl. padding)\n")
        elif manual and not getattr(conf, "quiet", False):
            # the reference pins work onto CPUs regardless; here a
            # single device (or an f=1 mesh) has nowhere to place --
            # say so rather than silently ignoring the setting
            sys.stderr.write(
                "Warning: filter process: settings have no effect "
                "(single device or no 'f' mesh axis to place onto)\n")

        self.spec = build_graph_spec(
            self.N, self.B, conf.n_channels[IN], conf.n_channels[OUT],
            filter_inputs, crossfades, self.rd,
            powersave=conf.powersave and conf.analog_powersave < 1.0,
            channel_inputs=channel_inputs, output_sources=output_sources)
        mac = os.environ.get("BRUTEFIR_TPU_MAC", "auto")
        self.cg = CompiledGraph(self.spec, mac=mac)
        self.mesh = mesh
        if bank is None:
            bank = build_bank(conf.coeffs, self.N, self.B, self.rd.type)
        from ..ops.partconv import np_c2p
        if np.iscomplexobj(bank):
            bank = np_c2p(bank)
        bank = np.asarray(bank)
        # Opt-in reduced-precision coefficient bank: the MAC reads each
        # ring and bank byte once per block, so its cost is bytes; storing
        # H as bfloat16 halves the bank-side traffic. The products still
        # accumulate in f32 (the MAC upconverts on load), but the
        # coefficients themselves
        # lose 16 mantissa bits (~0.2% response ripple) -- NOT the
        # reference's bit-parity contract, so default stays f32.
        bank_dt = os.environ.get("BRUTEFIR_TPU_BANK_DTYPE", "")
        if bank_dt in ("bf16", "bfloat16") and self.rd == np.float32:
            self.bank = jnp.asarray(bank, jnp.bfloat16)
        else:
            self.bank = jnp.asarray(bank)
        self.control = RuntimeControl(conf, self.spec,
                                      spec_rows=self.spec_rows,
                                      f2row=self.f2spec)

        # devices
        self.devices: List[list] = [[], []]
        _reset_cls = set()
        for io in (IN, OUT):
            for dev in conf.iodevs[io]:
                cls = get_io_module(dev.device_name, conf.modules_path)
                if cls not in _reset_cls:
                    _reset_cls.add(cls)
                    # clear stale module-global state left by a FAILED
                    # earlier config build in this process (e.g. ALSA's
                    # link_handles analog: an __init__ parse error
                    # raises before any handle opens, so close() never
                    # ran to reset it)
                    reset = getattr(cls, "reset_module_state", None)
                    if reset is not None:
                        reset()
                inst = cls(dev.device_params, io, dev.sample_format,
                           conf.sampling_rate, dev.open_channels)
                if inst.sample_format is not None:
                    dev.sample_format = inst.sample_format
                if dev.sample_format is None:
                    raise EngineError(
                        f'device "{dev.device_name}" did not resolve AUTO format')
                self.devices[io].append(inst)

        if conf.use_subdelay[IN] or conf.use_subdelay[OUT]:
            from .subdelay import SubsampleDelay
            self.subdelay = SubsampleDelay(conf, self.rd)
        else:
            self.subdelay = None

        # per-virtual-channel delay lines. The compensating subdelay
        # integer delay EXTENDS the capacity past the user's maxdelay --
        # the reference allocates `maxdelay + sdf_length`
        # (bfrun.c:1152-1162) so a channel at its full configured delay
        # stays time-aligned with the subdelay-filtered channels;
        # clamping to the bare maxdelay would silently run it
        # sdf_length samples early.
        self.dlines = [[], []]
        for io in (IN, OUT):
            for ch in range(conf.n_channels[io]):
                init = conf.delay[io][ch]
                md = conf.maxdelay[io][ch]
                if self.subdelay is not None:
                    extra = self.subdelay.extra_delay(io, ch)
                    init += extra
                    if md >= 0:
                        md += extra
                self.dlines[io].append(DelayLine(init, md, self.rd))

        # dither: per physical output channel with apply_dither, int format,
        # sbytes < 4 (bfconf.c:3174-3238)
        dithered_phys = []
        for dev in conf.iodevs[OUT]:
            fmt = dev.sample_format
            if dev.apply_dither and not fmt.is_float and fmt.sbytes < 4:
                for i in range(dev.used_channels):
                    dithered_phys.append(dev.phys_base + i)
        self.dither_state = [None] * conf.n_physical_channels[OUT]
        self._dither_table = None
        if dithered_phys:
            table = DitherTable(len(dithered_phys), conf.sampling_rate,
                                conf.max_dither_table_size, self.N,
                                dtype=self.rd.type)
            # kept for DeviceIO, which needs the same table on device --
            # regenerating it doubled startup cost and RAM (the random
            # tables can be tens of MB at large max_dither_table_size)
            self._dither_table = table
            for j, p in enumerate(sorted(dithered_phys)):
                self.dither_state[p] = table.new_state(j)

        # overflow meters, per virtual output channel; shared per physical
        self.overflow: List[Overflow] = []
        self._phys_overflow = []
        for p in range(conf.n_physical_channels[OUT]):
            fmt = conf.physical_format(OUT, p)
            self._phys_overflow.append(
                Overflow(max=1.0 if fmt.is_float else float(fmt.imax)))
        for ch in range(conf.n_channels[OUT]):
            self.overflow.append(self._phys_overflow[conf.virt2phys[OUT][ch]])

        if mesh is not None:
            from ..parallel.mesh import ShardedGraph
            self._sharded = ShardedGraph(self.cg, mesh)
            _, _, bank_s, _, _ = self._sharded.shardings
            self.bank = jax.device_put(self.bank, bank_s)
            self.state = self._sharded.init_state()
        else:
            self.state = self.cg.init_state()
        self.control_mutex = threading.RLock()
        # parallel per-device host encode (multi-core hosts only; the C
        # codec releases the GIL). One pool for the engine's lifetime.
        if (len(conf.iodevs[OUT]) > 1 and (os.cpu_count() or 1) > 1):
            from concurrent.futures import ThreadPoolExecutor
            self._encode_pool = ThreadPoolExecutor(
                max_workers=min(len(conf.iodevs[OUT]),
                                max(1, (os.cpu_count() or 2) - 1)),
                thread_name_prefix="bf-encode")
        else:
            self._encode_pool = None
        self._placed_ctrl = None
        self._placed_ctrl_src = None
        self.blockcounter = 0
        self.realtime_index = 0.0
        self._rti_max = 0.0
        # full-processing gate for the rti meter (bfrun.c:1436-1445,
        # 1567-1571): the reference counts a period only once every
        # filter has run full length -- i.e. after the B-block spectrum
        # ring has ramped, and (under powersave) only while the input is
        # live. The ramp counter is the engine-level procblocks analog.
        self._procblocks = 0
        # powersave dispatch skip (bfrun.c:722-772,1719-1722): consecutive
        # silent blocks seen by the device; once the ring history has
        # drained past _ps_drain the device state is at its all-zero
        # fixed point and further silent blocks skip dispatch entirely
        self._ps_fixed = 0
        self._ps_skipped = 0
        self._ps_pending_t = 0   # skips since the last dispatched block
        self._ps_drain = 0       # finalized in _run_loop_blocks
        self._ps_skippable = False
        self._ps_need_prev = None  # last skipped input block (see skip)
        self.logic = []          # logic module instances (cli/eq)
        self._peak_hooks = []    # bfevents.peak analogs (set in attach_logic)
        self._last_peak_state = None
        self._stage_t = np.zeros(4)  # decode, device, encode, total
        self._stage_blocks = 0
        self._stopped = False
        self._warming = False    # gates freqd taps during _warm_programs
        self._has_timed_hooks = False  # set when a logic module defines them
        # debug timeline ring (print_debug analog, bfrun.c:230-434):
        # (wall time, stage, event, blockcounter) per pipeline event from
        # all three stages (reader / dispatcher / writer thread; deque
        # append is thread-safe), dumped in full at exit as a per-process
        # per-period timeline. 1024 periods x ~8 events matches the
        # reference's DEBUG_MAX ring depth.
        if conf.debug:
            from collections import deque
            self._debug_ring = deque(maxlen=8192)  # O(1) trim per event
        else:
            self._debug_ring = None

        from .device_io import eligible as _dio_eligible, DeviceIO
        # device-side codecs run single-device AND sharded (the DeviceIO
        # jit pins the same state/bank shardings as ShardedGraph; wire
        # words are replicated -- decode is tiny next to the MAC)
        self.dio = DeviceIO(self) if _dio_eligible(conf) else None
        self._gain_version = -1
        self._in_gain = self._out_gain = None
        self._host_ctrl = self._host_ctrl_src = None  # staged StepCtrl

        self._v2p_in = np.asarray(conf.virt2phys[IN], dtype=np.int64)
        self._out_is_permutation = all(n == 1 for n in conf.n_virtperphys[OUT])
        if self._out_is_permutation:
            self._p2v_out = np.asarray(
                [conf.phys2virt[OUT][p][0]
                 for p in range(conf.n_physical_channels[OUT])], dtype=np.int64)
        self._in_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[IN]]
        self._out_framebytes = [
            d.sample_format.bytes * d.open_channels for d in conf.iodevs[OUT]]

        # input poll mode decision (dai.c:905-931): all clocked
        # non-callback inputs misaligned -> pace reads with short sleeps
        clocked_in = [i for i in self.devices[IN]
                      if i.uses_sample_clock and not i.is_callback]
        self._poll_mode = (bool(clocked_in)
                           and all(i.bad_alignment for i in clocked_in))
        if self._poll_mode:
            if not conf.allow_poll_mode:
                raise EngineError(
                    "sound input hardware requires poll mode to be "
                    "activated but current configuration does not allow "
                    "it (allow_poll_mode: false;)")
            if not getattr(conf, "quiet", False):
                sys.stderr.write("Input poll mode activated\n")

    # ----- logic modules -------------------------------------------------
    def attach_logic(self):
        from ..control import load_logic_module
        for name, params in self.conf.logic_modules:
            self.logic.append(load_logic_module(
                name, params, self, self.conf.modules_path))
        self._has_timed_hooks = any(
            getattr(m, "input_timed", None) is not None
            or getattr(m, "output_timed", None) is not None
            for m in self.logic)
        if self._has_timed_hooks and self.dio is not None:
            # timed hooks need host-side sample blocks
            self.dio = None
        # frequency-domain hooks (bfevents input_freqd/pre_convolve/
        # post_convolve/output_freqd, bfmod.h:192-215): opt-in ordered
        # host taps traced into the step only when a module registers one
        taps = {}
        for kind in ("input_freqd", "pre_convolve", "post_convolve",
                     "output_freqd"):
            hooks = [getattr(m, kind) for m in self.logic
                     if getattr(m, kind, None) is not None]
            if hooks:
                # pre/post_convolve are filter-indexed: under manual
                # process placement the traced idx are spec rows, but
                # the module ABI speaks config filter intnames --
                # translate (padding rows are skipped)
                row2conf = (self.spec_rows
                            if kind in ("pre_convolve", "post_convolve")
                            else None)
                taps[kind] = self._make_freqd_tap(hooks, row2conf)
        if taps:
            if self.mesh is not None:
                if not self._mesh_auto:
                    raise EngineError(
                        "frequency-domain module hooks require a single "
                        "device (BRUTEFIR_TPU_MESH=off, or drop the "
                        "explicit mesh)")
                # auto-selected mesh: degrade to a single device rather
                # than aborting a config that worked before auto-mesh
                if not getattr(self.conf, "quiet", False):
                    sys.stderr.write(
                        "Multi-device mesh disabled: a logic module "
                        "registered frequency-domain hooks (single-device "
                        "only)\n")
                self.mesh = None
                self._sharded = None
                self.bank = jnp.asarray(np.asarray(self.bank))
            self.dio = None  # hooks are traced into the host-path step
            self.cg = CompiledGraph(self.spec, mac=self.cg.mac, taps=taps)
            self.state = self.cg.init_state()
        # coeff_final from modules (bfevents.coeff_final; the EQ's own
        # double-buffer redirect wires control.coeff_final_hook directly)
        self.control.coeff_final_mod_hooks = [
            m.coeff_final for m in self.logic
            if getattr(m, "coeff_final", None) is not None]
        # peak push (BF_FDEVENT_PEAK / bfevents.peak, bfrun.c:589-618)
        self._peak_hooks = [m.peak for m in self.logic
                            if getattr(m, "peak", None) is not None]
        self._last_peak_state = tuple(
            (o.n_overflows, o.largest, o.intlargest) for o in self.overflow)
        for m in self.logic:
            hook = getattr(m, "initialised", None)
            if hook is not None:  # bfevents.initialised analog
                hook()

    def _make_freqd_tap(self, hooks, row2conf=None):
        """Host tap: planes [C, 2, N] -> natural rfft spectra [C, N+1]
        (complex, mutable rows) -> hooks -> planes back. The reference
        hands its internal reordered halfcomplex layout; the rebuild's
        module ABI uses the natural rfft layout (docs/PARITY.md).
        ``row2conf``: spec row -> config filter intname (manual process
        placement permutation); padding rows (-1) skip the hooks."""
        from ..ops.partconv import (np_p2c, np_c2p, pack_spectrum,
                                    unpack_spectrum)

        def tapfn(planes, idx):
            arr = np.asarray(planes)
            if self._warming:
                # _warm_programs compiles the tapped step with throwaway
                # data; module hooks must not observe the warmup block
                return arr
            zu = np.ascontiguousarray(unpack_spectrum(np_p2c(arr)))
            for ch in range(arr.shape[0]):
                fid = int(idx[ch])
                if row2conf is not None:
                    fid = row2conf[fid]
                    if fid < 0:
                        continue
                row = zu[ch]
                for h in hooks:
                    h(row, fid)
            return np_c2p(pack_spectrum(zu)).astype(arr.dtype)

        return tapfn

    def _peak_push(self):
        """Push a peak event to logic modules when any overflow meter
        changed (check_overflows, bfrun.c:589-618); gated on
        overflow_warnings like the reference."""
        if not self._peak_hooks or not self.conf.overflow_warnings:
            return
        cur = tuple((o.n_overflows, o.largest, o.intlargest)
                    for o in self.overflow)
        if cur != self._last_peak_state:
            self._last_peak_state = cur
            for h in self._peak_hooks:
                h()

    def stop(self):
        self._stopped = True

    def update_bank_entry(self, coeff_index: int, H: np.ndarray):
        """Hot-swap one coefficient set's spectral partitions (EQ render)."""
        H = np.asarray(H).reshape(self.bank.shape[1:])
        self.bank = self.bank.at[coeff_index].set(
            jnp.asarray(H, self.bank.dtype))

    # ----- host-side input path -------------------------------------------
    def read_block(self):
        """Read one fragment from all input devices.

        Returns (x [C_in, N] float, frames) where frames < N signals EOF.
        """
        conf = self.conf
        N = self.N
        phys = np.zeros((conf.n_physical_channels[IN], N), self.rd)
        frames = N
        for di, dev in enumerate(conf.iodevs[IN]):
            inst = self.devices[IN][di]
            want = N * self._in_framebytes[di]
            raw = self._read_device(inst, want, self._in_framebytes[di])
            got_frames = len(raw) // self._in_framebytes[di]
            if got_frames < N:
                frames = min(frames, got_frames)
            buf = np.frombuffer(raw, dtype=np.uint8)
            if len(raw) < want:
                buf = np.concatenate(
                    [buf, np.zeros(want - len(raw), np.uint8)])
            rows = raw_to_float(buf, dev.sample_format, N, dev.open_channels,
                                dev.channel_selection, self.rd)
            phys[dev.phys_base: dev.phys_base + dev.used_channels] = rows
        # map to virtual channels with per-virtual delay and mute
        if self._plain_path(IN) and not self._has_timed_hooks:
            return np.ascontiguousarray(phys[self._v2p_in]), frames
        x = np.zeros((conf.n_channels[IN], N), self.rd)
        zero_row = np.zeros(N, self.rd)
        for ch in range(conf.n_channels[IN]):
            # an input mute zeroes the samples BEFORE the delay/subdelay
            # state, which keeps advancing -- the reference's dai-module
            # semantics for 1-1 mapped channels (dai.c:255-300 clears the
            # raw buffer, the delay then runs on zeros) and what the
            # device-IO path does (mute gain at decode, before delays).
            # Skipping the processing entirely would freeze the buffers
            # and replay stale audio on unmute. (The reference's
            # multi-virt filter-process branch, bfrun.c:1510-1524, does
            # freeze the buffer -- an inconsistency we do not copy.)
            row = (zero_row if self.control.mute[IN][ch]
                   else phys[conf.virt2phys[IN][ch]])
            dl = self.dlines[IN][ch]
            dl.set_delay(self._total_delay(IN, ch))
            row = dl.process(row)
            if self.subdelay is not None:
                row = self.subdelay.process(IN, ch, row,
                                            self.control.subdelay[IN][ch])
            x[ch] = row
        for mod in self.logic:
            hook = getattr(mod, "input_timed", None)
            if hook is not None:
                for ch in range(conf.n_channels[IN]):
                    hook(x[ch], ch)
        return x, frames

    def _plain_path(self, io: int) -> bool:
        """True when no delay/mute/subdelay is active on any channel of this
        side, so the virtual mapping reduces to a gather (the common case and
        the whole path for the benchmark configs)."""
        ctrl = self.control
        return (self.subdelay is None
                and not any(ctrl.mute[io])
                and all(d == 0 for d in ctrl.delay[io])
                and all(dl.delay == 0 for dl in self.dlines[io]))

    def _total_delay(self, io: int, ch: int) -> int:
        d = self.control.delay[io][ch]
        if self.subdelay is not None:
            d += self.subdelay.extra_delay(io, ch)
        return d

    # ----- host-side output path --------------------------------------------
    def write_block(self, y: np.ndarray, frames: int, out_snap=None):
        """Encode and write one block. ``out_snap`` is the output-side
        control snapshot (delay, mute, subdelay lists) taken at the block's
        dispatch time, so deferred writes in the pipeline apply the control
        state of *their own* block, matching the reference's per-block icomm
        snapshot (bfrun.c:1460-1484)."""
        conf = self.conf
        N = self.N
        if out_snap is None:
            out_snap = (list(self.control.delay[OUT]),
                        list(self.control.mute[OUT]),
                        list(self.control.subdelay[OUT]))
        snap_delay, snap_mute, snap_subdelay = out_snap
        for mod in self.logic:
            hook = getattr(mod, "output_timed", None)
            if hook is not None:
                for ch in range(conf.n_channels[OUT]):
                    hook(y[ch], ch)
        # NaN guard (bfrun.c:1900-1911): check one sample per channel
        if y.shape[0] and not np.all(np.isfinite(y[:, 0])):
            raise EngineError("NaN or Inf values in the system! Invalid input?",
                              exit_code=BF_EXIT_INVALID_INPUT)

        plain = (self.subdelay is None
                 and not any(snap_mute)
                 and all(d == 0 for d in snap_delay)
                 and all(dl.delay == 0 for dl in self.dlines[OUT]))
        if plain and self._out_is_permutation:
            phys = np.ascontiguousarray(y[self._p2v_out])
        else:
            phys = np.zeros((conf.n_physical_channels[OUT], N), self.rd)
            for ch in range(conf.n_channels[OUT]):
                row = y[ch]
                if self.subdelay is not None:
                    row = self.subdelay.process(OUT, ch, row,
                                                snap_subdelay[ch])
                dl = self.dlines[OUT][ch]
                d = snap_delay[ch]
                if self.subdelay is not None:
                    d += self.subdelay.extra_delay(OUT, ch)
                dl.set_delay(d)
                row = dl.process(row)
                if snap_mute[ch]:
                    continue
                phys[conf.virt2phys[OUT][ch]] += row

        limit = conf.safety_limit
        def encode_one(di, dev):
            inst = self.devices[OUT][di]
            rows = phys[dev.phys_base: dev.phys_base + dev.used_channels]
            if limit != 0.0:
                for i in range(dev.used_channels):
                    ovf = self._phys_overflow[dev.phys_base + i]
                    peak = float(np.abs(rows[i]).max()) if rows.shape[1] else 0.0
                    if peak > limit * ovf.max:
                        raise EngineError(
                            f"safety limit exceeded on output "
                            f"({20 * np.log10(peak / ovf.max):.2f} > "
                            f"{20 * np.log10(limit):.2f} dB)")
            raw = np.zeros(N * self._out_framebytes[di], np.uint8)
            dstate = [self.dither_state[dev.phys_base + i]
                      for i in range(dev.used_channels)]
            ovfs = [self._phys_overflow[dev.phys_base + i]
                    for i in range(dev.used_channels)]
            float_to_raw(rows, dev.sample_format, dev.open_channels,
                         dev.channel_selection, raw, ovfs, dstate)
            inst.write(raw[: frames * self._out_framebytes[di]].tobytes())

        devs = list(enumerate(conf.iodevs[OUT]))
        if len(devs) > 1 and self._encode_pool is not None:
            # multi-device encode in parallel: dither/overflow state is
            # per physical channel and devices own disjoint ranges; the
            # C codec releases the GIL, so channels genuinely overlap on
            # multi-core hosts (the reference ran one output process
            # total -- this parallelizes *within* the output stage)
            list(self._encode_pool.map(
                lambda a: encode_one(*a), devs))
        else:
            for di, dev in devs:
                encode_one(di, dev)
        self._peak_push()

    # ----- main loop -----------------------------------------------------
    def setup(self):
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.init(self.N)
        self._warm_programs()
        self._maybe_go_realtime()
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.start()
        self._iodelay_fill()
        # synchronized start fires when processing begins, after the
        # iodelay fill (dai.c:720 for callback modules, dai.c:1178 for
        # modules that declare it -- e.g. ALSA's linked snd_pcm_start)
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_start()

    def _warm_programs(self):
        """Pre-compile both step-program variants before clocked devices
        start, so a runtime control change that flips the uniform-coeff
        fast path (graph/compile.py) never compiles on the audio path.
        Clockless (file/offline) runs skip this: they tolerate the lazy
        first-use compile and tests stay fast."""
        clocked = any(inst.uses_sample_clock
                      for io in (IN, OUT) for inst in self.devices[io])
        if not clocked or self.mesh is not None:
            return
        # run() attaches logic BEFORE setup so the programs warmed here
        # are the ones that actually run (attach_logic may drop dio or
        # rebuild cg with freqd taps); _warming silences the taps so
        # module hooks never observe the warmup block
        self._warming = True
        try:
            with self.control_mutex:
                ctrl = self.control.snapshot()
                g0, g1 = self._mute_gains()
            if self.dio is not None:
                words = [np.zeros((self.N,) + self.dio.in_wire_shape[i],
                                  self.dio.in_wire_dtype[i])
                         for i in range(len(self.conf.iodevs[IN]))]
                # warmup must not advance the persistent dither/delay
                # state (the dither pointers' start offset is part of the
                # bit-exact sequence contract, ops/device_dither.py);
                # deep-copy: the step donates dstate buffers
                dstate0 = jax.tree.map(jnp.copy, self.dio.dstate)
                # the runtime dispatches host-selected xfade variants
                # (False every quiet block; True only when some filter
                # can crossfade) -- warm exactly those, so a crossfade
                # mid-audio never hits a lazy compile
                xfs = ((False, True)
                       if any(f.crossfade for f in self.conf.filters)
                       else (False,))
                try:
                    for uni in (False, True):
                        for xf in xfs:
                            st = self.cg.init_state()
                            r = self.dio.step(st, ctrl, g0, g1, self.bank,
                                              list(words), uniform=uni,
                                              xfade=xf)
                            jax.block_until_ready(r[1])
                finally:
                    self.dio.dstate = dstate0
            else:
                x = np.zeros((self.conf.n_channels[IN], self.N), self.rd)
                xfs = ((False, True)
                       if any(f.crossfade for f in self.conf.filters)
                       else (False,))
                for uni in (False, True):
                    for xf in xfs:
                        st = self.cg.init_state()
                        _, y = self.cg.step(st, ctrl, self.bank, x,
                                            uniform=uni, xfade=xf)
                        jax.block_until_ready(y)
        except Exception as e:
            # warmup is best-effort (the lazy path still works), but a
            # failure here almost always means the same compile will fail
            # again mid-audio -- surface it loudly at setup time
            sys.stderr.write(
                f"Warning: step-program warmup failed ({type(e).__name__}: "
                f"{e}); compilation will be retried on the audio path.\n")
        finally:
            self._warming = False

    def _iodelay_fill(self):
        """Pre-write 2 silent fragments to clocked output devices.

        Establishes the fixed 2N-sample I/O latency before the first
        computed block reaches the device, so the pipeline has a full
        double-buffer cushion against block-time jitter (the reference's
        iodelay_fill, dai.c:1451-1457, driven from bfrun.c:870-899; the
        'synched_write' condition is a clocked non-callback output,
        bfconf.c:3154-3158)."""
        clocked = [(di, inst) for di, inst in enumerate(self.devices[OUT])
                   if inst.uses_sample_clock and not inst.is_callback]
        if not clocked:
            return
        conf = self.conf
        if not getattr(conf, "quiet", False):
            delay = 2 * self.N
            if conf.use_subdelay[IN]:
                delay += conf.sdf_length
            if conf.use_subdelay[OUT]:
                delay += conf.sdf_length
            sys.stderr.write(f"Fixed I/O-delay is {delay} samples\n"
                             "Audio processing starts now\n")
        for _ in range(2):
            for di, inst in clocked:
                inst.write(b"\0" * (self.N * self._out_framebytes[di]))

    def _maybe_go_realtime(self):
        """SCHED_FIFO + mlockall when clocked devices demand it, with the
        reference's graceful EPERM fallback (bf_make_realtime,
        bfrun.c:2735-2788)."""
        import os as _os
        clocked = any(inst.uses_sample_clock
                      for io in (IN, OUT) for inst in self.devices[io])
        if not clocked:
            return
        try:
            _os.sched_setscheduler(
                0, _os.SCHED_FIFO, _os.sched_param(4))
        except (PermissionError, OSError):
            sys.stderr.write(
                "Warning: failed to set realtime priority (not permitted); "
                "continuing with default scheduling.\n")
            return
        if self.conf.lock_memory:
            try:
                import ctypes
                libc = ctypes.CDLL(None, use_errno=True)
                libc.mlockall(3)  # MCL_CURRENT | MCL_FUTURE
            except OSError:
                pass

    def teardown(self):
        # xrun report for callback-bridged devices (the reference's dai
        # prints per-xrun warnings as they happen; the bridge counts them
        # -- native ring included -- and they are surfaced here)
        if not getattr(self.conf, "quiet", False):
            for io in (IN, OUT):
                for inst in self.devices[io]:
                    n = getattr(inst, "native_xruns", None)
                    if n is None:
                        n = ((getattr(inst, "underruns", 0) or 0)
                             + (getattr(inst, "overruns", 0) or 0))
                    n = int(n)
                    if n:
                        sys.stderr.write(
                            f"Warning: {n} xrun(s) on "
                            f"{'input' if io == IN else 'output'} device "
                            f'"{inst.__class__.__name__}"\n')
        for io in (IN, OUT):
            for inst in self.devices[io]:
                inst.synch_stop()
                inst.stop()
                inst.close()

    def _mute_gains(self):
        ver = getattr(self.control, "mute_version", 0)
        if ver != self._gain_version:
            self._in_gain = jnp.asarray(
                [0.0 if m else 1.0 for m in self.control.mute[IN]], self.rd)
            self._out_gain = jnp.asarray(
                [0.0 if m else 1.0 for m in self.control.mute[OUT]], self.rd)
            self._gain_version = ver
        return self._in_gain, self._out_gain

    def _dbg(self, stage: str, event: str, block: int):
        """Append one event to the debug timeline ring (no-op unless
        ``debug: true;``). Called from all pipeline threads -- deque
        append is atomic."""
        if self._debug_ring is not None:
            self._debug_ring.append(
                (time.perf_counter(), stage, event, block))

    def _update_full_proc(self, silent: bool, nblocks: int = 1) -> bool:
        """Advance the full-processing ramp (procblocks, bfrun.c:1567-1571):
        rti counts only after B+1 live blocks; a powersave-silent block
        resets the ramp (bfrun.c:1721-1722)."""
        if silent:
            self._procblocks = 0
        else:
            self._procblocks = min(self._procblocks + nblocks, self.B + 1)
        return self._procblocks > self.B

    def _input_silent(self, x) -> bool:
        """Powersave silence test on the decoded input block (test_silent,
        bfrun.c:722-772): exact zero for digital powersave, below the
        analog threshold when one is configured. Engine-level: all input
        channels must be quiet (per-filter granularity would need the
        filter graph's mixed-input zero flags)."""
        if not self.conf.powersave or x is None:
            return False
        thr = self.conf.analog_powersave
        if thr >= 1.0:
            peak = float(np.abs(x).max()) if x.size else 0.0
            return peak == 0.0
        if not x.size:
            return True
        # match the compiled gate EXACTLY, including its f32 rounding:
        # the traced gate compares the f32 frame peak against
        # ps_thresh = f32(analog / max(virtscale, 1e-30)) (control.py
        # snapshot); an f64 comparison here could deem a block silent
        # that the device gate never zeroed (rounding band around the
        # threshold), breaking the dispatch-skip's byte-identity claim
        scales = np.maximum(
            np.asarray(self.control.virtscale[IN], np.float64), 1e-30)
        thr32 = (thr / scales[: x.shape[0]]).astype(self.rd)
        peaks = np.abs(np.asarray(x, self.rd)).max(axis=-1)
        return bool(np.all(peaks < thr32))

    def _input_silent_words(self, xw) -> bool:
        """Silence test on raw input words (device-IO path): exact-zero
        only -- the analog threshold would need a decode, so analog
        powersave on this path never resets the rti ramp (documented
        deviation; digital silence, the common case, is exact)."""
        if not self.conf.powersave:
            return False
        return all(not np.asarray(w).any() for w in xw)

    def _read_device(self, inst, want: int, framebytes: int) -> bytes:
        """One device's fragment read; in poll mode, nanosleep-paced
        accumulation of nonblocking partial reads (dai.c:1198-1230,
        sleep tiers verbatim)."""
        if not (self._poll_mode and inst.bad_alignment):
            return inst.read(want)
        out = b""
        first = True
        while len(out) < want:
            if not first:
                usec = ((want - len(out)) // framebytes * 1_000_000
                        // self.conf.sampling_rate)
                if usec > 40000:
                    time.sleep(usec / 1e6)
                elif usec > 20000:
                    time.sleep(0.010)
                elif usec > 2050:
                    time.sleep(0.002)
                elif usec > 50:
                    time.sleep((usec - 50) / 1e6)
            first = False
            chunk = inst.read_nonblock(want - len(out))
            if chunk is None:
                continue
            if chunk == b"":
                break  # EOF
            out += chunk
        return out

    def read_block_dio(self):
        """Read raw words per input device for the device-side codec path."""
        conf = self.conf
        N = self.N
        frames = N
        words = []
        for di, dev in enumerate(conf.iodevs[IN]):
            inst = self.devices[IN][di]
            want = N * self._in_framebytes[di]
            raw = self._read_device(inst, want, self._in_framebytes[di])
            got = len(raw) // self._in_framebytes[di]
            if got < N:
                frames = min(frames, got)
            if len(raw) < want:
                raw = raw + b"\0" * (want - len(raw))
            if self.dio.in_wire[di] == "p24":
                # ship only the 3 significant bytes (see device_io.py)
                words.append(np.frombuffer(raw, dtype=np.uint8).reshape(
                    N, dev.open_channels, 4)[:, :, :3])
            elif self.dio.in_wire[di] == "raw3":
                # 3-byte packed S24: file bytes are the wire format
                words.append(np.frombuffer(raw, dtype=np.uint8).reshape(
                    N, dev.open_channels, 3))
            else:
                wdt = self.dio.in_words[di]
                words.append(np.frombuffer(raw, dtype=wdt).reshape(
                    N, dev.open_channels))
        return words, frames

    def _account_output_meters(self, dev, meters_d):
        """Fold one device's [used, 4] meter rows into the per-channel
        Overflow stats and enforce safety_limit (real2raw.h:32-42) --
        before anything is written to the device."""
        m = np.asarray(meters_d)
        fmt = dev.sample_format
        limit = self.conf.safety_limit
        for i in range(dev.used_channels):
            ovf = self._phys_overflow[dev.phys_base + i]
            ovf.n_overflows += int(m[i, 0])
            ovf.largest = max(ovf.largest, float(m[i, 1]))
            if not fmt.is_float:
                ovf.intlargest = max(ovf.intlargest, int(m[i, 2]))
            if limit != 0.0 and float(m[i, 3]) > limit * ovf.max:
                raise EngineError(
                    f"safety limit exceeded on output "
                    f"({20 * np.log10(float(m[i, 3]) / ovf.max):.2f} > "
                    f"{20 * np.log10(limit):.2f} dB)")

    def write_block_dio(self, outs, meters, nan_ok, frames):
        conf = self.conf
        if not bool(nan_ok):
            raise EngineError("NaN or Inf values in the system! Invalid input?",
                              exit_code=BF_EXIT_INVALID_INPUT)
        for di, dev in enumerate(conf.iodevs[OUT]):
            self._account_output_meters(dev, meters[di])
            raw = np.asarray(outs[di])
            if self.dio.out_wire[di] == "p24":
                raw = _expand_p24(raw)        # 3-byte wire -> 4-byte file
            # ("raw3": the 3-byte wire IS the file format -- write as-is)
            self.devices[OUT][di].write(
                raw[:frames].tobytes())
        self._peak_push()

    def _dio_zero_outs(self, N):
        """Synthesized silent wire words for a powersave-skipped block
        (bfrun.c:722-772): per output device, the exact words the device
        would produce for an all-zero block -- zero words for the signed
        int / float32 / packed-24 wire formats the dio path admits."""
        outs = []
        for di, dev in enumerate(self.conf.iodevs[OUT]):
            if self.dio.out_wire[di] in ("p24", "raw3"):
                outs.append(np.zeros((N, dev.open_channels, 3), np.uint8))
            else:
                outs.append(np.zeros((N, dev.open_channels),
                                     self.dio.out_words[di]))
        return outs

    def _dio_zero_meters(self):
        """Meter rows for a silent block: 0 overflows, 0.0 peaks."""
        return [np.zeros((dev.used_channels, 4), np.float32)
                for dev in self.conf.iodevs[OUT]]

    def _block_start_hooks(self):
        for mod in self.logic:
            hook = getattr(mod, "block_start", None)
            if hook is not None:
                hook(self.blockcounter)

    def run(self, max_blocks: Optional[int] = None, setup: bool = True):
        """Process until input EOF (or max_blocks). Returns run statistics."""
        if setup:
            # logic first: attach_logic may drop the device-IO path
            # (timed hooks) or rebuild the graph with freqd taps, and
            # setup()'s _warm_programs must compile the programs that
            # will actually run -- warming the pre-attach variants left
            # the first audio block paying a mid-stream compile
            self.attach_logic()
            self.setup()
        profile_dir = os.environ.get("BRUTEFIR_TPU_PROFILE")
        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        N = self.N
        budget = N / self.conf.sampling_rate  # seconds per block
        t_run0 = time.perf_counter()
        # bounded: p50/p95 over the most recent ~131k blocks (a
        # multi-day realtime run must not grow a list forever)
        self._periods = collections.deque(maxlen=1 << 17)
        self._last_progress = t_run0
        clocked = any(inst.uses_sample_clock for inst in self.devices[IN])
        self._monitor_clock = ((t_run0, self.blockcounter)
                               if self.conf.monitor_rate and clocked else None)
        eof = False
        show = self.conf.benchmark or self.conf.debug

        # The output stage runs on its own thread (the analog of the
        # reference's forked output process, bfrun.c:846-964): it fetches
        # the device result and encodes/writes block k while the main
        # thread decodes block k+1. The C codec and BLAS release the GIL,
        # so the stages genuinely overlap. Queue depth 2 bounds latency.
        import queue
        wq: "queue.Queue" = queue.Queue(maxsize=2)
        wstats = {"frames": 0, "blocks": 0, "err": None}

        def writer():
            while True:
                item = wq.get()
                if item is None:
                    return
                try:
                    wblk = wstats["blocks"]
                    self._dbg("output", "call write", wblk)
                    if item[0] == "dio":
                        _, outs, meters, nan_ok, fk = item
                        self.write_block_dio(outs, meters, nan_ok, fk)
                    else:
                        _, yk, fk, osnap = item
                        self.write_block(np.asarray(yk), fk, osnap)
                    wstats["frames"] += fk
                    wstats["blocks"] += 1
                    self._dbg("output", f"ret {fk} frames", wblk)
                except Exception as e:  # propagate to the main loop
                    wstats["err"] = e
                    return

        wth = threading.Thread(target=writer, daemon=True)
        wth.start()

        def shutdown_writer():
            try:
                wq.put(None, timeout=5.0)
            except queue.Full:
                pass
            # patient join: the writer may still be waiting on a cold
            # program compile; abandoning an in-flight device fetch can
            # crash the runtime at process exit. 600 s bounds a wedged
            # device (the opt-in watchdog aborts sooner when armed).
            wth.join(timeout=600.0)

        # opt-in stall watchdog (BRUTEFIR_TPU_WATCHDOG=<seconds>): abort
        # the process when NO block completes for that long mid-run --
        # a wedged device otherwise hangs the pipeline forever
        # (the reference likewise dies on a dead device). Armed only
        # after the first block, so slow first compiles never trip it.
        wd_timeout = float(os.environ.get("BRUTEFIR_TPU_WATCHDOG", "0")
                           or 0.0)
        wd_stop = threading.Event()
        if wd_timeout > 0:
            def _watchdog():
                last = (self.blockcounter, time.monotonic())
                while not wd_stop.wait(min(1.0, wd_timeout / 4)):
                    bc = self.blockcounter
                    if bc != last[0]:
                        last = (bc, time.monotonic())
                    elif (bc > 0
                          and time.monotonic() - last[1] > wd_timeout):
                        sys.stderr.write(
                            f"no block completed for {wd_timeout:.0f} s "
                            "(stalled device); aborting.\n")
                        sys.stderr.flush()
                        os._exit(1)   # BF_EXIT_OTHER
            threading.Thread(target=_watchdog, daemon=True,
                             name="bf-watchdog").start()

        try:
            try:
                self._run_loop_blocks(max_blocks, wq, wstats, N, budget,
                                      show)
            finally:
                wd_stop.set()
                shutdown_writer()
            if wstats["err"] is not None:
                raise wstats["err"]
        except BaseException:
            # error path: finalize the profiler trace and release the
            # devices -- a caller that catches an EngineError (e.g. the
            # safety-limit abort) and constructs a new Engine must not
            # inherit still-open devices or a truncated trace
            if profile_dir:
                try:
                    jax.profiler.stop_trace()
                except Exception:
                    pass
            if setup:
                try:
                    self.teardown()
                except Exception:
                    pass
            raise
        frames_out = wstats["frames"]

        if profile_dir:
            jax.profiler.stop_trace()
        elapsed = time.perf_counter() - t_run0
        if self._debug_ring is not None:
            self._dump_debug_timeline()
        if self.conf.overflow_warnings and not getattr(self.conf, "quiet", False):
            self._print_overflow_warnings()
        stats = {
            "blocks": self.blockcounter,
            "frames": frames_out,
            "elapsed_s": elapsed,
            "xrt": (frames_out / self.conf.sampling_rate) / elapsed
            if elapsed > 0 else 0.0,
            "rti_max": self._rti_max,
            "p50_block_ms": float(np.median(np.asarray(self._periods)) * 1e3)
            if self._periods else 0.0,
            "p95_block_ms": float(np.percentile(np.asarray(self._periods), 95) * 1e3)
            if self._periods else 0.0,
            "overflows": [o.n_overflows for o in self.overflow],
            "peak_db": [o.peak_db() for o in self.overflow],
            "ps_skipped": self._ps_skipped,
        }
        if setup:
            self.teardown()
        return stats

    def _run_loop_blocks(self, max_blocks, wq, wstats, N, budget, show):
        import queue

        # Dispatch-skip eligibility (decided here, after attach_logic may
        # have dropped the device-IO path). Drain margin: B blocks flush
        # the spectra ring, one per cascade stage flushes the eval_prev
        # tails, +2 covers the loud->silent boundary block and the
        # tail-flush block. On the device-IO path the device also holds
        # integer-delay windows and subdelay rings (device_io.dstate);
        # they drain to zeros too, so the margin grows by their block
        # capacity. Output dither is the one device state with NO silent
        # fixed point (the stream position matters), so a dithered dio
        # output disables the skip -- the host path keeps dither host-side
        # in write_block and skips fine.
        self._ps_drain = self.B + len(self.spec.stages) + 2
        dio_ok = False
        if self.dio is not None:
            dio_ok = not any(self.dio._dev_dither)
            for io in (IN, OUT):
                d = self.dio._dly[io]
                if d is not None:
                    self._ps_drain += -(-d["W"] // N)    # ceil
                if self.dio._sd[io] is not None:
                    self._ps_drain += 1
        self._ps_skippable = (
            bool(self.conf.powersave) and (self.dio is None or dio_ok)
            # freqd tap hooks are traced into the step and may mutate
            # spectra (or simply expect to observe every block) -- a
            # skipped dispatch would silently bypass them
            and not getattr(self.cg, "taps", None)
            and os.environ.get("BRUTEFIR_TPU_PS_SKIP", "1") != "0")

        eof = False
        while not self._stopped and not eof:
            if max_blocks is not None and self.blockcounter >= max_blocks:
                break
            if wstats["err"] is not None:
                break
            t0 = time.perf_counter()
            self._dbg("input", "call read", self.blockcounter)
            self._block_start_hooks()
            if self.dio is not None:
                xw, frames = self.read_block_dio()
            else:
                x, frames = self.read_block()
            self._dbg("input", f"ret {frames} frames", self.blockcounter)
            if frames < N:
                eof = True
                if frames == 0 and self.blockcounter == 0:
                    break
            t1 = time.perf_counter()
            pending_item = None
            # powersave silence, decided BEFORE dispatch: once the device
            # ring history has fully drained (the reference's procblocks
            # countdown, bfrun.c:1566-1571,1719-1722), the device state
            # sits at its all-zero fixed point and a further silent block
            # is skipped entirely -- no upload, no execute, no download.
            # The host synthesizes the zero output block; write_block's
            # host-side encode (delays, meters, dither) keeps advancing,
            # so the byte stream is identical to the always-dispatch run.
            if self.dio is not None:
                silent = self._input_silent_words(xw)
            else:
                silent = self._input_silent(x if frames > 0 else None)
            skip = (silent and frames == N and self._ps_skippable
                    and self._ps_fixed >= self._ps_drain)
            if skip:
                with self.control_mutex:
                    # control bookkeeping must advance exactly as on a
                    # dispatched block (prev_coeff, EQ coeff_final hooks);
                    # out_snap only feeds the host path's write_block
                    self.control.snapshot()
                    out_snap = (None if self.dio is not None else
                                (list(self.control.delay[OUT]),
                                 list(self.control.mute[OUT]),
                                 list(self.control.subdelay[OUT])))
                if self.dio is not None:
                    # zero wire words ARE the device's silent output: the
                    # drained delay/subdelay rings hold zeros, gains scale
                    # zeros, and the mid-tread quantizers map 0.0 -> word
                    # 0 for every dio-eligible format (no dither here --
                    # eligibility above). Meters: 0 overflows, 0.0 peaks.
                    pending_item = ("dio", self._dio_zero_outs(N),
                                    self._dio_zero_meters(), True, frames)
                else:
                    # fresh buffer: output_timed hooks may mutate rows
                    y0 = np.zeros((self.conf.n_channels[OUT], N), self.rd)
                    pending_item = ("host", y0, frames, out_snap)
                    # prev_in is stored pre-gate (compile.py StepState):
                    # the always-dispatch path would hold this block's
                    # samples there (sub-threshold noise under the analog
                    # gate), so remember them for restoration at resume.
                    # (dio silence is exact-zero words, so its prev_in
                    # fixed point is already zeros -- nothing to restore.)
                    self._ps_need_prev = x
                self._ps_skipped += 1
                self._ps_pending_t += 1
                self.blockcounter += 1
            elif frames > 0 or self.blockcounter == 0:
                if self._ps_pending_t:
                    # skipped blocks advance the ring clock too: the ring
                    # write position and the MAC's rotation are t mod B
                    # (graph/compile.py), so resume must land on the same
                    # rotation as the always-dispatch run -- same float
                    # summation order, bit-identical output
                    tv = jnp.asarray(np.int32(
                        int(self.state.t) + self._ps_pending_t))
                    if self.mesh is not None:
                        st_s = (self.dio._in_sh[0] if self.dio is not None
                                else self._sharded.shardings[0])
                        tv = jax.device_put(tv, st_s.t)
                    self.state = self.state._replace(t=tv)
                    self._ps_pending_t = 0
                if self._ps_need_prev is not None:
                    # resume after skipped blocks: restore the
                    # overlap-save tail to the last skipped input block,
                    # exactly what always-dispatch would hold in prev_in
                    pv = jnp.asarray(self._ps_need_prev)
                    if self.mesh is not None:
                        pv = jax.device_put(
                            pv, self._sharded.shardings[0].prev_in)
                    self.state = self.state._replace(prev_in=pv)
                    self._ps_need_prev = None
                self._dbg("filter", "call dispatch", self.blockcounter)
                with self.control_mutex:
                    ctrl = self.control.snapshot()
                    gains = self._mute_gains()
                    uni = self.control.snapshot_uniform
                    xf = self.control.snapshot_xfade
                    if self.dio is not None:
                        dly_snap = (list(self.control.delay[IN]),
                                    list(self.control.delay[OUT]))
                        sd_snap = (list(self.control.subdelay[IN]),
                                   list(self.control.subdelay[OUT]))
                    else:
                        # under the same lock as ctrl: a concurrent CLI
                        # line must not be observed half-applied or from
                        # a different epoch than the block's ctrl
                        out_snap = (list(self.control.delay[OUT]),
                                    list(self.control.mute[OUT]),
                                    list(self.control.subdelay[OUT]))
                if self.dio is not None:
                    self.dio.update_delays(*dly_snap)
                    self.dio.update_subdelays(*sd_snap)
                    # numpy words go straight into the jitted call (one
                    # host->device copy per argument, no separate put)
                    self.state, outs, meters, nan_ok = self.dio.step(
                        self.state, ctrl, gains[0], gains[1], self.bank,
                        list(xw), uniform=uni, xfade=xf)
                    pending_item = ("dio", outs, meters, nan_ok, frames)
                else:
                    if self.mesh is not None:
                        if ctrl is not self._placed_ctrl_src:
                            self._placed_ctrl, _, _ = self._sharded.place(
                                ctrl, self.bank, jnp.asarray(x))
                            self._placed_ctrl_src = ctrl
                        _, _, bank_s, x_s, _ = self._sharded.shardings
                        sx = jax.device_put(jnp.asarray(x), x_s)
                        self.state, y_dev = self._sharded.step(
                            self.state, self._placed_ctrl, self.bank, sx,
                            xfade=xf)
                    else:
                        # pre-stage the control pytree on device (reused
                        # while the snapshot object is unchanged): a
                        # numpy ctrl costs ~11 small uploads per block
                        if ctrl is not self._host_ctrl_src:
                            self._host_ctrl = jax.tree_util.tree_map(
                                jnp.asarray, ctrl)
                            self._host_ctrl_src = ctrl
                        self.state, y_dev = self.cg.step(
                            self.state, self._host_ctrl, self.bank, x,
                            uniform=uni, xfade=xf)
                    pending_item = ("host", y_dev, frames, out_snap)
                self._dbg("filter", "ret", self.blockcounter)
                self.blockcounter += 1
            t2 = time.perf_counter()
            if pending_item is not None and frames > 0:
                while wstats["err"] is None:
                    try:
                        wq.put(pending_item, timeout=1.0)
                        break
                    except queue.Full:
                        continue
            t3 = time.perf_counter()

            period = t3 - t0
            self._periods.append(period)
            rti = period / budget
            if not silent:
                self._ps_fixed = 0
            elif self._ps_fixed < self._ps_drain:
                self._ps_fixed += 1
            full = self._update_full_proc(silent)
            if full:
                self.realtime_index = rti
                self._rti_max = max(self._rti_max, rti)
            self._stage_t += (t1 - t0, t2 - t1, t3 - t2, period)
            self._stage_blocks += 1
            if show and self._stage_blocks % 10 == 0:
                self._print_stage_table()
            if (self.conf.show_progress
                    and not getattr(self.conf, "quiet", False)
                    and t3 - self._last_progress > 1.0):
                self._last_progress = t3
                if full:
                    sys.stderr.write(f"rti: {rti:.3f}\n")
                else:
                    sys.stderr.write(
                        "rti: not full processing - no rti update\n")
            if self._monitor_clock is not None:
                # sample-rate drift abort at +-2% (dai.c:1336-1369)
                w = t3 - self._monitor_clock[0]
                if w > 4.0:
                    measured = (self.blockcounter - self._monitor_clock[1]) \
                        * N / w
                    self._monitor_clock = (t3, self.blockcounter)
                    drift = measured / self.conf.sampling_rate
                    if not (0.98 < drift < 1.02):
                        raise EngineError(
                            f"sample rate drift detected: measured "
                            f"{measured:.0f} Hz, configured "
                            f"{self.conf.sampling_rate} Hz")

    def run_offline(self, max_blocks=None, batch_blocks: int = 8,
                    setup: bool = True):
        """File-to-file throughput mode: scan-batched device dispatch.

        Freezes controls across each batch of ``batch_blocks`` blocks and
        dispatches them as one device program (lax.scan), amortizing the
        host->device round trip. Requires the device-IO path and no logic
        modules (block-paced scripts need per-block control); falls back
        to run() otherwise. Offline only: block latency becomes
        batch_blocks * N samples.
        """
        if self.dio is None or self.conf.logic_modules or batch_blocks <= 1:
            return self.run(max_blocks, setup=setup)
        if setup:
            self.setup()
        conf = self.conf
        N = self.N
        M = batch_blocks
        t_run0 = time.perf_counter()
        # bounded: p50/p95 over the most recent ~131k blocks (a
        # multi-day realtime run must not grow a list forever)
        self._periods = collections.deque(maxlen=1 << 17)

        import queue
        wq: "queue.Queue" = queue.Queue(maxsize=2)
        wstats = {"frames": 0, "err": None}

        def writer():
            while True:
                item = wq.get()
                if item is None:
                    return
                outs, meters, nan_ok, fk = item
                try:
                    if not bool(nan_ok):
                        raise EngineError(
                            "NaN or Inf values in the system! "
                            "Invalid input?",
                            exit_code=BF_EXIT_INVALID_INPUT)
                    for di, dev in enumerate(conf.iodevs[OUT]):
                        # meters + safety abort BEFORE the device write,
                        # like write_block_dio / the reference's
                        # real2raw.h:32-42 speaker guard
                        self._account_output_meters(dev, meters[di])
                        raw = np.asarray(outs[di])
                        if self.dio.out_wire[di] == "p24":
                            raw = _expand_p24(raw)
                        if self.dio.out_wire[di] == "raw3":
                            raw = raw.reshape(-1, dev.open_channels, 3)
                        else:
                            raw = raw.reshape(-1, dev.open_channels)
                        self.devices[OUT][di].write(raw[:fk].tobytes())
                    self._peak_push()
                    wstats["frames"] += fk
                except Exception as e:
                    wstats["err"] = e
                    return

        wth = threading.Thread(target=writer, daemon=True)
        wth.start()

        # Batch producer: reads, packs, and *uploads* batch k+1 while the
        # main thread dispatches batch k (the input analog of the writer
        # thread; same rationale as _run_loop's per-block producer).
        pq: "queue.Queue" = queue.Queue(maxsize=2)
        pstate = {"stop": False, "err": None}

        def producer():
            try:
                # never read past max_blocks (over-prefetched input would
                # be drained and discarded, silently skipping samples for
                # a later run on the same engine)
                left = (None if max_blocks is None
                        else max(0, max_blocks - self.blockcounter))
                while not pstate["stop"]:
                    take = M if left is None else min(M, left)
                    if take == 0:
                        return
                    stacks = [np.zeros((M, N) + self.dio.in_wire_shape[di],
                                       self.dio.in_wire_dtype[di])
                              for di in range(len(conf.iodevs[IN]))]
                    got = 0
                    frames = take * N
                    hit_eof = False
                    for b in range(take):
                        words, f = self.read_block_dio()
                        for di in range(len(stacks)):
                            stacks[di][b] = words[di]
                        got += 1
                        if f < N:
                            frames = b * N + f
                            hit_eof = True
                            break
                    if left is not None:
                        left -= got
                    item = ([jnp.asarray(st) for st in stacks],
                            frames, got, hit_eof)
                    while not pstate["stop"]:
                        try:
                            pq.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if hit_eof:
                        return
            except Exception as e:
                pstate["err"] = e
                try:
                    pq.put_nowait(([], 0, 0, True))
                except queue.Full:
                    pass

        pth = threading.Thread(target=producer, daemon=True)
        pth.start()

        try:
            try:
                self._run_offline_batches(max_blocks, M, N, wq, wstats,
                                          pq, pstate, N / conf.sampling_rate)
            finally:
                # always stop both pipeline threads, even on an exception
                # mid-loop (run() gets this via its own try/finally)
                pstate["stop"] = True
                try:
                    while True:
                        pq.get_nowait()
                except queue.Empty:
                    pass
                pth.join(timeout=10.0)
                try:
                    wq.put(None, timeout=5.0)
                except queue.Full:
                    pass
                # patient join (see run()'s shutdown_writer): never
                # abandon a live in-flight fetch/compile
                wth.join(timeout=600.0)
        except BaseException:
            # release devices like run()'s error path: a caller that
            # catches the error and builds a new Engine must not inherit
            # still-open devices
            if setup:
                try:
                    self.teardown()
                except Exception:
                    pass
            raise

        if wstats["err"] is not None:
            if setup:
                try:
                    self.teardown()
                except Exception:
                    pass
            raise wstats["err"]
        frames_out = wstats["frames"]
        elapsed = time.perf_counter() - t_run0
        stats = {
            "blocks": self.blockcounter,
            "frames": frames_out,
            "elapsed_s": elapsed,
            "xrt": (frames_out / conf.sampling_rate) / elapsed
            if elapsed > 0 else 0.0,
            "p50_block_ms": float(np.median(np.asarray(self._periods)) * 1e3)
            if self._periods else 0.0,
            "p95_block_ms": float(np.percentile(np.asarray(self._periods), 95) * 1e3)
            if self._periods else 0.0,
            "rti_max": self._rti_max,
            "overflows": [o.n_overflows for o in self.overflow],
            "peak_db": [o.peak_db() for o in self.overflow],
        }
        if setup:
            self.teardown()
        return stats

    def _snapshot_epoch(self):
        """One control epoch for a dispatch: ctrl snapshot + mute gains +
        program-variant flags, with the dio delay lines updated from the
        SAME epoch -- ctrl and the host delay lines must agree
        (bfrun.c:1574-1601). Returns (ctrl, gains, uniform,
        uniform_delay, xfade_now)."""
        with self.control_mutex:
            ctrl = self.control.snapshot()
            gains = self._mute_gains()
            uni = self.control.snapshot_uniform
            udl = self.control.snapshot_uniform_delay
            xf = self.control.snapshot_xfade
            dly_snap = (list(self.control.delay[IN]),
                        list(self.control.delay[OUT]))
            sd_snap = (list(self.control.subdelay[IN]),
                       list(self.control.subdelay[OUT]))
        self.dio.update_delays(*dly_snap)
        self.dio.update_subdelays(*sd_snap)
        return ctrl, gains, uni, udl, xf

    def _run_offline_batches(self, max_blocks, M, N, wq, wstats, pq,
                             pstate, budget):
        import queue

        # The first dispatch pays the (possibly cold) program compile,
        # which can take minutes at the scale shape. That wait must land
        # on THIS thread, not the writer: the writer is reaped with a
        # bounded join at shutdown, and a compile longer than the join
        # timeout would report 0 frames and abandon the in-flight fetch.
        # One scalar fetch synchronizes the compile; later batches
        # stream pipelined.
        first_sync = [True]

        def sync_first(nan_ok):
            if first_sync[0]:
                first_sync[0] = False
                bool(np.asarray(nan_ok))

        eof = False
        while not self._stopped and not eof and wstats["err"] is None:
            rem = (None if max_blocks is None
                   else max_blocks - self.blockcounter)
            if rem is not None and rem <= 0:
                break
            t0 = time.perf_counter()
            dstacks, frames, got_blocks, eof = pq.get()
            if pstate["err"] is not None:
                raise pstate["err"]
            if rem is not None and rem < got_blocks:
                # a max_blocks tail shorter than the batch: finish the
                # remaining blocks one at a time (like the EOF tail)
                # instead of dropping them -- run_offline(max_blocks=K)
                # must process exactly K blocks, like run()
                got_blocks = rem
                frames = min(frames, rem * N)
            if eof or got_blocks < M or frames < M * N:
                # EOF inside the batch: finish the already-read blocks
                # one at a time so no samples are dropped. Snapshot PER
                # BLOCK like run(): a pending coeff swap must crossfade
                # only its first block (snapshot() clears the xfade mask
                # on the next call, bfrun.c:1695-1777 + prevcoeff update)
                left = frames if frames < M * N else got_blocks * N
                for b in range(got_blocks):
                    f = min(N, left - b * N)
                    if f <= 0:
                        break
                    ctrl, gains, uni, _udl, xf = self._snapshot_epoch()
                    self.state, outs1, meters1, nan1 = self.dio.step(
                        self.state, ctrl, gains[0], gains[1], self.bank,
                        [st[b] for st in dstacks], uniform=uni, xfade=xf)
                    sync_first(nan1)
                    self.blockcounter += 1
                    while wstats["err"] is None:
                        try:
                            wq.put((tuple(o[None] for o in outs1), meters1,
                                    nan1, f), timeout=1.0)
                            break
                        except queue.Full:
                            continue
                break
            ctrl, gains, uni, udl, xf = self._snapshot_epoch()
            m_left = M
            start = 0
            while xf and m_left > 0:
                # A coeff swap landed between batches (or a concurrent
                # mutation landed between snapshots -- the control API
                # is thread-safe mid-run): each crossfade applies to ONE
                # block per snapshot (the reference crossfades where
                # prevcoeff != coeff and the next snapshot clears it,
                # bfrun.c:1695-1777). Dispatch per-block xfade blocks
                # until a snapshot comes back crossfade-free, then batch
                # the rest under that SAME snapshot (ctrl and the dio
                # delay lines must come from one epoch).
                self.state, outs1, meters1, nan1 = self.dio.step(
                    self.state, ctrl, gains[0], gains[1], self.bank,
                    [st[start] for st in dstacks], uniform=uni,
                    xfade=True)
                sync_first(nan1)
                self.blockcounter += 1
                start += 1
                m_left -= 1
                while wstats["err"] is None:
                    try:
                        wq.put((tuple(o[None] for o in outs1), meters1,
                                nan1, N), timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if m_left == 0:
                    # the batch ended on an xfade block: do NOT take
                    # another snapshot here -- snapshot() advances
                    # prev_coeff, so a swap pending right now would have
                    # its crossfade epoch consumed with no block to
                    # apply it to (the next batch's snapshot picks it up
                    # and crossfades its first block instead)
                    break
                ctrl, gains, uni, udl, xf = self._snapshot_epoch()
            if m_left == M:
                mstep = self.dio.multi_step(M, uniform=uni,
                                            udelay=udl, xfade=False)
                self.state, outs, meters, nan_ok = mstep(
                    self.state, ctrl, gains[0], gains[1], self.bank,
                    dstacks)
                sync_first(nan_ok)
                self.blockcounter += M
                while wstats["err"] is None:
                    try:
                        wq.put((outs, meters, nan_ok, M * N),
                               timeout=1.0)
                        break
                    except queue.Full:
                        continue
            elif m_left > 0:
                # rare remainder after a crossfade split: reuse the
                # already-compiled per-block program under this SAME
                # epoch rather than compiling a fresh multi_step scan
                # per remainder size 1..M-1 (a cold program compile is
                # minutes at the flagship shape)
                for b in range(start, M):
                    self.state, outs1, meters1, nan1 = self.dio.step(
                        self.state, ctrl, gains[0], gains[1], self.bank,
                        [st[b] for st in dstacks], uniform=uni,
                        xfade=False)
                    sync_first(nan1)
                    self.blockcounter += 1
                    while wstats["err"] is None:
                        try:
                            wq.put((tuple(o[None] for o in outs1),
                                    meters1, nan1, N), timeout=1.0)
                            break
                        except queue.Full:
                            continue
            per = (time.perf_counter() - t0) / M
            self._periods.append(per)
            # full batches only, the offline analog of the reference's
            # full_proc rti gating (bfrun.c:1436-1445); without this the
            # stats dict reported a stale rti from a previous run()
            self.realtime_index = per / budget
            self._rti_max = max(self._rti_max, per / budget)

    def _dump_debug_timeline(self):
        """Full-ring timeline dump (print_debug, bfrun.c:230-434): one
        section per pipeline stage (the analog of the reference's
        input/filter/output process sections), each listing every retained
        period's call/ret events with microsecond offsets from the first
        retained event. The whole ring is printed -- up to 1024 periods of
        history, like the reference's DEBUG_MAX ring."""
        events = list(self._debug_ring)
        if not events:
            sys.stderr.write("debug timeline: no events recorded\n")
            return
        t0 = min(e[0] for e in events)
        sys.stderr.write(
            f"\ndebug timeline ({len(events)} events; timestamps in "
            "microseconds from first retained event):\n\n")
        for stage in ("input", "filter", "output"):
            sec = [e for e in events if e[1] == stage]
            if not sec:
                continue
            sys.stderr.write(f"{stage}_process:\n")
            last_blk = None
            for ts, _, ev, blk in sec:
                if blk != last_blk:
                    sys.stderr.write(f"  period {blk}:\n")
                    last_blk = blk
                sys.stderr.write(
                    f"    {int((ts - t0) * 1e6)}\t{ev}\n")
            sys.stderr.write("\n")

    def _print_overflow_warnings(self):
        """Per-channel clip summary (print_overflows, bfrun.c:555-587)."""
        lines = []
        for n, o in enumerate(self.overflow):
            if o.n_overflows > 0:
                lines.append(f"{n}/{o.n_overflows}/{o.peak_db():+.2f}")
        if lines:
            sys.stderr.write("Overflow warnings: " + " ".join(lines) + "\n")

    def _print_stage_table(self):
        t = self._stage_t / max(self._stage_blocks, 1) * 1e3
        sys.stderr.write(
            f"decode/ms {t[0]:9.3f} | device/ms {t[1]:9.3f} | "
            f"encode/ms {t[2]:9.3f} | total/ms {t[3]:9.3f} | "
            f"rti {self.realtime_index:6.3f}\n")
        self._stage_t[:] = 0
        self._stage_blocks = 0
