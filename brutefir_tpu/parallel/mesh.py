"""Multi-chip sharding of the block step.

The reference scales by forking filter processes and splitting filters and
channel FFTs across CPUs with pipe barriers (`bfconf.c:2227-2318`,
`bfrun.c:2311-2328`; SURVEY 2.3). The device equivalents here are
sharding annotations on one jitted program -- XLA inserts the collectives:

* **bin ("sequence") parallelism** ``sp``: the frequency-bin axis K of the
  spectra ring, coefficient bank and MAC is embarrassingly parallel
  (SURVEY 5.7); each device MACs its bin shard, one all-gather of the
  [C_out, K] output spectra precedes the inverse FFT.
* **filter parallelism** ``f``: the filter axis of the ring/MAC and of the
  mixing matrices; the output mix contracts over F, so XLA inserts a
  reduce (psum) over the ``f`` axis -- exactly the reference's constraint
  that filters mixing into one output must synchronize (bfconf.c:2893-2931).

Both compose on a 2D mesh. Batch/pipeline parallelism over *blocks* is not
meaningful for a causal single-stream convolver (block k+1 needs block k's
ring), matching the reference, whose pipeline axis is the host I/O overlap.

Cascade (from_filters) intermediates are pinned to replicated shardings:
they are tiny per-stage tensors, and letting the partitioner shard their
transforms both wastes collectives and trips an XLA:CPU fft layout
RET_CHECK on the virtual-device test backend.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.compile import CompiledGraph, StepState, StepCtrl


def make_mesh(devices=None, f_axis: int = 1, sp_axis: int = None) -> Mesh:
    """Build an ('f', 'sp') mesh over the given devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if f_axis < 1 or f_axis > n or n % f_axis != 0:
        raise ValueError(
            f"f_axis={f_axis} must be a positive divisor of the device "
            f"count ({n}); got {n} device(s). Pass fewer devices or a "
            f"compatible f_axis (e.g. f_axis=1).")
    if sp_axis is None:
        sp_axis = n // f_axis
    if f_axis * sp_axis != n:
        raise ValueError(f"mesh {f_axis}x{sp_axis} != {n} devices")
    arr = np.array(devices).reshape(f_axis, sp_axis)
    return Mesh(arr, ("f", "sp"))


def auto_mesh(n_filters: int, n_bins: int, real_dtype,
              devices=None, env=None, f_pref: int = 0):
    """Pick an ('f', 'sp') mesh for the visible devices automatically.

    The analog of the reference's default multi-CPU behavior: it forks one
    filter process per CPU and load-balances filters onto them with no
    user action (``load_balance_filters``, bfconf.c:2227-2318). Here, a
    multi-device host gets a mesh by default and XLA's partitioner does
    the balancing; the connected-filters / shared-output constraints of
    the reference (bfconf.c:2893-2931) dissolve into the psum the
    partitioner inserts over 'f'.

    Selection: the devices are joined all to all, so the mesh follows
    the algorithm alone. Prefer pure bin-parallelism (sp=n: embarrassingly
    parallel, one all-gather, no psum); take a filter axis only where the
    bins do not divide; shrink the device count only when nothing divides.
    Returns None for a single device, when disabled, or when no usable
    shape exists.

    ``env`` overrides the BRUTEFIR_TPU_MESH environment variable:
      "off"/"0"/"1"  -> single device (no mesh)
      "FxS"          -> explicit mesh axes (e.g. "2x4")
      "auto"/unset   -> heuristic above

    ``f_pref`` > 0 requests manual `filter { process: N; }` placement
    (bfconf.c:1024-1036): the 'f' axis is made as close to the process
    count as the device count allows (never larger), and the filter-count
    divisibility requirement is waived -- the engine pads the filter axis
    so every group lands on an exact shard boundary. An explicit FxS env
    setting still wins; process ids then fold onto its 'f' axis
    round-robin like the reference folds processes onto CPUs
    (bfconf.c:2304-2316).
    """
    import os

    setting = (os.environ.get("BRUTEFIR_TPU_MESH", "auto")
               if env is None else env)
    setting = (setting or "auto").strip().lower()
    if setting in ("off", "none", "0", "1"):
        return None
    if setting != "auto":
        # syntax is validated before any device query so a malformed
        # value aborts loudly even on a single-device host
        from ..errors import BFError, BF_EXIT_INVALID_CONFIG
        f_s, _, s_s = setting.partition("x")
        try:
            f = int(f_s)
            sp = int(s_s) if s_s else 0   # 0 = fill from device count
            if f < 1 or sp < 0:
                raise ValueError
        except ValueError:
            raise BFError(
                f"BRUTEFIR_TPU_MESH={setting!r}: expected 'off', 'auto', "
                "or FxS (e.g. '2x4')",
                exit_code=BF_EXIT_INVALID_CONFIG) from None
        devices = devices if devices is not None else jax.devices()
        n = len(devices)
        if sp == 0:
            sp = max(1, n // f)
        if f * sp > n:
            raise BFError(
                f"BRUTEFIR_TPU_MESH={setting!r} needs {f * sp} devices, "
                f"only {n} visible",
                exit_code=BF_EXIT_INVALID_CONFIG)
        if f * sp <= 1:
            return None
        return make_mesh(devices[: f * sp], f_axis=f, sp_axis=sp)
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n <= 1:
        return None

    def usable(f, sp, waive_filters=False):
        if not waive_filters and f > 1 and n_filters % f != 0:
            return False
        return n_bins % sp == 0

    if f_pref > 0:
        # manual placement: honor the process count on the 'f' axis as
        # closely as the device count allows. Padding (engine side)
        # guarantees filter-axis divisibility for any f, so only the
        # bin axis constrains sp: the largest f <= f_pref wins, then
        # the most devices.
        fits = [(f, total) for total in range(n, 1, -1)
                for f in range(1, min(f_pref, total) + 1)
                if total % f == 0
                and usable(f, total // f, waive_filters=True)]
        if fits:
            f, total = max(fits)
            return make_mesh(devices[:total], f_axis=f, sp_axis=total // f)
        # nothing honors the pins: fall back to the auto heuristic
        # (the engine warns that placement has no effect on f=1 meshes)

    # candidate device counts, largest first; per count, prefer sp-pure
    # then growing f
    for total in range(n, 1, -1):
        for f in range(1, total + 1):
            if total % f == 0 and usable(f, total // f):
                return make_mesh(devices[:total], f_axis=f,
                                 sp_axis=total // f)
    return None


def step_shardings(mesh: Mesh):
    """(state, ctrl, bank, x, out) sharding pytrees for the compiled step."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    ring_spec = ("f", None, None, "sp")
    state = StepState(
        prev_in=ns(),                 # [C_in, N] replicated
        ring=ns(*ring_spec),          # [F, B, 2, N] spectra ring
        eval_prev=ns(),               # [n_casc, N] replicated
        t=ns(),
    )
    ctrl = StepCtrl(
        in_mix=ns("f", None),         # [F, C_in]
        fmix=ns("f", None),           # [F, F]
        out_mix=ns(None, "f"),        # [C_out, F]
        delay=ns("f"),
        coeff_idx=ns("f"),
        mask=ns("f", None),
        prev_idx=ns("f"),
        prev_mask=ns("f", None),
        xfade=ns("f"),
        any_xfade=ns(),
        ps_thresh=ns(),
    )
    bank = ns(None, None, *ring_spec[2:])  # [E, B, 2, N]
    x = ns()                          # [C_in, N] replicated
    y = ns()                          # [C_out, N] replicated
    return state, ctrl, bank, x, y


class ShardedGraph:
    """A CompiledGraph jitted with multi-device shardings."""

    def __init__(self, cg: CompiledGraph, mesh: Mesh):
        self.cg = cg
        self.mesh = mesh
        # the Triton MAC does not partition itself: the sharded step
        # takes the dense MAC, which XLA's partitioner shards
        self.mac = "jnp"
        self.shardings = step_shardings(mesh)

        def replicate(a):
            # cascade intermediates stay replicated (see convolve_eval)
            return jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P(*([None] * a.ndim))))

        self._replicate = replicate
        self._programs = {}
        self._step = self._program(None)

    def _program(self, xfade):
        """Host-selected crossfade program variant (see _step_impl)."""
        if xfade not in self._programs:
            from ..graph.compile import _step_impl
            import functools
            st_s, ct_s, bank_s, x_s, y_s = self.shardings
            self._programs[xfade] = jax.jit(
                functools.partial(_step_impl, self.cg.spec, self.mac,
                                  constrain=self._replicate, mesh=self.mesh,
                                  xfade_now=xfade),
                in_shardings=(st_s, ct_s, bank_s, x_s),
                out_shardings=(st_s, y_s),
                donate_argnums=(0,),
            )
        return self._programs[xfade]

    def init_state(self) -> StepState:
        import jax.numpy as jnp
        s = self.cg.spec
        rd = s.real_dtype
        st = StepState(
            prev_in=jnp.zeros((s.n_inputs, s.block_length), rd),
            ring=jnp.zeros(s.ring_shape(), self.cg.ring_dtype),
            eval_prev=jnp.zeros((s.n_casc, s.block_length), rd),
            t=jnp.zeros((), jnp.int32),
        )
        st_s = self.shardings[0]
        return jax.tree.map(jax.device_put, st, st_s)

    def place(self, ctrl: StepCtrl, bank, x):
        _, ct_s, bank_s, x_s, _ = self.shardings
        return (jax.tree.map(jax.device_put, ctrl, ct_s),
                jax.device_put(bank, bank_s),
                jax.device_put(x, x_s))

    def step(self, state, ctrl, bank, x, xfade=None):
        return self._program(xfade)(state, ctrl, bank, x)
