#!/usr/bin/env python
"""Benchmark: the engine's device step and end-to-end runs on one GPU.

    python bench.py [--macs jnp,triton] [--reps 7] [--json PATH]

One process, one card. Every time is host wall clock around work that ends
in ``block_until_ready``; each number is the median of ``--reps`` samples
after warm-up. With several ``--macs`` the engines are built side by side
and sampled in turns (a, b, b, a, ...), so drift on the card hits all of
them alike. Measured:

* ``flagship``: massive_config, 26 ch x 26 filters x 131,072 taps (8192 x 16)
  with one shared coefficient set, S24_4LE -- per-block device step of the
  batched offline program (``DeviceIO.multi_step``, 8 blocks per dispatch);
* ``scale``: the same at 256 x 256 x 256 with 256 distinct coefficient sets;
* ``flagship_e2e``: ``Engine.run_offline`` file to file (/dev/zero ->
  /dev/null) as x realtime;
* ``xtc``: the 2x2 crosstalk canceller at 64 x 64 through the per-block
  ``Engine.run``: p50/p95 block period against the 1.45 ms block budget.

The JSON line printed last names platform, device kind, device count and
the card's power limit. Without a GPU the bench exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N, B, RATE, M = 8192, 16, 44100, 8


def card():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi,
            "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def build_engine(d, channels, distinct, mac):
    """A massive_config-shaped engine with seeded random taps."""
    from chip_smoke import massive_config, random_taps
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    rng = np.random.default_rng(11)
    taps = random_taps(rng, channels if distinct else 1, N * B)
    paths = []
    for i, h in enumerate(taps):
        p = os.path.join(d, f"taps{channels}_{i}.raw")
        if not os.path.exists(p):
            h.tofile(p)
        paths.append(p)
    os.environ["BRUTEFIR_TPU_MAC"] = mac
    eng = Engine(parse_config(massive_config(
        "/dev/zero", "/dev/null", paths, channels, N, B)))
    assert eng.dio is not None and eng.cg.mac == mac
    return eng


class StepTimer:
    """Per-block device step of the batched offline program on staged
    random input words."""

    def __init__(self, eng):
        import jax
        import jax.numpy as jnp
        self.eng = eng
        with eng.control_mutex:
            self.ctrl = eng.control.snapshot()
            self.gains = eng._mute_gains()
            uni = eng.control.snapshot_uniform
            udl = eng.control.snapshot_uniform_delay
        self.mstep = eng.dio.multi_step(M, uniform=uni, udelay=udl,
                                        xfade=False)
        rng = np.random.default_rng(12)
        self.words = [jnp.asarray(rng.integers(
            0, 256, (M, N) + eng.dio.in_wire_shape[i]).astype(
                eng.dio.in_wire_dtype[i]))
            for i in range(len(eng.dio.in_wire_shape))]
        for _ in range(2):                    # compile + warm
            self.sample(1)
        self.jax = jax

    def sample(self, k=4):
        import jax
        eng = self.eng
        t0 = time.perf_counter()
        for _ in range(k):
            eng.state, outs, meters, nan = self.mstep(
                eng.state, self.ctrl, self.gains[0], self.gains[1],
                eng.bank, self.words)
        jax.block_until_ready((eng.state, outs, meters, nan))
        return (time.perf_counter() - t0) / (k * M) * 1e3


def step_cells(d, macs, reps):
    """flagship and scale device steps for each MAC, sampled in turns."""
    out = {}
    for name, channels, distinct in (("flagship", 26, False),
                                     ("scale", 256, True)):
        timers = {mac: StepTimer(build_engine(d, channels, distinct, mac))
                  for mac in macs}
        samples = {mac: [] for mac in macs}
        order = list(macs)
        for r in range(reps):
            for mac in (order if r % 2 == 0 else order[::-1]):
                samples[mac].append(timers[mac].sample())
        for mac in macs:
            ms = float(np.median(samples[mac]))
            out[f"{name}_{mac}"] = {
                "device_step_ms": ms,
                "samples_ms": samples[mac],
                "xrt": (N / RATE * 1e3) / ms,
                "shape": f"{channels}ch x {channels} filters x {N * B} taps,"
                         f" {'256 distinct' if distinct else 'one shared'}"
                         " coefficient set(s)",
            }
        del timers
    return out


def mac_fusions(d, hlo_dir):
    """What XLA makes of the dense MAC at both shapes: the fusions of the
    compiled HLO (full text written under ``hlo_dir``)."""
    import jax
    import jax.numpy as jnp
    from brutefir_tpu.ops import partconv
    rec = {}
    for name, F, E, fn in (("flagship_uniform", 26, 1,
                            partconv.spectral_mac_uniform),
                           ("scale_distinct", 256, 256,
                            partconv.spectral_mac_rollh)):
        args = (jax.ShapeDtypeStruct((F, B, 2, N), jnp.float32),
                jax.ShapeDtypeStruct((E, B, 2, N), jnp.float32),
                jax.ShapeDtypeStruct((F,), jnp.int32),
                jax.ShapeDtypeStruct((F, B), jnp.float32),
                jax.ShapeDtypeStruct((), jnp.int32))
        text = jax.jit(fn).lower(*args).compile().as_text()
        if hlo_dir:
            os.makedirs(hlo_dir, exist_ok=True)
            with open(os.path.join(hlo_dir, f"mac_{name}.hlo.txt"),
                      "w") as fh:
                fh.write(text)
        fusions = sorted({ln.split("=")[0].split()[-1].lstrip("%")
                          for ln in text.splitlines()
                          if "fusion(" in ln and "ENTRY" not in ln
                          and "=" in ln})
        rec[name] = fusions
    return rec


def flagship_e2e(d, reps):
    from chip_smoke import massive_config, random_taps
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    tapf = os.path.join(d, "e2e_taps.raw")
    random_taps(np.random.default_rng(13), 1, N * B)[0].tofile(tapf)
    os.environ["BRUTEFIR_TPU_MAC"] = "auto"
    eng = Engine(parse_config(massive_config(
        "/dev/zero", "/dev/null", [tapf], 26, N, B)))
    eng.setup()
    blocks = 30 * M
    eng.run_offline(max_blocks=2 * M, batch_blocks=M, setup=False)
    xrts = []
    done = 2 * M
    for _ in range(reps):
        done += blocks
        st = eng.run_offline(max_blocks=done, batch_blocks=M, setup=False)
        xrts.append(st["xrt"])
    eng.teardown()
    return {"xrt": float(np.median(xrts)), "samples_xrt": xrts,
            "blocks_per_sample": blocks}


XTC = """
sampling_rate: 44100;
filter_length: 64,64;
coeff 0 { filename: "dirac pulse"; };
coeff 1 { filename: "dirac pulse"; };
input 0,1 { device: "file" { path: "/dev/zero"; }; sample: "S24_4LE"; channels: 2; };
output 0,1 { device: "file" { path: "/dev/null"; }; sample: "S24_4LE"; channels: 2; dither: false; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
filter 1 { from_inputs: 1; to_outputs: 0/0.0; coeff: 1; };
filter 2 { from_inputs: 1; to_outputs: 1; coeff: 0; };
filter 3 { from_inputs: 0; to_outputs: 1/0.0; coeff: 1; };
"""


def xtc_latency(blocks=500):
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    os.environ["BRUTEFIR_TPU_MAC"] = "auto"
    eng = Engine(parse_config(XTC))
    eng.setup()
    eng.run(max_blocks=30, setup=False)
    st = eng.run(max_blocks=30 + blocks, setup=False)
    eng.teardown()
    budget = 64 / RATE * 1e3
    return {"p50_block_ms": st["p50_block_ms"],
            "p95_block_ms": st["p95_block_ms"],
            "block_budget_ms": budget,
            "rti_p50": st["p50_block_ms"] / budget,
            "rti_p95": st["p95_block_ms"] / budget, "blocks": blocks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--macs", default="jnp",
                    help="comma-separated MACs to time in turns")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--json", help="also write the result here")
    ap.add_argument("--hlo-dir", help="write the dense MAC's HLO here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = card()
    from brutefir_tpu.runtime.compile_cache import configure_compile_cache
    dev["compile_cache"] = configure_compile_cache()
    macs = args.macs.split(",")
    with tempfile.TemporaryDirectory() as d:
        cells = step_cells(d, macs, args.reps)
        cells["mac_fusions"] = mac_fusions(d, args.hlo_dir)
        cells["flagship_e2e"] = flagship_e2e(d, args.reps)
        cells["xtc"] = xtc_latency()
    res = {"device": dev, "cells": cells}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
