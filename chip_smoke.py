#!/usr/bin/env python
"""On-card smoke test: the engine's main paths on one GPU, checked.

    python chip_smoke.py           # phases (a)-(h) on one card
    python chip_smoke.py --four    # the sharded path on four cards only

Every phase runs the engine through the entry points a user calls (the CLI,
``Engine.run_offline``, ``Engine.run``) at the shapes upstream documents,
compares the output with an independent float64 numpy/scipy oracle, and
prints one line: phase name, max error, tolerance, unit and wall time. A
phase outside its tolerance, or any exception, ends the run with a non-zero
exit. The last line of a passing run is a JSON object naming the device.

Tolerances, with their reasons:

* audio outputs (S24): ``FLOAT32_REL * peak + 4`` LSB. The engine computes
  in float32 (24-bit mantissa, unit roundoff 6e-8): a 2N-point forward FFT,
  a B-partition MAC and a 2N-point inverse FFT each add rounding of order
  log2(2N) * 6e-8 relative to the signal's full scale, about 3e-6 for
  N = 8192; 8e-6 leaves margin for cuFFT's and XLA:CPU's different
  rounding. The 4 LSB cover the final rounding to integers and the
  +-1 LSB triangular dither where a config enables it.
* the MAC alone: the classic bound for a float32 sum of n products,
  ``(n + 1) * 2^-24 * sum(|terms|)`` per element (n = 2B terms per output
  plane), checked element by element. It holds for any summation order.
* ``float_bits: 64``: ``1e-10 * peak`` -- float64 FFTs are accurate to
  ~1e-14 relative; a float32 path would miss by four orders of magnitude.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FLOAT32_REL = 8e-6
RATE = 44100
S24_AMP = 1 << 20      # input amplitude: the outputs stay far below 2^23
TAP_SCALE = 0.003      # uniform taps in +-0.003: output peak ~ 2^21


# --------------------------------------------------------------------------
# configs and data (seeded; shared with the CPU tests of this script)

def write_s24_4le(path, rows):
    """[C, n] int -> interleaved S24_4LE file."""
    np.ascontiguousarray(np.asarray(rows).T.astype("<i4")).tofile(path)


def read_s24_4le(path, channels):
    return np.fromfile(path, dtype="<i4").reshape(-1, channels).T


def random_s24(rng, channels, n):
    return rng.integers(-S24_AMP, S24_AMP, (channels, n)).astype(np.int32)


def random_taps(rng, count, n):
    return (rng.uniform(-1.0, 1.0, (count, n)) * TAP_SCALE).astype(
        np.float32)


def massive_config(inp, out, coeff_paths, channels, N, B):
    """massive_config's graph at any width: filter i maps input i to
    output i. One coefficient file shared by every filter (the flagship)
    or one per filter (the scale shape's distinct sets)."""
    lines = [f"sampling_rate: {RATE};", f"filter_length: {N},{B};",
             "show_progress: false;"]
    for i, p in enumerate(coeff_paths):
        lines.append(f'coeff {i} {{ filename: "{p}"; format: "FLOAT_LE"; }};')
    chans = ",".join(str(i) for i in range(channels))
    lines.append(f'input {chans} {{ device: "file" {{ path: "{inp}"; }}; '
                 f'sample: "S24_4LE"; channels: {channels}; }};')
    lines.append(f'output {chans} {{ device: "file" {{ path: "{out}"; }}; '
                 f'sample: "S24_4LE"; channels: {channels}; dither: false; }};')
    shared = len(coeff_paths) == 1
    for i in range(channels):
        c = 0 if shared else i
        lines.append(f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; "
                     f"coeff: {c}; }};")
    return "\n".join(lines) + "\n"


def mixed_config(d, inp, out, N=4096, B=4, K=8, swap_block=4):
    """Gains, polarity, a one-block pre-delay, a fan-in output and a
    coefficient swap with crossfade on filter 2 at ``swap_block`` (driven
    by the CLI script, one line per block)."""
    rng = np.random.default_rng(7)
    tapf = os.path.join(d, "t.raw")
    random_taps(rng, 1, N * 2)[0].tofile(tapf)
    script = f"sleep b{swap_block - 1};\\ncfc 2 0; sleep b{10 * K};"
    return f"""
sampling_rate: {RATE};
filter_length: {N},{B};
coeff 0 {{ filename: "{tapf}"; format: "FLOAT_LE"; attenuation: 6.0; }};
coeff 1 {{ filename: "dirac pulse"; }};
input 0,1,2,3 {{ device: "file" {{ path: "{inp}"; }}; sample: "S24_4LE"; channels: 4; }};
output 0,1,2,3 {{ device: "file" {{ path: "{out}"; }}; sample: "S24_4LE"; channels: 4; dither: false; }};
filter 0 {{ from_inputs: 0/3; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1//-1; coeff: 1; delay: 1; }};
filter 2 {{ from_inputs: 2, 3/6; to_outputs: 2; coeff: 1; crossfade: true; }};
filter 3 {{ from_inputs: 3; to_outputs: 3, 2/12; coeff: 1; }};
logic: "cli" {{ script: "{script}"; echo: false; }};
"""


def xtc_config(example_text, direct, cross, inp, out):
    """examples/xtc_lowlatency.conf with its file paths filled in."""
    return (example_text.replace('"direct.txt"', f'"{direct}"')
            .replace('"cross.txt"', f'"{cross}"')
            .replace('"input.f32"', f'"{inp}"')
            .replace('"output.s24"', f'"{out}"'))


def read_s24_3le(path, channels):
    raw = np.fromfile(path, np.uint8).reshape(-1, channels, 3)
    v = (raw[..., 0].astype(np.int32) | (raw[..., 1].astype(np.int32) << 8)
         | (raw[..., 2].astype(np.int32) << 16))
    return (v - ((v & 0x800000) << 1)).T


# --------------------------------------------------------------------------
# oracles

def conv64(x, h):
    """float64 linear convolution, truncated to len(x)."""
    import scipy.signal
    return scipy.signal.fftconvolve(np.asarray(x, np.float64),
                                    np.asarray(h, np.float64))[: len(x)]


def s24_tolerance(ref):
    return FLOAT32_REL * float(np.abs(ref).max()) + 4.0


def mac_oracle(ring, bank, coeff_idx, mask, t):
    """float64 partitioned MAC with packed bin 0, plus the per-element
    float32 error bound (see module docstring). Returns (Y, bound)."""
    F, B = ring.shape[:2]
    hpos = (t - np.arange(B)) % B
    H = (bank[coeff_idx[:, None], hpos[None, :]].astype(np.float64)
         * mask[:, hpos][:, :, None, None])
    r = ring.astype(np.float64)
    rr, ri, hr, hi = r[:, :, 0], r[:, :, 1], H[:, :, 0], H[:, :, 1]
    yr = np.sum(rr * hr - ri * hi, axis=1)
    yi = np.sum(rr * hi + ri * hr, axis=1)
    sr = np.sum(np.abs(rr * hr) + np.abs(ri * hi), axis=1)
    si = np.sum(np.abs(rr * hi) + np.abs(ri * hr), axis=1)
    yr[:, 0] = np.sum(rr[..., 0] * hr[..., 0], axis=1)
    yi[:, 0] = np.sum(ri[..., 0] * hi[..., 0], axis=1)
    sr[:, 0] = np.sum(np.abs(rr[..., 0] * hr[..., 0]), axis=1)
    si[:, 0] = np.sum(np.abs(ri[..., 0] * hi[..., 0]), axis=1)
    u = 2.0 ** -24
    bound = (2 * B + 1) * u * np.stack([sr, si], axis=1)
    return np.stack([yr, yi], axis=1), bound


def last_line(platform, kind, count):
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


# --------------------------------------------------------------------------
# phases: each returns (max_err, tol, unit)

def _run_cli(cfg_text, d):
    from brutefir_tpu.__main__ import main as cli_main
    cfg = os.path.join(d, "flagship.conf")
    with open(cfg, "w") as fh:
        fh.write(cfg_text)
    rc = cli_main(["-quiet", "-nodefault", cfg])
    if rc != 0:
        raise RuntimeError(f"CLI exited {rc}")


def _audio_check(x, taps_for, y, channels):
    err = tol = 0.0
    for c in channels:
        ref = conv64(x[c], taps_for(c))
        err = max(err, float(np.abs(y[c] - ref).max()))
        tol = max(tol, s24_tolerance(ref))
    return err, tol


def phase_flagship(d, channels=26, N=8192, B=16, blocks=48,
                   check=(0, 9, 17, 25)):
    """(b) massive_config through the CLI, in-process."""
    rng = np.random.default_rng(1)
    taps = random_taps(rng, 1, N * B)[0]
    x = random_s24(rng, channels, N * blocks)
    inp, out, tapf = (os.path.join(d, n) for n in
                      ("fl_in.raw", "fl_out.raw", "fl_taps.raw"))
    write_s24_4le(inp, x)
    taps.tofile(tapf)
    _run_cli(massive_config(inp, out, [tapf], channels, N, B), d)
    y = read_s24_4le(out, channels)
    if y.shape != x.shape:
        raise RuntimeError(f"output shape {y.shape} != {x.shape}")
    return _audio_check(x, lambda c: taps, y, check) + ("LSB",)


def _scale_files(d, channels, N, B, blocks, tag):
    rng = np.random.default_rng(2)
    taps = random_taps(rng, channels, N * B)
    paths = []
    for i in range(channels):
        p = os.path.join(d, f"{tag}_taps{i}.raw")
        taps[i].tofile(p)
        paths.append(p)
    x = random_s24(rng, channels, N * blocks)
    inp = os.path.join(d, f"{tag}_in.raw")
    write_s24_4le(inp, x)
    return taps, paths, x, inp


def run_offline_config(cfg_text, batch=8):
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    eng = Engine(parse_config(cfg_text))
    eng.run_offline(batch_blocks=batch)
    return eng


def phase_scale(d, channels=256, N=8192, B=16, blocks=16,
                check=(0, 85, 170, 255), show_memory=True):
    """(c) 256 x 256 x 256 with 256 distinct sets, Engine.run_offline."""
    import jax
    import jax.numpy as jnp
    taps, paths, x, inp = _scale_files(d, channels, N, B, blocks, "sc")
    out = os.path.join(d, "sc_out.raw")
    eng = run_offline_config(massive_config(inp, out, paths, channels, N, B))
    if show_memory:
        ctrl = jax.tree_util.tree_map(jnp.asarray, eng.control.snapshot())
        xb = jnp.zeros((channels, N), eng.rd)
        st = eng.cg.init_state()
        comp = eng.cg._program(False, False).lower(
            st, ctrl, eng.bank, xb).compile()
        print(f"  scale step memory_analysis: {comp.memory_analysis()}")
    del eng
    gc.collect()
    y = read_s24_4le(out, channels)
    return _audio_check(x, lambda c: taps[c], y, check) + ("LSB",)


def _cpu_child(cfg_path):
    """Run a config file-to-file on the CPU (a child process that never
    opens the card)."""
    from brutefir_tpu.config import parse_config_file
    from brutefir_tpu.runtime import Engine
    Engine(parse_config_file(cfg_path)).run()


def phase_mixed(d, N=4096, B=4, K=8):
    """(d) gains/polarity/pre-delay/fan-in + a live crossfade, card vs a
    CPU child process running the same config."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    rng = np.random.default_rng(3)
    x = random_s24(rng, 4, N * K) // 4
    inp = os.path.join(d, "mx_in.raw")
    write_s24_4le(inp, x)
    out_cpu, out_dev = (os.path.join(d, n) for n in ("mx_cpu.raw",
                                                      "mx_dev.raw"))
    cfg = os.path.join(d, "mixed.conf")
    with open(cfg, "w") as fh:
        fh.write(mixed_config(d, inp, out_cpu, N, B, K))
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--cpu-child", cfg], env=env, check=True)
    Engine(parse_config(mixed_config(d, inp, out_dev, N, B, K))).run()
    a, b = read_s24_4le(out_cpu, 4), read_s24_4le(out_dev, 4)
    if a.shape != b.shape or a.shape[1] != N * K:
        raise RuntimeError(f"shapes {a.shape} {b.shape}")
    err = float(np.abs(a.astype(np.int64) - b).max())
    # each side is within s24_tolerance of the exact result
    tol = 2 * s24_tolerance(a)
    return err, tol, "LSB"


def phase_mac(widths=((26, 1, 16, 8192), (256, 256, 16, 8192)),
              kernels=("dense", "triton")):
    """(e) the MAC kernels against the float64 oracle at real widths.
    ``widths``: (filters, bank entries, partitions, bins)."""
    import jax.numpy as jnp
    from brutefir_tpu.ops import partconv
    fns = {"dense": partconv.spectral_mac_rollh,
           "dense_uniform": partconv.spectral_mac_uniform}
    if "triton" in kernels:
        from brutefir_tpu.ops.triton_mac import triton_spectral_mac
        fns["triton"] = triton_spectral_mac
    rng = np.random.default_rng(4)
    worst = 0.0
    for F, E, B, K in widths:
        ring = rng.standard_normal((F, B, 2, K)).astype(np.float32)
        bank = rng.standard_normal((E, B, 2, K)).astype(np.float32)
        idx = (np.arange(F) % E).astype(np.int32)
        mrow = (rng.uniform(size=B) > 0.2).astype(np.float32)
        mask = np.tile(mrow, (F, 1))
        t = int(rng.integers(0, 10 * B))
        ref, bound = mac_oracle(ring, bank, idx, mask, t)
        names = [k for k in kernels if k in fns]
        if E == 1:
            names.append("dense_uniform")
        for name in names:
            got = np.asarray(fns[name](
                jnp.asarray(ring), jnp.asarray(bank), jnp.asarray(idx),
                jnp.asarray(mask), jnp.int32(t)), np.float64)
            err = np.abs(got - ref)
            ratio = float((err / np.maximum(bound, 1e-30)).max())
            print(f"  mac {name} F={F} E={E} B={B} K={K}: max |err| "
                  f"{err.max():.3e}, worst err/bound {ratio:.3f}")
            worst = max(worst, ratio)
    return worst, 1.0, "x bound"


def phase_xtc(d, example, blocks=300):
    """(f) examples/xtc_lowlatency.conf through the per-block Engine.run."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    rng = np.random.default_rng(5)
    N, B = 64, 64
    taps = random_taps(rng, 2, N * B) * 10.0
    direct, cross, inp, out = (os.path.join(d, n) for n in (
        "direct.txt", "cross.txt", "xtc_in.f32", "xtc_out.s24"))
    for p, h in ((direct, taps[0]), (cross, taps[1])):
        with open(p, "w") as fh:
            fh.write("\n".join(repr(float(v)) for v in h))
    x = (rng.uniform(-0.25, 0.25, (2, N * blocks))).astype(np.float32)
    np.ascontiguousarray(x.T).astype("<f4").tofile(inp)
    with open(example) as fh:
        text = xtc_config(fh.read(), direct, cross, inp, out)
    eng = Engine(parse_config(text))
    stats = eng.run()
    print(f"  xtc per-block run: {stats['blocks']} blocks, p50 "
          f"{stats['p50_block_ms']:.3f} ms, p95 {stats['p95_block_ms']:.3f}"
          f" ms (budget {N / RATE * 1e3:.3f} ms)")
    y = read_s24_3le(out, 2).astype(np.float64)
    s = float(1 << 23)
    el = (conv64(x[0], taps[0]) + conv64(x[1], taps[1])) * s
    er = (conv64(x[1], taps[0]) + conv64(x[0], taps[1])) * s
    err = max(float(np.abs(y[0] - el).max()), float(np.abs(y[1] - er).max()))
    return err, max(s24_tolerance(el), s24_tolerance(er)), "LSB"


def phase_float64(d, N=1024, B=4, blocks=12):
    """(g) float_bits: 64 against the float64 oracle."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    rng = np.random.default_rng(6)
    taps = rng.uniform(-0.05, 0.05, N * B)
    x = rng.uniform(-0.5, 0.5, (2, N * blocks))
    taps *= 0.2                        # float outputs stay below 0 dBFS
    tapf, inp, out = (os.path.join(d, n) for n in
                      ("f64_taps.raw", "f64_in.raw", "f64_out.raw"))
    taps.astype("<f8").tofile(tapf)
    np.ascontiguousarray(x.T).astype("<f8").tofile(inp)
    Engine(parse_config(f"""
float_bits: 64;
sampling_rate: {RATE};
filter_length: {N},{B};
coeff 0 {{ filename: "{tapf}"; format: "FLOAT64_LE"; }};
input 0,1 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT64_LE"; channels: 2; }};
output 0,1 {{ device: "file" {{ path: "{out}"; }}; sample: "FLOAT64_LE"; channels: 2; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
filter 1 {{ from_inputs: 1; to_outputs: 1; coeff: 0; }};
""")).run()
    y = np.fromfile(out, "<f8").reshape(-1, 2).T
    ref = np.stack([conv64(x[c], taps) for c in range(2)])
    return (float(np.abs(y - ref).max()), 1e-10 * float(np.abs(ref).max()),
            "abs")


def phase_hook(d, N=64, blocks=3):
    """(h) an output_freqd hook (io_callback) that doubles the spectrum."""
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(N * blocks) * 0.1).astype(np.float32)
    inp, out = os.path.join(d, "hk_in.f32"), os.path.join(d, "hk_out.f32")
    x.astype("<f4").tofile(inp)
    eng = Engine(parse_config(f"""
sampling_rate: {RATE};
filter_length: {N},1;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{out}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
"""))

    class Doubler:
        def output_freqd(self, buf, ch):
            buf *= 2.0

    eng.logic.append(Doubler())
    eng.run()
    y = np.fromfile(out, "<f4")
    # float32 round trip through a 128-point transform pair
    return float(np.abs(y - 2.0 * x).max()), 1e-5, "abs"


def phase_four(d, which, N=8192, B=16, channels=None, blocks=None):
    """--four: flagship and scale through Engine on the auto-mesh over the
    visible cards vs one card (BRUTEFIR_TPU_MESH=off) vs the oracle."""
    flagship = which == "flagship"
    C = channels or (26 if flagship else 256)
    blocks = blocks or (48 if flagship else 16)
    if flagship:
        rng = np.random.default_rng(1)
        taps_all = random_taps(rng, 1, N * B)
        x = random_s24(rng, C, N * blocks)
        inp = os.path.join(d, "f4_in.raw")
        write_s24_4le(inp, x)
        paths = [os.path.join(d, "f4_taps.raw")]
        taps_all[0].tofile(paths[0])
    else:
        taps_all, paths, x, inp = _scale_files(d, C, N, B, blocks, "s4")
    check = sorted({0, C // 3, 2 * C // 3, C - 1})
    outs = {}
    prior = os.environ.get("BRUTEFIR_TPU_MESH")
    for mode in ("auto", "off"):
        os.environ["BRUTEFIR_TPU_MESH"] = mode
        out = os.path.join(d, f"{which}_{mode}.raw")
        eng = run_offline_config(massive_config(inp, out, paths, C, N, B))
        shape = (None if eng.mesh is None else
                 f"f={eng.mesh.shape['f']} x sp={eng.mesh.shape['sp']}")
        print(f"  {which} mesh={mode}: {shape}")
        if mode == "auto" and eng.mesh is None:
            raise RuntimeError("auto mode built no mesh")
        del eng
        gc.collect()
        outs[mode] = read_s24_4le(out, C)
    if prior is None:
        os.environ.pop("BRUTEFIR_TPU_MESH")
    else:
        os.environ["BRUTEFIR_TPU_MESH"] = prior
    diff = float(np.abs(outs["auto"].astype(np.int64) - outs["off"]).max())
    print(f"  {which} sharded vs single card: max |diff| {diff:.0f} LSB")
    err, tol = _audio_check(x, lambda c: taps_all[c % len(taps_all)],
                            outs["auto"], check)
    return max(err, diff), tol, "LSB"


# --------------------------------------------------------------------------

def run_phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    err, tol, unit = fn(*args, **kw)
    wall = time.perf_counter() - t0
    ok = err <= tol
    print(f"phase {name}: max_err {err:.6g} {unit}, tol {tol:.6g} {unit}, "
          f"wall {wall:.1f} s, {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        sys.exit(1)


def device_report():
    """(a) the device, or exit non-zero when JAX finds no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        sys.exit(2)
    from brutefir_tpu.runtime.compile_cache import configure_compile_cache
    cache = configure_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"phase device: {devs[0].device_kind} x {len(devs)}; jax "
          f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r};"
          f" compile cache {cache}")
    print(smi, flush=True)
    return devs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded path on four cards")
    ap.add_argument("--cpu-child", metavar="CONF", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_child:
        _cpu_child(args.cpu_child)
        return 0
    devs = device_report()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=repo, prefix=".smoke_") as d:
        if args.four:
            if len(devs) < 4:
                raise SystemExit(f"--four needs 4 cards, found {len(devs)}")
            run_phase("four_flagship", phase_four, d, "flagship")
            run_phase("four_scale", phase_four, d, "scale")
        else:
            run_phase("flagship_cli", phase_flagship, d)
            run_phase("scale_run_offline", phase_scale, d)
            run_phase("mixed_crossfade_vs_cpu", phase_mixed, d)
            run_phase("mac_kernels", phase_mac)
            run_phase("xtc_per_block", phase_xtc, d, os.path.join(
                repo, "examples", "xtc_lowlatency.conf"))
            run_phase("freqd_hook", phase_hook, d)
            run_phase("float64", phase_float64, d)
    print(last_line(devs[0].platform, devs[0].device_kind, len(devs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
