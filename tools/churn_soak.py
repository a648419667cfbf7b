#!/usr/bin/env python
"""Hardware churn soak: long run under continuous control mutation.

Drives the per-block device step for CHURN_BLOCKS blocks (default 2000,
~125 ring wraps at B=16) while a seeded RNG mutates the control state
every block the way a live CLI/EQ session would: coefficient swaps on a
crossfade-enabled filter (exercising the host-selected crossfade
program), mutes, output delay changes, filter pre-delay
changes. Asserts every fetched meter is finite, then runs the whole
thing TWICE with the same seed and asserts the accumulated output
checksum is bit-identical -- the engine must be deterministic under
control churn (the reference's block-deterministic CLI script contract,
bflogic_cli.c script mode).

Run on the GPU: python tools/churn_soak.py [blocks]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

BLOCKS = int(sys.argv[1]) if len(sys.argv) > 1 else \
    int(os.environ.get("CHURN_BLOCKS", "2000"))
N, B, CH = 4096, 16, 8
SEED = 1234


def build_config():
    import tempfile
    d = tempfile.mkdtemp()
    rng = np.random.RandomState(7)
    coeff_blocks = []
    for i, ntaps in enumerate((N * 2, N, 64)):   # multi-block, 1, partial
        taps = (rng.randn(ntaps) * 0.05).astype(np.float32)
        path = os.path.join(d, f"t{i}.txt")
        with open(path, "w") as f:
            f.write("\n".join(repr(float(v)) for v in taps))
        coeff_blocks.append(
            f'coeff {i} {{ filename: "{path}"; format: "TEXT"; '
            f'attenuation: {6.0 * i}; }};')
    return f"""
sampling_rate: 44100;
filter_length: {N},{B};
benchmark: true;
""" + "\n".join(coeff_blocks) + f"""
input {",".join(str(i) for i in range(CH))} {{
    device: "file" {{ path: "/dev/zero"; }};
    sample: "S24_4LE"; channels: {CH}; maxdelay: 64;
}};
output {",".join(str(i) for i in range(CH))} {{
    device: "file" {{ path: "/dev/null"; }};
    sample: "S24_4LE"; channels: {CH}; dither: false; maxdelay: 64;
}};
""" + "\n".join(
        f"filter {i} {{ from_inputs: {i}; to_outputs: {i}; coeff: {i % 3}; "
        f"crossfade: true; }};"
        for i in range(CH))


CONFIG = build_config()


def run_once(eng_cls, parse_config, jnp, jax):
    conf = parse_config(CONFIG)
    eng = eng_cls(conf)
    eng.setup()
    assert eng.dio is not None
    rng = np.random.RandomState(SEED)
    words = (rng.randint(-2**20, 2**20, (1, N, CH, 3)) & 0xFF).astype(
        np.uint8)
    w = [jnp.asarray(words[0])]
    acc = jnp.float32(0.0)

    @jax.jit
    def fold(acc, outs, meters):
        s = sum(jnp.sum(o.astype(jnp.float32)) for o in outs)
        m = sum(jnp.sum(mt) for mt in meters)
        return acc * 0.5 + s * 1e-9 + m * 1e-6

    t0 = time.perf_counter()
    for k in range(BLOCKS):
        with eng.control_mutex:
            op = rng.randint(0, 5)
            if op == 0:
                eng.control.change_coeff(rng.randint(CH), rng.randint(3))
            elif op == 1:
                eng.control.set_mute(rng.randint(2), rng.randint(CH),
                                     bool(rng.randint(2)))
            elif op == 2:
                eng.control.set_delay(1, rng.randint(CH), rng.randint(64))
            elif op == 3:
                eng.control.change_filter_delay(rng.randint(CH),
                                                rng.randint(3))
            # op == 4: no change this block
            c = eng.control.snapshot()
            g = eng._mute_gains()
        eng.state, outs, meters, nan = eng.dio.step(
            eng.state, c, g[0], g[1], eng.bank, w)
        acc = fold(acc, outs, meters)
        if (k + 1) % 500 == 0:
            a = float(np.asarray(acc))
            assert np.isfinite(a), f"non-finite checksum at block {k}"
            rate = (k + 1) / (time.perf_counter() - t0)
            print(f"  block {k+1}/{BLOCKS}: checksum {a:.6e}, "
                  f"{rate:.0f} blocks/s", flush=True)
    final = float(np.asarray(acc))
    eng.teardown()
    assert np.isfinite(final)
    return final, time.perf_counter() - t0


def main():
    import jax
    import jax.numpy as jnp
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime.engine import Engine

    print(f"churn soak: {BLOCKS} blocks ({BLOCKS // B} ring wraps), "
          f"{CH}ch x {N}x{B}, backend {jax.default_backend()}")
    c1, t1 = run_once(Engine, parse_config, jnp, jax)
    c2, t2 = run_once(Engine, parse_config, jnp, jax)
    print(f"run 1: checksum {c1!r}  ({t1:.1f}s)")
    print(f"run 2: checksum {c2!r}  ({t2:.1f}s)")
    if c1 != c2:
        print("FAIL: nondeterministic under identical control churn")
        return 1
    print(f"PASS: {2 * BLOCKS} blocks, deterministic, all finite "
          f"({2 * BLOCKS * N / 44100:.0f}s of audio)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
