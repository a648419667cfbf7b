"""Regression tests for the round-3 sound-backend/__main__/graph findings."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from brutefir_tpu.config import parse_config
from brutefir_tpu.config.lexer import tokenize


def _params(text):
    # module parameter token list, as the config parser hands it over
    # (the captured device block excludes the trailing EOF)
    from brutefir_tpu.config.lexer import T
    return [t for t in tokenize(text) if t.kind != T.EOF]


def _run_cli(args, timeout=120, extra_env=None):
    """Run `python -m brutefir_tpu <args>` forced onto the CPU backend.

    The subprocess sets jax.config before the module runs -- same
    pattern as test_main_cli.test_init_error_exit_code -- so it never
    opens an accelerator, whatever the environment says.
    """
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            f"sys.argv = ['brutefir_tpu'] + {args!r}; "
            "import runpy; runpy.run_module('brutefir_tpu', "
            "run_name='__main__')")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + ":" + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_jack_ports_reference_syntax_parses():
    """ports: '"dest"/"local", ...' -- one entry per open channel with
    optional SLASH-mapped local names (bfio_jack.c:330-353)."""
    from brutefir_tpu.io.sound_backends import JackDevice
    params = _params(
        'clientname: "bf"; '
        'ports: "system:playback_1"/"left", "system:playback_2"/"right";')
    dev = JackDevice.__new__(JackDevice)
    # run only the parse part of __init__ via the real constructor
    from brutefir_tpu.core.sampleformat import parse_sample_format
    dev = JackDevice(params, 1, parse_sample_format("FLOAT_NE"), 44100, 2)
    assert dev._clientname == "bf"
    assert dev._connect == ["system:playback_1", "system:playback_2"]
    assert dev._portnames == ["left", "right"]


def test_jack_ports_without_local_names():
    from brutefir_tpu.io.sound_backends import JackDevice
    from brutefir_tpu.core.sampleformat import parse_sample_format
    params = _params('ports: "a", "";')
    dev = JackDevice(params, 0, parse_sample_format("FLOAT_NE"), 44100, 2)
    assert dev._connect == ["a", None]
    assert dev._portnames == [None, None]


def test_deep_cascade_chain_no_recursion_error():
    """A 1500-deep from_filters chain must build its stages iteratively
    (the recursive depth computation overflowed Python's stack; the
    config layer caps filters at 256, but the graph layer's contract is
    any DAG)."""
    from brutefir_tpu.graph.spec import build_graph_spec
    n = 1500
    filter_inputs = [[] if f == 0 else [f - 1] for f in range(n)]
    spec = build_graph_spec(
        block_length=64, n_blocks=2, n_inputs=1, n_outputs=1,
        filter_inputs=filter_inputs, crossfade_flags=[False] * n)
    assert len(spec.stages) == n


def test_deep_cascade_chain_parser_level(tmp_path):
    n = 250  # BF_MAXFILTERS caps the config layer
    blocks = ['filter "f0" { from_inputs: 0; to_filters: "f1"; coeff: -1; };']
    for i in range(1, n):
        out = (f'to_filters: "f{i + 1}";' if i + 1 < n else "to_outputs: 0;")
        blocks.append(f'filter "f{i}" {{ from_filters: "f{i - 1}"; '
                      f"{out} coeff: -1; }};")
    cfg = f"""
sampling_rate: 44100;
filter_length: 64,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "/dev/zero"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "/dev/null"; }}; sample: "FLOAT_LE"; channels: 1; }};
""" + "\n".join(blocks)
    conf = parse_config(cfg)
    assert len(conf.filters) == n


def test_daemon_forks_before_engine_and_reports_readiness(tmp_path, rng):
    """-daemon: the parent exits 0 only after the child's engine
    initialized (readiness pipe), and the daemonized child -- forked
    BEFORE any JAX client existed -- completes the run."""
    x = (rng.standard_normal((64 * 4,)) * 0.1).astype("<f4")
    inp = tmp_path / "in.f32"
    outp = tmp_path / "out.f32"
    x.tofile(inp)
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 64,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{outp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    r = _run_cli(["-quiet", "-nodefault", "-daemon", str(cfg)])
    assert r.returncode == 0, r.stderr[-500:]
    # the daemon child keeps running after the parent returned; wait for
    # the full output to land
    want = x.size * 4
    for _ in range(300):
        if outp.exists() and outp.stat().st_size >= want:
            break
        time.sleep(0.2)
    y = np.fromfile(outp, dtype="<f4")
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)


def test_daemon_parent_reports_child_init_failure(tmp_path):
    cfg = tmp_path / "c.conf"
    cfg.write_text("""
sampling_rate: 44100;
filter_length: 64,2;
coeff 0 { filename: "/nonexistent/taps.txt"; format: "TEXT"; };
input 0 { device: "file" { path: "/dev/zero"; }; sample: "FLOAT_LE"; channels: 1; };
output 0 { device: "file" { path: "/dev/null"; }; sample: "FLOAT_LE"; channels: 1; };
filter 0 { from_inputs: 0; to_outputs: 0; coeff: 0; };
""")
    r = _run_cli(["-quiet", "-nodefault", "-daemon", str(cfg)])
    assert r.returncode != 0


def test_bad_batch_env_does_not_crash(tmp_path, rng):
    x = (rng.standard_normal((64 * 2,)) * 0.1).astype("<f4")
    inp = tmp_path / "in.f32"
    x.tofile(inp)
    cfg = tmp_path / "c.conf"
    cfg.write_text(f"""
sampling_rate: 44100;
filter_length: 64,2;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "{inp}"; }}; sample: "FLOAT_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "{tmp_path}/o.f32"; }}; sample: "FLOAT_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    r = _run_cli(["-quiet", "-nodefault", str(cfg)],
                 extra_env={"BRUTEFIR_TPU_BATCH": "fast"})
    assert r.returncode == 0, r.stderr[-500:]
    assert "must be an integer" in r.stderr
