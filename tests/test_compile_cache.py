"""Where the persistent compile cache goes: JAX_COMPILATION_CACHE_DIR when
set, else one fixed directory inside the checkout that git ignores; the
config's convolver_config never moves it."""

import os

import jax
import pytest

from brutefir_tpu.runtime import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prior = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prior)


def test_default_dir_is_in_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.configure_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_env_dir_wins(monkeypatch, tmp_path, restore_cache_dir):
    """With the variable set, JAX's own setting stands untouched."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_xla_sub_caches_persist(monkeypatch, restore_cache_dir):
    """Autotuning results persist; the kernel-binary cache does not."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    compile_cache.configure_compile_cache()
    assert (jax.config.jax_persistent_cache_enable_xla_caches
            == "xla_gpu_per_fusion_autotune_cache_dir")


def test_convolver_config_does_not_move_the_cache(tmp_path, monkeypatch,
                                                  restore_cache_dir):
    from brutefir_tpu.config import parse_config
    from brutefir_tpu.runtime import Engine
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    conf = parse_config(f"""
convolver_config: "{tmp_path / 'wisdom'}";
sampling_rate: 44100;
filter_length: 64;
coeff 0 {{ filename: "dirac pulse"; }};
input 0 {{ device: "file" {{ path: "/dev/zero"; }}; sample: "S16_LE"; channels: 1; }};
output 0 {{ device: "file" {{ path: "/dev/null"; }}; sample: "S16_LE"; channels: 1; }};
filter 0 {{ from_inputs: 0; to_outputs: 0; coeff: 0; }};
""")
    Engine(conf)
    assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
    assert not os.path.exists(str(tmp_path / "wisdom") + ".xla_cache")
