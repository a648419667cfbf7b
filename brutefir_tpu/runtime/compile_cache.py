"""Persistent XLA compile cache placement.

Compiled programs persist across runs, so a later run skips compilation
(the reference's FFTW-wisdom file, fftw_convolver.c:809-848, plays the same
role). Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
nothing here overrides it. Otherwise the cache lives in one fixed directory
inside the checkout (``.jax_cache/``, ignored by git): the directory is part
of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")
# Of XLA's own sub-caches only the GPU autotuning results persist, so a
# warm run repeats the same kernel choices. XLA's kernel-binary cache
# file ("all" would add it) is left off: it hands a compiled kernel to a
# later program by kernel name, and on four H100s a cache carried over
# from an earlier program made the sharded step launch a kernel with
# launch dimensions it was not built for (CUDA_ERROR_INVALID_VALUE). The
# same program with a fresh cache ran correctly, cold and warm.
XLA_SUB_CACHES = "xla_gpu_per_fusion_autotune_cache_dir"


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_enable_xla_caches",
                      XLA_SUB_CACHES)
    return cache_dir
