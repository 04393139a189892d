"""Process-wide JAX configuration for apps, benches and tests.

Called by the CLI apps, bench.py, chip_smoke.py, the driver entry points
and the test suite before their first JAX computation.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cache_dir() -> str | None:
    """Where this program keeps JAX's persistent compilation cache: None
    when JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable itself),
    else the fixed `<checkout>/.jax_cache`.  The directory is part of the
    cache key, so it must not move between runs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def setup():
    import jax

    if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
        # CPU runs validate the f64 estimator path (the reference is
        # double-precision Ceres); GPU runs stay f32
        jax.config.update("jax_enable_x64", True)

    # float32 matmuls on the GPU default to TF32 tensor-core inputs (about
    # three decimal digits).  The estimator's normal equations (H = J^T J,
    # Schur complement) need true f32 products or GN steps lose accuracy
    # and the window solver drifts.  Descriptor Hamming matmuls use bf16
    # operands explicitly (frontend/matcher.py), which is exact for ±1.
    jax.config.update("jax_default_matmul_precision", "highest")

    cache = cache_dir()
    if cache is not None:
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
