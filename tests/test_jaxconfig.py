"""Compile-cache placement (utils/jaxconfig.py): with
JAX_COMPILATION_CACHE_DIR set the program sets no cache directory itself,
and without it the cache lives in the checkout's `.jax_cache`."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import jax; from okvis2x_tpu.utils import jaxconfig; "
    "jaxconfig.setup(); print(jax.config.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout.strip().splitlines()[-1]
    if env_dir:
        assert out == str(tmp_path / "cache")
    else:
        assert out == os.path.join(REPO, ".jax_cache")
