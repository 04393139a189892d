"""Test configuration: the suite runs on the CPU, as 8 virtual devices.

XLA_FLAGS must be set before the first backend initialisation to get the
8 virtual host devices.  JAX_PLATFORMS defaults to `cpu`; tests marked
`gpu` compare the card with its references and run only when JAX_PLATFORMS
selects the GPU (see README.md).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from okvis2x_tpu.utils import jaxconfig  # noqa: E402

# persistent compile cache (the suite is compile-bound on small CPU hosts)
# and, on the CPU, the float64 estimator path that matches the reference's
# double-precision Ceres solver.  Tests that exercise f32 cast explicitly.
jaxconfig.setup()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX runs without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev
