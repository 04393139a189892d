"""The card's device programs against their plain references at real
widths (okvis2x_tpu/device_checks.py holds each check and its tolerance).

Run on a machine with a GPU:  JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

from okvis2x_tpu import device_checks

pytestmark = pytest.mark.gpu


def test_packed_hamming_exact(gpu_device):
    res = device_checks.hamming_check()
    assert res["ok"], res


def test_window_solve_matches_f64(gpu_device):
    res = device_checks.window_solve_check()
    assert res["ok"], res


def test_frontend_matches_cpu(gpu_device):
    res = device_checks.frontend_check()
    assert res["ok"], res
