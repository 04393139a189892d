"""Native dataset-loader runtime (native/dataloader.cpp via ctypes).

Covers: PNG decode (gray8 / RGB / 16-bit), binary PGM decode, in-order
multi-threaded prefetch, and the MPMC threadsafe queue semantics the
reference relies on (blocking push, dropping push, pop timeout, shutdown
— ≙ okvis threadsafe::Queue, ThreadsafeQueue.hpp:41-212).
"""

import os
import threading
import time

import numpy as np
import pytest

from okvis2x_tpu.io import native_loader as nl
from okvis2x_tpu.io.png import write_png


@pytest.fixture(autouse=True)
def native_library():
    """Builds the library at first use; skips where it cannot be built
    (no C++ compiler or libpng headers)."""
    if not nl.available():
        pytest.skip("native dataloader cannot be built here")


def _write_png(path, arr):
    write_png(path, arr)


def test_decode_png_gray(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    _write_png(p, arr)
    out = nl.decode_image(p)
    np.testing.assert_array_equal(out, arr)


def test_decode_png_rgb(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    _write_png(p, arr)
    out = nl.decode_image(p)
    assert out.shape == (32, 40)
    # libpng defaults to BT.709 luminance coefficients
    lum = arr @ np.array([0.2126, 0.7152, 0.0722])
    assert np.abs(out.astype(float) - lum).mean() < 3.0


def test_decode_png_16bit(tmp_path):
    arr16 = (np.arange(16 * 20, dtype=np.uint16).reshape(16, 20) * 97) % 65535
    p = str(tmp_path / "d.png")
    _write_png(p, arr16)
    out = nl.decode_image(p)
    assert out.shape == (16, 20)
    # 16->8 bit strip keeps the high byte
    np.testing.assert_array_equal(out, (arr16 >> 8).astype(np.uint8))


def test_decode_pgm(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (24, 30), dtype=np.uint8)
    p = str(tmp_path / "e.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n30 24\n255\n")
        f.write(arr.tobytes())
    out = nl.decode_image(p)
    np.testing.assert_array_equal(out, arr)


def test_prefetcher_order(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    imgs = []
    for i in range(25):
        arr = rng.integers(0, 256, (16, 16), dtype=np.uint8)
        p = str(tmp_path / f"{i:03d}.png")
        _write_png(p, arr)
        paths.append(p)
        imgs.append(arr)
    pf = nl.ImagePrefetcher(paths, n_threads=4, window=4)
    got = list(pf)
    assert len(got) == 25
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_early_close(tmp_path):
    arr = np.zeros((8, 8), np.uint8)
    paths = []
    for i in range(10):
        p = str(tmp_path / f"{i}.png")
        _write_png(p, arr)
        paths.append(p)
    pf = nl.ImagePrefetcher(paths, n_threads=2, window=2)
    next(pf)
    pf.close()  # must not deadlock or crash


def test_queue_roundtrip_and_drop():
    q = nl.NativeQueue(capacity=2)
    a = np.arange(10, dtype=np.float64)
    assert q.push(a) == 0
    assert q.push(a * 2) == 0
    # dropping push on a full queue drops the oldest
    assert q.push(a * 3, block=False) == 1
    out = q.pop().view(np.float64)
    np.testing.assert_array_equal(out, a * 2)
    out = q.pop().view(np.float64)
    np.testing.assert_array_equal(out, a * 3)
    assert q.size() == 0
    # timeout pop on empty
    t0 = time.time()
    assert q.pop(timeout_ms=50) is None
    assert time.time() - t0 < 2.0


def test_queue_blocking_producer_consumer():
    q = nl.NativeQueue(capacity=4)
    n = 200
    seen = []

    def consumer():
        while True:
            item = q.pop(timeout_ms=2000)
            if item is None:
                return
            seen.append(int(item.view(np.int64)[0]))
            if len(seen) == n:
                return

    th = threading.Thread(target=consumer)
    th.start()
    for i in range(n):
        q.push(np.array([i], np.int64))
    th.join(timeout=10)
    assert not th.is_alive()
    assert seen == list(range(n))
    q.shutdown()
