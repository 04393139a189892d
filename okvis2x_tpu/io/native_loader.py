"""ctypes bridge to the native dataset-loader runtime (native/dataloader.cpp).

The reference keeps dataset streaming in C++ (DatasetReader's reader thread +
threadsafe::Queue, okvis_multisensor_processing/src/DatasetReader.cpp); here
the same role is played by a libpng-backed worker pool that decodes frames
ahead of the consumer off the GIL and delivers them strictly in order.
The library is built from source at first use; without a C++ toolchain or
libpng every decode falls back to the standard-library codec (io/png.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from okvis2x_tpu.io import png

_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_DIR, "dataloader.cpp")
_SO = os.path.join(_DIR, "libdataloader.so")

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)


def build_shared_library(src: str, so: str, flags: Sequence[str]) -> None:
    """Compile `src` into the shared library `so` unless it is newer than
    the source.  The compiler writes a private temporary file that is then
    renamed into place, so concurrent builders (parallel test workers) never
    load a half-written library."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-shared", "-fPIC", "-o", tmp, src, *flags],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    try:
        build_shared_library(
            _SRC, _SO,
            ["-O3", "-std=c++17", "-lpng", "-lz", "-lpthread"],
        )
        lib = ctypes.CDLL(_SO)
        lib.dl_decode.restype = ctypes.c_int
        lib.dl_decode.argtypes = [
            ctypes.c_char_p, _U8P, ctypes.c_int64, _I32P, _I32P,
        ]
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [
            ctypes.c_void_p, _U8P, ctypes.c_int64, _I32P, _I32P,
        ]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        # no compiler, no libpng headers, or an unloadable library
        _LOAD_FAILED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def _py_decode(path: str) -> np.ndarray:
    return png.to_gray8(png.read_image(path))


def decode_image(path: str, max_bytes: int = 1 << 24) -> np.ndarray:
    """Decode one image file to a (H, W) uint8 array."""
    lib = _load()
    if lib is None:
        return _py_decode(path)
    buf = np.empty(max_bytes, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dl_decode(
        path.encode(), buf.ctypes.data_as(_U8P), max_bytes,
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc == -2:
        return decode_image(path, max_bytes=w.value * h.value)
    if rc != 0:
        return _py_decode(path)
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class ImagePrefetcher:
    """Iterator over decoded frames, prefetched by native worker threads in
    strict file-list order."""

    def __init__(
        self,
        paths: Sequence[str],
        n_threads: int = 4,
        window: int = 8,
        max_bytes: int = 1 << 24,
    ):
        self._paths: List[str] = list(paths)
        self._max_bytes = max_bytes
        self._i = 0
        self._lib = _load()
        self._handle = None
        if self._lib is not None and self._paths:
            blob = b"".join(p.encode() + b"\0" for p in self._paths)
            self._blob = blob  # keep alive
            self._handle = self._lib.dl_open(
                blob, len(self._paths), n_threads, window
            )

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._paths)

    def __next__(self) -> np.ndarray:
        if self._i >= len(self._paths):
            self.close()
            raise StopIteration
        path = self._paths[self._i]
        self._i += 1
        if self._handle is None:
            return _py_decode(path)
        buf = np.empty(self._max_bytes, np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.dl_next(
            self._handle, buf.ctypes.data_as(_U8P), self._max_bytes,
            ctypes.byref(w), ctypes.byref(h),
        )
        if rc != 0:
            # decode failure for this frame: fall back for it alone
            return _py_decode(path)
        return buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle is not None:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativeQueue:
    """Bounded MPMC queue holding serialized numpy payloads in native memory
    (≙ okvis::threadsafe::Queue semantics: blocking push, dropping push,
    pop with timeout, shutdown)."""

    def __init__(self, capacity: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native dataloader library unavailable")
        if not hasattr(lib, "_tsq_bound"):
            lib.tsq_create.restype = ctypes.c_void_p
            lib.tsq_create.argtypes = [ctypes.c_int]
            lib.tsq_push.restype = ctypes.c_int
            lib.tsq_push.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64]
            lib.tsq_push_dropping.restype = ctypes.c_int
            lib.tsq_push_dropping.argtypes = [
                ctypes.c_void_p, _U8P, ctypes.c_int64,
            ]
            lib.tsq_pop.restype = ctypes.c_int64
            lib.tsq_pop.argtypes = [
                ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int,
            ]
            lib.tsq_size.restype = ctypes.c_int
            lib.tsq_size.argtypes = [ctypes.c_void_p]
            lib.tsq_shutdown.restype = None
            lib.tsq_shutdown.argtypes = [ctypes.c_void_p]
            lib.tsq_destroy.restype = None
            lib.tsq_destroy.argtypes = [ctypes.c_void_p]
            lib._tsq_bound = True
        self._lib = lib
        self._handle = lib.tsq_create(capacity)

    def push(self, data: np.ndarray, block: bool = True) -> int:
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
        fn = self._lib.tsq_push if block else self._lib.tsq_push_dropping
        return fn(self._handle, buf.ctypes.data_as(_U8P), buf.nbytes)

    def pop(
        self, max_bytes: int = 1 << 22, timeout_ms: int = -1
    ) -> Optional[np.ndarray]:
        buf = np.empty(max_bytes, np.uint8)
        n = self._lib.tsq_pop(
            self._handle, buf.ctypes.data_as(_U8P), max_bytes, timeout_ms
        )
        if n == -2:
            return self.pop(max_bytes * 4, timeout_ms)
        if n < 0:
            return None
        return buf[:n].copy()

    def size(self) -> int:
        return self._lib.tsq_size(self._handle)

    def shutdown(self):
        self._lib.tsq_shutdown(self._handle)

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._lib.tsq_shutdown(self._handle)
            self._lib.tsq_destroy(self._handle)
        except Exception:
            pass
