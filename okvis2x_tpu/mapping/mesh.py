"""Submap mesh extraction via the native marching-tetrahedra library.

ctypes bridge to native/mesh_mt.cpp (built on demand with g++); the
framework's counterpart of supereight2's `map->mesh()` + per-submap .ply
export (reference: SubmappingInterface.cpp:935-980).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from okvis2x_tpu.io.native_loader import build_shared_library

_LIB: Optional[ctypes.CDLL] = None

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "mesh_mt.cpp")
_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libmesh_mt.so")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.abspath(_SO)
    build_shared_library(os.path.abspath(_SRC), so, ["-O2"])
    lib = ctypes.CDLL(so)
    lib.mesh_marching_tetrahedra.restype = ctypes.c_int64
    lib.mesh_marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    _LIB = lib
    return lib


def extract_mesh(field: np.ndarray, iso: float = 0.0) -> np.ndarray:
    """Triangles (T, 3, 3) in voxel coordinates from a dense (nx, ny, nz)
    scalar field (e.g. submap log-odds; iso=0 is the occupancy boundary)."""
    lib = _load()
    f = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = f.shape
    cap = 1 << 20
    for _ in range(4):
        out = np.empty(cap, np.float32)
        n = lib.mesh_marching_tetrahedra(
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nx, ny, nz, ctypes.c_float(iso),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cap,
        )
        if n >= 0:
            return out[:n].reshape(-1, 3, 3)
        cap = int(-n) + 64
    raise RuntimeError("mesh buffer negotiation failed")


def submap_mesh(sm, cfg, iso: float = 0.0) -> np.ndarray:
    """Triangles (T, 3, 3) in submap-frame metres."""
    tris = extract_mesh(np.asarray(sm.logodds), iso)
    half = cfg.dim * cfg.res / 2.0
    return (tris + 0.5) * cfg.res - half


def write_ply_mesh(path: str, tris: np.ndarray, colours=None):
    """ASCII PLY triangle mesh (vertices deduplicated per-triangle only);
    `colours` (T*3, 3) in [0, 1] adds per-vertex RGB (coloured submap
    meshes ≙ the reference's OccupancyColIdMap exports)."""
    nv = tris.shape[0] * 3
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {nv}\n"
            "property float x\nproperty float y\nproperty float z\n"
        )
        if colours is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(
            f"element face {tris.shape[0]}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        if colours is not None:
            cb = np.clip(np.asarray(colours) * 255, 0, 255).astype(np.uint8)
            for t, c in zip(tris.reshape(-1, 3), cb):
                f.write(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} "
                        f"{c[0]} {c[1]} {c[2]}\n")
        else:
            for t in tris.reshape(-1, 3):
                f.write(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}\n")
        for i in range(tris.shape[0]):
            f.write(f"3 {3*i} {3*i+1} {3*i+2}\n")
