"""NumPy twin of cameras/pinhole.py + distortion.py for host-side code.

Host orchestration (outlier gating, epipolar pre-gating, landmark
projection checks) calls camera projection on small, dynamically-shaped
index sets.  Running the jnp versions there executes op-by-op on the
accelerator, one dispatch and sync each, and every new shape
compiles a fresh program.  These numpy implementations mirror
cameras/pinhole.py exactly (property-tested in
tests/test_cameras.py::test_numpy_camera_twin_matches_jax); the jnp
versions remain the in-jit source of truth for factors and fused
pipeline programs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from okvis2x_tpu.cameras import distortion as dist


@dataclasses.dataclass(frozen=True)
class NpCamera:
    fxfycxcy: np.ndarray
    dist_params: np.ndarray
    width: int
    height: int
    model: str


def to_numpy(cam) -> NpCamera:
    """One-time conversion of a jax Camera pytree (pays the device→host
    transfer once, at pipeline init)."""
    return NpCamera(
        fxfycxcy=np.asarray(cam.fxfycxcy, np.float64),
        dist_params=np.asarray(cam.dist_params, np.float64),
        width=cam.width,
        height=cam.height,
        model=cam.model,
    )


_UNDISTORT_ITERS = 7


def _distort_radtan(p, xy):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return np.stack([xd, yd], axis=-1)


def _distort_radtan8(p, xy):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    k3, k4, k5, k6 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
        1.0 + k4 * r2 + k5 * r4 + k6 * r6
    )
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return np.stack([xd, yd], axis=-1)


def _distort_equidistant(p, xy):
    k1, k2, k3, k4 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-24))
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = np.where(r > 1e-8, theta_d / r, 1.0)
    return xy * scale[..., None]


_DISTORT = {
    dist.RADTAN: _distort_radtan,
    dist.RADTAN8: _distort_radtan8,
    dist.EQUIDISTANT: _distort_equidistant,
    dist.NONE: lambda p, xy: xy,
}


def distort(model: str, params, xy):
    return _DISTORT[model](np.asarray(params), np.asarray(xy))


def undistort(model: str, params, xy_d):
    """Fixed-count Newton inverse with a numeric per-point 2x2 Jacobian
    (same iteration count as distortion.undistort)."""
    if model == dist.NONE:
        return np.asarray(xy_d)
    params = np.asarray(params)
    xy_d = np.asarray(xy_d, np.float64)
    fwd = _DISTORT[model]
    xy = xy_d.copy()
    eps = 1e-7
    e0 = np.zeros_like(xy)
    e0[..., 0] = eps
    e1 = np.zeros_like(xy)
    e1[..., 1] = eps
    for _ in range(_UNDISTORT_ITERS):
        val = fwd(params, xy)
        Jc0 = (fwd(params, xy + e0) - val) / eps
        Jc1 = (fwd(params, xy + e1) - val) / eps
        r = val - xy_d
        a, b = Jc0[..., 0], Jc1[..., 0]
        c, d = Jc0[..., 1], Jc1[..., 1]
        det = a * d - b * c
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        dx = (d * r[..., 0] - b * r[..., 1]) / det
        dy = (-c * r[..., 0] + a * r[..., 1]) / det
        xy = xy - np.stack([dx, dy], axis=-1)
    return xy


def _eucm_project_normalized(p, pc):
    alpha, beta = p[..., 0], p[..., 1]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    d = np.sqrt(np.maximum(beta * (x * x + y * y) + z * z, 1e-24))
    denom = alpha * d + (1.0 - alpha) * z
    safe = np.abs(denom) > 1e-12
    denom = np.where(safe, denom, 1e-12)
    m = np.stack([x / denom, y / denom], axis=-1)
    w = np.where(alpha <= 0.5, alpha / (1.0 - alpha), (1.0 - alpha) / alpha)
    return m, safe & (z > -w * d)


def _eucm_back_project_normalized(p, m):
    alpha, beta = p[..., 0], p[..., 1]
    mx, my = m[..., 0], m[..., 1]
    r2 = mx * mx + my * my
    gamma = 1.0 - alpha
    under = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    valid = under >= 0.0
    under = np.maximum(under, 0.0)
    mz = (1.0 - beta * alpha * alpha * r2) / (alpha * np.sqrt(under) + gamma)
    return np.stack([mx, my, mz], axis=-1), valid


def project(cam: NpCamera, p_C) -> Tuple[np.ndarray, np.ndarray]:
    p_C = np.asarray(p_C, np.float64)
    fx, fy, cx, cy = cam.fxfycxcy
    if cam.model == "eucm":
        m, z_ok = _eucm_project_normalized(cam.dist_params, p_C)
    else:
        z = p_C[..., 2]
        z_ok = z > 1e-6
        z_safe = np.where(z_ok, z, 1.0)
        xy = p_C[..., :2] / z_safe[..., None]
        m = distort(cam.model, cam.dist_params, xy)
    u = fx * m[..., 0] + cx
    v = fy * m[..., 1] + cy
    uv = np.stack([u, v], axis=-1)
    in_img = (
        (u >= -0.5) & (u <= cam.width - 0.5)
        & (v >= -0.5) & (v <= cam.height - 0.5)
    )
    return uv, z_ok & in_img


def back_project(cam: NpCamera, uv) -> Tuple[np.ndarray, np.ndarray]:
    uv = np.asarray(uv, np.float64)
    fx, fy, cx, cy = cam.fxfycxcy
    m = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    if cam.model == "eucm":
        return _eucm_back_project_normalized(cam.dist_params, m)
    xy = undistort(cam.model, cam.dist_params, m)
    ray = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)
    err = np.linalg.norm(
        distort(cam.model, cam.dist_params, xy) - m, axis=-1
    )
    return ray, err < 1e-6


def back_project_unit(cam: NpCamera, uv):
    ray, valid = back_project(cam, uv)
    return ray / np.linalg.norm(ray, axis=-1, keepdims=True), valid


def project_homogeneous(cam: NpCamera, hp_C):
    hp_C = np.asarray(hp_C, np.float64)
    w = hp_C[..., 3]
    p = np.where(w[..., None] >= 0, hp_C[..., :3], -hp_C[..., :3])
    return project(cam, p)
