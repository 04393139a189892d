"""Pinhole camera model with pluggable distortion.

Replaces the reference's `PinholeCamera<DISTORTION_T>` (okvis_cv/include/okvis/
cameras/PinholeCamera.hpp + implementation/PinholeCamera.hpp) with a
functional, batch-first design:

    project(cam, p_C)       -> (uv, status)        points in camera frame -> pixels
    back_project(cam, uv)   -> (ray, valid)        pixels -> unit-norm-z rays

A camera is a small pytree `Camera` carrying intrinsics [fx, fy, cx, cy],
image size, distortion model name (static) and distortion parameters.  All
functions broadcast over leading batch dims and are jit/vmap-safe; Jacobians
come from autodiff in the factors (verified against finite differences in
tests, mirroring okvis_cv/test/TestPinholeCamera.cpp).

Projection status mirrors the reference's ProjectionStatus: a boolean
`valid` = (in front of camera) & (inside image bounds) & (distortion domain
ok); invalid projections still produce finite values so gradients stay clean
— downstream code masks with `valid`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from okvis2x_tpu.cameras import distortion as dist


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole (or EUCM via model='eucm') camera intrinsics pytree.

    fxfycxcy: (..., 4); dist_params: (..., P).  Image size and model are
    static metadata (jit-hashable, not traced).
    """

    fxfycxcy: jax.Array
    dist_params: jax.Array
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    model: str = dataclasses.field(
        default=dist.RADTAN, metadata=dict(static=True)
    )  # distortion model name or 'eucm'


def make_pinhole(
    fx, fy, cx, cy, width, height, model=dist.RADTAN, dist_params=(), dtype=jnp.float64
) -> Camera:
    # resolve the dtype ONCE (f64 only under x64, i.e. CPU hosts; f32 on
    # the GPU) so the precision choice is explicit, not a truncation warning
    dtype = jax.dtypes.canonicalize_dtype(dtype)
    p = jnp.asarray(dist_params, dtype=dtype)
    if p.size == 0:
        p = jnp.zeros((dist.NUM_PARAMS.get(model, 0),), dtype=dtype)
    return Camera(
        fxfycxcy=jnp.array([fx, fy, cx, cy], dtype=dtype),
        dist_params=p,
        width=int(width),
        height=int(height),
        model=model,
    )


# -- EUCM (extended unified camera model, okvis_cv EucmCamera.hpp) ----------
# params layout for model='eucm': dist_params = [alpha, beta]


def _eucm_project_normalized(dist_params, p):
    alpha = dist_params[..., 0]
    beta = dist_params[..., 1]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = jnp.sqrt(jnp.maximum(beta * (x * x + y * y) + z * z, 1e-24))
    denom = alpha * d + (1.0 - alpha) * z
    safe = jnp.abs(denom) > 1e-12
    denom = jnp.where(safe, denom, 1e-12)
    m = jnp.stack([x / denom, y / denom], axis=-1)
    # validity: projection domain condition z > -w*d with w from alpha
    w = jnp.where(alpha <= 0.5, alpha / (1.0 - alpha), (1.0 - alpha) / alpha)
    valid = safe & (z > -w * d)
    return m, valid


def _eucm_back_project_normalized(dist_params, m):
    alpha = dist_params[..., 0]
    beta = dist_params[..., 1]
    mx, my = m[..., 0], m[..., 1]
    r2 = mx * mx + my * my
    gamma = 1.0 - alpha
    under = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    valid = under >= 0.0
    under = jnp.maximum(under, 0.0)
    mz = (1.0 - beta * alpha * alpha * r2) / (
        alpha * jnp.sqrt(under) + gamma
    )
    ray = jnp.stack([mx, my, mz], axis=-1)
    return ray, valid


# -- projection -------------------------------------------------------------


def project(cam: Camera, p_C: jax.Array):
    """Project camera-frame points (..., 3) to pixels (..., 2), with validity.

    (reference: PinholeCamera::project / EucmCamera::project.)
    """
    fx, fy, cx, cy = (
        cam.fxfycxcy[..., 0],
        cam.fxfycxcy[..., 1],
        cam.fxfycxcy[..., 2],
        cam.fxfycxcy[..., 3],
    )
    if cam.model == "eucm":
        m, dom_ok = _eucm_project_normalized(cam.dist_params, p_C)
        z_ok = dom_ok
    else:
        z = p_C[..., 2]
        z_ok = z > 1e-6
        z_safe = jnp.where(z_ok, z, 1.0)
        xy = p_C[..., :2] / z_safe[..., None]
        m = dist.distort(cam.model, cam.dist_params, xy)
    u = fx * m[..., 0] + cx
    v = fy * m[..., 1] + cy
    uv = jnp.stack([u, v], axis=-1)
    in_img = (
        (u >= -0.5) & (u <= cam.width - 0.5) & (v >= -0.5) & (v <= cam.height - 0.5)
    )
    return uv, z_ok & in_img


def back_project(cam: Camera, uv: jax.Array):
    """Pixels (..., 2) -> rays (..., 3) with z=1 (pinhole) or unnormalised
    (eucm); valid flag for invertible region.

    (reference: PinholeCamera::backProject.)
    """
    fx, fy, cx, cy = (
        cam.fxfycxcy[..., 0],
        cam.fxfycxcy[..., 1],
        cam.fxfycxcy[..., 2],
        cam.fxfycxcy[..., 3],
    )
    m = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    if cam.model == "eucm":
        ray, valid = _eucm_back_project_normalized(cam.dist_params, m)
        return ray, valid
    xy = dist.undistort(cam.model, cam.dist_params, m)
    ray = jnp.concatenate([xy, jnp.ones_like(xy[..., :1])], axis=-1)
    # validity: re-distorting must reproduce m (detects outside-domain pixels)
    err = jnp.linalg.norm(dist.distort(cam.model, cam.dist_params, xy) - m, axis=-1)
    return ray, err < 1e-6


def back_project_unit(cam: Camera, uv: jax.Array):
    ray, valid = back_project(cam, uv)
    return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True), valid


def project_homogeneous(cam: Camera, hp_C: jax.Array):
    """Project homogeneous camera-frame points [x,y,z,w]; handles w≈0
    (points at infinity) like the reference's projectHomogeneous."""
    w = hp_C[..., 3]
    p = jnp.where(w[..., None] >= 0, hp_C[..., :3], -hp_C[..., :3])
    return project(cam, p)
