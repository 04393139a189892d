"""Depth-map conversion and registration helpers.

JAX equivalent of the reference's DepthUtils
(okvis_multisensor_processing/include/okvis/DepthUtils.hpp): raw↔metric
depth conversion and re-registration of a depth image taken by one camera
into the image plane of another camera (the RGB-D "depth registration"
used before feeding depth to the estimator and the submapping interface).

Redesign notes (SURVEY §7.1): the reference loops over pixels with OpenCV
`perspectiveTransform`/`projectPoints`; here everything is one vectorised
back-project → transform → project pipeline with a scatter-min z-buffer,
which XLA fuses into a handful of kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from okvis2x_tpu.cameras import pinhole
from okvis2x_tpu.cameras.pinhole import Camera
from okvis2x_tpu.core import se3


# -- raw <-> metric conversion (≙ DepthUtils.hpp inputDepthToMeters*) -------


def input_depth_to_meters(raw: jax.Array, scale: float = 1e-3) -> jax.Array:
    """uint16 (or float) sensor depth → metres; non-positive = invalid (0)."""
    d = raw.astype(jnp.float32) * scale
    return jnp.where(d > 0, d, 0.0)


def meters_to_input_depth(depth_m: jax.Array, scale: float = 1e-3) -> jax.Array:
    """Metres → uint16 sensor units, clipped to the representable range."""
    raw = jnp.round(depth_m / scale)
    return jnp.clip(raw, 0, 65535).astype(jnp.uint16)


def disparity_to_depth(disp: jax.Array, fx: float, baseline: float) -> jax.Array:
    """Stereo disparity [px] → metric depth; invalid where disp <= 0."""
    safe = jnp.maximum(disp, 1e-6)
    return jnp.where(disp > 0, fx * baseline / safe, 0.0)


def depth_sigma_from_disparity(
    disp: jax.Array, disp_sigma: jax.Array, fx: float, baseline: float
) -> jax.Array:
    """First-order σ_z = z^2 / (fx·b) · σ_d (the stereo-network σ path)."""
    z = disparity_to_depth(disp, fx, baseline)
    return jnp.where(disp > 0, z * z / (fx * baseline) * disp_sigma, 0.0)


# -- depth map -> point cloud ------------------------------------------------


def depth_to_points(depth: jax.Array, cam: Camera) -> tuple[jax.Array, jax.Array]:
    """Back-project a (H, W) metric depth map to camera-frame points.

    Returns ((H*W, 3) points, (H*W,) valid). Rays are unit-free
    back-projections scaled so that p_z == depth (pinhole z-depth
    convention, matching the reference's registration math).
    """
    H, W = depth.shape
    v, u = jnp.meshgrid(
        jnp.arange(H, dtype=depth.dtype),
        jnp.arange(W, dtype=depth.dtype),
        indexing="ij",
    )
    uv = jnp.stack([u.ravel(), v.ravel()], axis=-1)  # (HW, 2)
    rays, ok = jax.vmap(lambda x: pinhole.back_project(cam, x))(uv)
    rays = rays / jnp.maximum(rays[:, 2:3], 1e-9)  # z-normalised
    d = depth.ravel()
    pts = rays * d[:, None]
    valid = ok & (d > 0)
    return pts, valid


def transform_points(T_AB: jax.Array, p_B: jax.Array) -> jax.Array:
    """Apply SE(3) T_AB (7,) to points (N, 3)."""
    R = se3.quat_to_matrix(se3.se3_q(T_AB))
    return p_B @ R.T + se3.se3_t(T_AB)[None, :]


# -- depth registration (≙ DepthUtils.hpp registerDepth) ---------------------


def register_depth(
    depth_src: jax.Array,
    cam_src: Camera,
    cam_dst: Camera,
    T_dst_src: jax.Array,
    depth_scale: float = 1.0,
) -> jax.Array:
    """Re-render a depth image from `cam_src` into `cam_dst`'s image plane.

    Back-projects every source pixel, transforms into the destination
    camera frame, projects, and resolves collisions with a scatter-min
    z-buffer (nearest surface wins — the reference keeps the minimum depth
    per target pixel too). Unmapped target pixels are 0 (invalid).
    """
    pts_src, valid = depth_to_points(depth_src * depth_scale, cam_src)
    pts_dst = transform_points(T_dst_src, pts_src)
    uv, ok = jax.vmap(lambda p: pinhole.project(cam_dst, p))(pts_dst)
    z = pts_dst[:, 2]
    valid = valid & ok & (z > 0)

    Hd, Wd = cam_dst.height, cam_dst.width
    ui = jnp.round(uv[:, 0]).astype(jnp.int32)
    vi = jnp.round(uv[:, 1]).astype(jnp.int32)
    inb = (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd) & valid
    flat = jnp.where(inb, vi * Wd + ui, 0)
    zval = jnp.where(inb, z, jnp.inf)

    buf = jnp.full((Hd * Wd,), jnp.inf, dtype=z.dtype)
    buf = buf.at[flat].min(zval, mode="drop")
    out = jnp.where(jnp.isfinite(buf), buf, 0.0)
    return out.reshape(Hd, Wd)


def warp_depth_sigma(
    sigma_src: jax.Array,
    depth_src: jax.Array,
    cam_src: Camera,
    cam_dst: Camera,
    T_dst_src: jax.Array,
) -> jax.Array:
    """Carry the per-pixel σ map through the same registration (nearest
    source pixel per target, resolved with the registered depth winner)."""
    pts_src, valid = depth_to_points(depth_src, cam_src)
    pts_dst = transform_points(T_dst_src, pts_src)
    uv, ok = jax.vmap(lambda p: pinhole.project(cam_dst, p))(pts_dst)
    z = pts_dst[:, 2]
    valid = valid & ok & (z > 0)

    Hd, Wd = cam_dst.height, cam_dst.width
    ui = jnp.round(uv[:, 0]).astype(jnp.int32)
    vi = jnp.round(uv[:, 1]).astype(jnp.int32)
    inb = (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd) & valid
    flat = jnp.where(inb, vi * Wd + ui, 0)
    zval = jnp.where(inb, z, jnp.inf)

    zbuf = jnp.full((Hd * Wd,), jnp.inf, dtype=z.dtype)
    zbuf = zbuf.at[flat].min(zval, mode="drop")
    # a source pixel "wins" a target pixel if its z equals the z-buffer
    wins = inb & (zval <= zbuf[flat] + 1e-9)
    sbuf = jnp.zeros((Hd * Wd,), dtype=sigma_src.dtype)
    sbuf = sbuf.at[jnp.where(wins, flat, 0)].max(
        jnp.where(wins, sigma_src.ravel(), 0.0), mode="drop"
    )
    return sbuf.reshape(Hd, Wd)


def sparse_depth_from_landmarks(
    hp_W: jax.Array,
    valid: jax.Array,
    T_WC: jax.Array,
    cam: Camera,
    stride: int = 1,
) -> jax.Array:
    """Render tracked landmarks into a sparse depth map (MVS prior input,
    ≙ DepthFusionProcessor's sparse-depth channel). Returns (H, W) with 0
    where no landmark projects."""
    T_CW = se3.se3_inverse(T_WC)
    p_C = transform_points(T_CW, hp_W[:, :3] / jnp.maximum(hp_W[:, 3:4], 1e-12))
    uv, ok = jax.vmap(lambda p: pinhole.project(cam, p))(p_C)
    z = p_C[:, 2]
    ok = ok & valid & (z > 0)
    H, W = cam.height, cam.width
    ui = jnp.round(uv[:, 0]).astype(jnp.int32) // stride * stride
    vi = jnp.round(uv[:, 1]).astype(jnp.int32) // stride * stride
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & ok
    flat = jnp.where(inb, vi * W + ui, 0)
    buf = jnp.full((H * W,), jnp.inf, dtype=z.dtype)
    buf = buf.at[flat].min(jnp.where(inb, z, jnp.inf), mode="drop")
    return jnp.where(jnp.isfinite(buf), buf, 0.0).reshape(H, W)
