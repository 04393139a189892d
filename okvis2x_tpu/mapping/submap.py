"""Occupancy submaps: dense log-odds voxel grids on device.

JAX replacement for supereight2's octree occupancy maps as used by the
reference (se::OccupancyMap<se::Res::Multi>, okvis_mapping/include/okvis/
mapTypedefs.hpp; integration at okvis_multisensor_processing/src/
SubmappingInterface.cpp:771-902; field interpolation helpers
`interpFieldMeanOccup`/`gradFieldMeanOccup` at okvis_mapping/include/okvis/
SubmappingUtils.hpp:43).

Design: a submap is a fixed-size dense voxel grid anchored to a keyframe
(T_WK), integrating depth/LiDAR as scatter-adds and interpolating as
gathers — both native XLA ops that fuse well.  The reference's 25.6 m
submap at multi-res octree becomes a D^3 grid at `res` metres (default
128^3 @ 0.2 m; the octree exists to make CPUs cache-friendly — HBM prefers
dense).  A brick-sparse pool for fine resolutions is the planned round-2
extension.

Log-odds fusion follows the same saturating model as supereight (bounded
[min_occ, max_occ], per-update +occ at the surface band, -free along the
ray).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


class SubmapConfig(NamedTuple):
    dim: int = 128  # voxels per side
    res: float = 0.2  # metres per voxel
    log_odd_occ: float = 0.85  # per-hit increment
    log_odd_free: float = -0.25  # per-pass decrement
    log_odd_min: float = -5.0
    log_odd_max: float = 5.0
    surface_band: float = 0.3  # metres: half-width of the occupied band
    samples_per_ray: int = 48  # free-space samples along each ray
    band_samples: int = 8  # surface-band samples (>= band span / res)


class Submap(NamedTuple):
    T_WK: jax.Array  # (7,) anchor pose (keyframe) — re-anchored on loop closure
    logodds: jax.Array  # (D, D, D) float32
    weight: jax.Array  # (D, D, D) float32 integration count (for maturity)


def _is_brick(cfg) -> bool:
    return hasattr(cfg, "table_dim")


def new_submap(T_WK, cfg, dtype=jnp.float32):
    """Allocate a submap for the given grid config — dense `SubmapConfig`
    or brick-sparse `mapping.brick.BrickConfig` (fine resolutions)."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.new_submap(T_WK, cfg, dtype)
    D = cfg.dim
    return Submap(
        T_WK=jnp.asarray(T_WK, dtype),
        logodds=jnp.zeros((D, D, D), dtype),
        weight=jnp.zeros((D, D, D), dtype),
    )


def _world_to_voxel(cfg: SubmapConfig, p_K: jax.Array) -> jax.Array:
    """Submap-frame metres -> continuous voxel coords (centred grid)."""
    half = cfg.dim * cfg.res / 2.0
    return (p_K + half) / cfg.res - 0.5


def _in_bounds(cfg: SubmapConfig, v: jax.Array) -> jax.Array:
    return jnp.all((v >= 0.0) & (v <= cfg.dim - 1.001), axis=-1)


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def _ray_samples(cfg, origin_K, end_K, valid, sigma, dtype):
    """Shared σ-aware ray sampling profile: returns (pts (N, S+B, 3),
    upd (N, S+B) log-odds deltas, ok (N, S+B)).

    Each ray contributes `samples_per_ray` free-space updates between origin
    and (range - band) plus a signed surface-band profile: log_odd_free at
    (r - band), 0 at the surface, log_odd_occ at (r + band/2) — the fused
    field's zero-crossing sits at the measured surface (the property
    SubmapIcp relies on).  Used by both the dense and brick-sparse grids."""
    d = end_K - origin_K[None, :]
    rng = jnp.linalg.norm(d, axis=-1, keepdims=True)
    dirn = d / jnp.maximum(rng, 1e-9)

    S = cfg.samples_per_ray
    B = cfg.band_samples
    band = cfg.surface_band
    fr = jnp.linspace(0.0, 1.0, S, dtype=dtype)
    depth_f = fr[None, :] * jnp.maximum(rng - band, 0.0)  # (N, S)
    u = jnp.linspace(-1.0, 0.5, B, dtype=dtype)  # (B,)
    depth_b = rng + band * u[None, :]  # (N, B)
    upd_b = jnp.where(
        u < 0, cfg.log_odd_free * (-u), cfg.log_odd_occ * (u / 0.5)
    )

    depth = jnp.concatenate([depth_f, depth_b], axis=1)  # (N, S+B)
    pts = origin_K[None, None, :] + dirn[:, None, :] * depth[..., None]
    upd = jnp.concatenate(
        [jnp.full((1, S), cfg.log_odd_free, dtype), upd_b[None, :]],
        axis=1,
    ) * jnp.ones_like(pts[..., 0])
    # weight down updates for noisy measurements
    sig_scale = jnp.clip(0.1 / jnp.maximum(jnp.asarray(sigma), 1e-3), 0.05, 1.0)
    if jnp.ndim(sig_scale) > 0:
        sig_scale = sig_scale.reshape(-1, 1)
    upd = upd * sig_scale
    ok = valid[:, None] & jnp.ones_like(upd, bool)
    return pts, upd, ok


def integrate_rays(
    sm,
    cfg,
    origin_K: jax.Array,  # (3,) sensor centre in submap frame
    end_K: jax.Array,  # (N, 3) measured end points in submap frame
    valid: jax.Array,  # (N,)
    sigma: jax.Array | float = 0.1,  # measurement stdev (scales the update)
):
    """Batch ray integration (≙ se::MapIntegrator::integrateRayBatch),
    nearest-voxel splatting; static shapes: N rays * (S + B) scatter items.
    Dispatches to the brick-sparse grid for `BrickConfig`."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.integrate_rays(sm, cfg, origin_K, end_K, valid, sigma)
    pts, upd, ok = _ray_samples(
        cfg, origin_K, end_K, valid, sigma, sm.logodds.dtype
    )
    v = _world_to_voxel(cfg, pts)
    ok = _in_bounds(cfg, v) & ok
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, cfg.dim - 1)
    upd = jnp.where(ok, upd, 0.0)

    flat_idx = (
        vi[..., 0] * cfg.dim * cfg.dim + vi[..., 1] * cfg.dim + vi[..., 2]
    ).reshape(-1)
    okf = ok.reshape(-1)
    # per-voxel MEAN of this integration's samples (supereight's weighted-
    # mean update model): a sum would make the field magnitude depend on
    # sample density along/across rays, producing ragged log-odds whose
    # gradients flip sign — fatal for the SubmapIcp residual r = occ/|grad|
    sum_upd = jnp.zeros_like(sm.logodds.reshape(-1)).at[flat_idx].add(
        upd.reshape(-1)
    )
    cnt = jnp.zeros_like(sm.logodds.reshape(-1)).at[flat_idx].add(
        okf.astype(sm.logodds.dtype)
    )
    lo = sm.logodds.reshape(-1) + sum_upd / jnp.maximum(cnt, 1.0)
    lo = jnp.clip(lo, cfg.log_odd_min, cfg.log_odd_max)
    w = sm.weight.reshape(-1)
    w = w.at[flat_idx].add(jnp.where(okf, 1.0, 0.0))
    D = cfg.dim
    return sm._replace(logodds=lo.reshape(D, D, D), weight=w.reshape(D, D, D))


def integrate_depth_image(
    sm: Submap,
    cfg: SubmapConfig,
    cam,
    T_KC: jax.Array,  # (7,) camera pose in submap frame
    depth: jax.Array,  # (H, W) metric depth, 0/inf = invalid
    sigma: jax.Array,  # (H, W) depth stdev
    stride: int = 4,
    max_depth: float = 20.0,
) -> Submap:
    """Depth-image integration (≙ integrateDepth): back-project a strided
    pixel grid and run batch ray integration, σ-aware."""
    from okvis2x_tpu.cameras import pinhole

    H, W = depth.shape
    ys = jnp.arange(0, H, stride)
    xs = jnp.arange(0, W, stride)
    uv = jnp.stack(
        jnp.meshgrid(xs.astype(depth.dtype), ys.astype(depth.dtype), indexing="xy"),
        axis=-1,
    ).reshape(-1, 2)
    d = depth[::stride, ::stride].reshape(-1)
    sg = sigma[::stride, ::stride].reshape(-1)
    ray, bp_ok = pinhole.back_project(cam, uv)
    p_C = ray / ray[..., 2:3] * d[:, None]
    p_K = se3.se3_apply(T_KC, p_C)
    valid = bp_ok & (d > 0.05) & (d < max_depth) & jnp.isfinite(d)
    origin_K = se3.se3_t(T_KC)
    return integrate_rays(sm, cfg, origin_K, p_K, valid, sg)


# ---------------------------------------------------------------------------
# field interpolation (≙ interpFieldMeanOccup / gradFieldMeanOccup)
# ---------------------------------------------------------------------------


def interp_occupancy(sm, cfg, p_K: jax.Array):
    """Trilinear occupancy lookup at (..., 3) submap-frame points.

    Out-of-map points return (0, invalid) — the reference's zero-residual
    out-of-map behaviour (SubmapIcpError.cpp:55-85)."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.interp_occupancy(sm, cfg, p_K)
    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    v = jnp.clip(v, 0.0, cfg.dim - 1.001)
    v0 = jnp.floor(v).astype(jnp.int32)
    f = v - v0
    lo = sm.logodds

    def g(dx, dy, dz):
        return lo[
            v0[..., 0] + dx, v0[..., 1] + dy, v0[..., 2] + dz
        ]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return jnp.where(ok, val, 0.0), ok


def grad_occupancy(sm, cfg, p_K: jax.Array):
    """Analytic gradient of the trilinear field wrt metric position (…, 3)."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.grad_occupancy(sm, cfg, p_K)
    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    v = jnp.clip(v, 0.0, cfg.dim - 1.001)
    v0 = jnp.floor(v).astype(jnp.int32)
    f = v - v0
    lo = sm.logodds

    def g(dx, dy, dz):
        return lo[v0[..., 0] + dx, v0[..., 1] + dy, v0[..., 2] + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    # d/dx
    dx = (
        (g(1, 0, 0) - g(0, 0, 0)) * (1 - fy) * (1 - fz)
        + (g(1, 1, 0) - g(0, 1, 0)) * fy * (1 - fz)
        + (g(1, 0, 1) - g(0, 0, 1)) * (1 - fy) * fz
        + (g(1, 1, 1) - g(0, 1, 1)) * fy * fz
    )
    dy = (
        (g(0, 1, 0) - g(0, 0, 0)) * (1 - fx) * (1 - fz)
        + (g(1, 1, 0) - g(1, 0, 0)) * fx * (1 - fz)
        + (g(0, 1, 1) - g(0, 0, 1)) * (1 - fx) * fz
        + (g(1, 1, 1) - g(1, 0, 1)) * fx * fz
    )
    dz = (
        (g(0, 0, 1) - g(0, 0, 0)) * (1 - fx) * (1 - fy)
        + (g(1, 0, 1) - g(1, 0, 0)) * fx * (1 - fy)
        + (g(0, 1, 1) - g(0, 1, 0)) * (1 - fx) * fy
        + (g(1, 1, 1) - g(1, 1, 0)) * fx * fy
    )
    grad = jnp.stack([dx, dy, dz], axis=-1) / cfg.res
    return jnp.where(ok[..., None], grad, 0.0), ok


def observed_mask(sm, cfg, p_K: jax.Array):
    """(...,) bool: point lands in a voxel with integration weight > 0
    (submap-overlap heuristic, ≙ evaluateDepthOverlap/evaluateLidarOverlap)."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.observed_mask(sm, cfg, p_K)
    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, cfg.dim - 1)
    return (sm.weight[vi[..., 0], vi[..., 1], vi[..., 2]] > 0) & ok


def occupied_point_list(
    sm, cfg, threshold: float = 1.0, max_points: int = 4096
):
    """Compact (max_points, 3) submap-frame occupied-voxel centres + valid
    mask — uniform surface extraction across dense and brick grids."""
    if _is_brick(cfg):
        from okvis2x_tpu.mapping import brick

        return brick.occupied_point_list(sm, cfg, threshold, max_points)
    occ = (sm.logodds > threshold).reshape(-1)
    count = jnp.sum(occ)
    idx = jnp.nonzero(occ, size=max_points, fill_value=0)[0]
    D = cfg.dim
    vi = jnp.stack([idx // (D * D), (idx // D) % D, idx % D], axis=-1)
    centers = (
        vi.astype(sm.logodds.dtype) + 0.5
    ) * cfg.res - D * cfg.res / 2.0
    valid = jnp.arange(max_points) < count
    return centers, valid


def occupied_points(sm: Submap, cfg: SubmapConfig, threshold: float = 1.0):
    """(D^3, 3) voxel centres in K frame + (D^3,) occupied mask (for export /
    overlap tests; host filters by the mask)."""
    D = cfg.dim
    idx = jnp.arange(D)
    gx, gy, gz = jnp.meshgrid(idx, idx, idx, indexing="ij")
    centers = (
        jnp.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(sm.logodds.dtype)
        + 0.5
    ) * cfg.res - cfg.dim * cfg.res / 2.0
    occ = (sm.logodds > threshold).reshape(-1)
    return centers, occ
