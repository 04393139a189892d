"""Submap ICP (point-to-occupancy) factor.

Replaces the reference's `ceres::SubmapIcpError` (okvis_ceres/src/
SubmapIcpError.cpp:42-215): the residual of a measured point p_S (in the
sensor/body frame at pose T_WS_b) against the occupancy field of a submap
anchored at keyframe pose T_WS_a is

    r = w * occ( T_KA^-1 T_WA^-1 T_WB p_S ) / max(||grad occ||, g_min)

— the occupancy value normalised by the local field gradient so the
residual is approximately metric (distance-to-surface), with w from the
sensor sigma.  Out-of-map points give zero residual and zero Jacobian
(reference behaviour).  Jacobians w.r.t. both poses come from autodiff
through the trilinear field (grad_occupancy is the analytic inner
derivative; the chain through the pose retraction is exact).

Used for frame-to-map alignment (live LiDAR/depth factors) and map-to-map
alignment (submap alignment constraints, ≙ ViGraph::
addSubmapAlignmentConstraints).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3
from okvis2x_tpu.mapping import submap as sm_mod


def icp_residuals(
    sm: sm_mod.Submap,
    cfg: sm_mod.SubmapConfig,
    T_WA: jax.Array,  # (7,) anchor keyframe pose (submap frame K == A here)
    T_WB: jax.Array,  # (7,) pose owning the points
    p_B: jax.Array,  # (N, 3) measured points in B frame
    valid: jax.Array,  # (N,)
    sigma: float = 0.4,  # sensor sigma (se2.yaml `sigma`)
    grad_min: float = 0.1,
):
    """(N,) whitened residuals + validity (in-map & informative gradient)."""
    T_AB = se3.se3_multiply(se3.se3_inverse(T_WA), T_WB)
    p_K = se3.se3_apply(T_AB, p_B)
    occ, ok = sm_mod.interp_occupancy(sm, cfg, p_K)
    grad, _ = sm_mod.grad_occupancy(sm, cfg, p_K)
    gn = jnp.linalg.norm(grad, axis=-1)
    informative = gn > grad_min
    r = occ / jnp.maximum(gn, grad_min) / sigma
    use = valid & ok & informative
    return jnp.where(use, r, 0.0), use


def linearize_icp(
    sm: sm_mod.Submap,
    cfg: sm_mod.SubmapConfig,
    T_WA: jax.Array,
    T_WB: jax.Array,
    p_B: jax.Array,
    valid: jax.Array,
    sigma: float = 0.4,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Residuals + Jacobians wrt minimal increments of (T_WA, T_WB).

    Returns (r (N,), J_a (N, 6), J_b (N, 6), use (N,)).
    """
    z6 = jnp.zeros(6, T_WA.dtype)

    def f(da, db):
        return icp_residuals(
            sm, cfg, se3.retract(T_WA, da), se3.retract(T_WB, db),
            p_B, valid, sigma,
        )[0]

    r, use = icp_residuals(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
    Ja, Jb = jax.jacfwd(f, argnums=(0, 1))(z6, z6)
    return r, Ja, Jb, use


def icp_align(
    sm: sm_mod.Submap,
    cfg: sm_mod.SubmapConfig,
    T_WA: jax.Array,
    T_WB0: jax.Array,
    p_B: jax.Array,
    valid: jax.Array,
    iterations: int = 8,
    sigma: float = 0.4,
    damping: float = 1e-4,
):
    """GN alignment of pose B against the submap (anchor fixed) — the core
    of frame-to-map registration; also usable map-to-map by passing the
    second submap's occupied-voxel centres as the point cloud."""

    def body(_, T_WB):
        r, Ja, Jb, use = linearize_icp(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
        m = use.astype(r.dtype)
        J = Jb * m[:, None]
        rr = r * m
        H = J.T @ J
        # trace-relative damping: bounds steps along weakly-observed
        # directions (a plane constrains 1 of 6 dofs; absolute damping
        # leaves the null-space steps unbounded against noise gradients)
        lam = damping * jnp.trace(H) / 6.0 + 1e-9
        H = H + lam * jnp.eye(6, dtype=r.dtype)
        b = -(J.T @ rr)
        dx = jnp.linalg.solve(H, b)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        return se3.retract(T_WB, dx)

    T = jax.lax.fori_loop(0, iterations, body, T_WB0)
    r, use = icp_residuals(sm, cfg, T_WA, T, p_B, valid, sigma)
    cost = 0.5 * jnp.sum(r * r)
    return T, cost


def make_alignment_edge(
    sm: sm_mod.Submap,
    cfg: sm_mod.SubmapConfig,
    T_WA: jax.Array,
    T_WB: jax.Array,
    p_B: jax.Array,
    valid: jax.Array,
    sigma: float = 0.4,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Summarise ICP residuals into a relative-pose edge (T_AB, sqrt_info,
    strength) for the estimator's rel_* factors — how submap alignment
    terms enter the realtime problem (≙ addSubmapAlignmentConstraints
    creating per-point SubmapIcpError terms; we aggregate them into one
    Gaussian edge per submap pair, a static-shape granularity)."""
    r, Ja, Jb, use = linearize_icp(sm, cfg, T_WA, T_WB, p_B, valid, sigma)
    m = use.astype(r.dtype)
    # information in relative coordinates: J wrt delta_rel equals J_b mapped
    # through d(T_WB)/d(delta_rel) at fixed T_WA; with our left-perturbation
    # retraction, delta_b = Ad-like map of delta_rel — use J_b directly in
    # B-side coordinates and express the edge on T_AB in the same tangent.
    T_AB = se3.se3_multiply(se3.se3_inverse(T_WA), T_WB)

    def rel_fn(drel):
        T_WB_p = se3.se3_multiply(T_WA, se3.retract(T_AB, drel))
        return icp_residuals(sm, cfg, T_WA, T_WB_p, p_B, valid, sigma)[0]

    Jrel = jax.jacfwd(rel_fn)(jnp.zeros(6, T_WA.dtype)) * m[:, None]
    H = Jrel.T @ Jrel
    e, U = jnp.linalg.eigh(0.5 * (H + H.T))
    e = jnp.maximum(e, 0.0)
    sqrt_info = (U * jnp.sqrt(e)[None, :]) @ U.T
    return T_AB, sqrt_info, jnp.sum(e)
