"""Observation → relative-pose-edge marginalisation (TwoPoseGraphError).

JAX equivalent of the reference's `ceres::TwoPoseGraphError::compute`
(okvis_ceres/src/TwoPoseGraphError.cpp:162-260): summarise the reprojection
information of landmarks co-observed by two keyframes into a 6-dof
relative-pose edge, so old keyframes can leave the realtime window at O(1)
cost while their geometry survives in the pose graph.

Steps (mirroring the reference):
  1. linearise the co-observed reprojection factors at the current estimates
     with the Cauchy corrector (robustified GN system);
  2. Schur-marginalise the landmarks -> 12x12 Hessian over (pose_a, pose_b);
  3. reparametrise (delta_a, delta_b) -> (delta_a, delta_rel) where
     delta_rel is the tangent of T_ab = T_a^-1 T_b (jacfwd of the exact
     reparametrisation at 0);
  4. marginalise the absolute/gauge block delta_a with a rank-revealing
     pseudo-inverse (reference: PseudoInverse.hpp);
  5. eigendecompose the 6x6 relative information with eigenvalue clamping
     for a rank-safe sqrt information (reference eigendecomposes H00).

The resulting edge (T_ab measurement = current relative estimate +
sqrt-information) feeds BAProblem.rel_* factors.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3
from okvis2x_tpu.factors import reprojection, robust
from okvis2x_tpu.solver import gauss_newton as gn


def two_pose_edge(
    cams: gn.StackedCameras,
    T_WS_a: jax.Array,  # (7,)
    T_WS_b: jax.Array,  # (7,)
    T_SC: jax.Array,  # (C, 7)
    hp_W: jax.Array,  # (L, 4) co-observed landmarks
    lm_mask: jax.Array,  # (L,)
    obs_pose: jax.Array,  # (N,) int32: 0 -> pose a, 1 -> pose b
    obs_cam: jax.Array,  # (N,) int32
    obs_lm: jax.Array,  # (N,) int32 row into hp_W
    obs_uv: jax.Array,  # (N, 2)
    obs_sqrt_info: jax.Array,  # (N,)
    obs_mask: jax.Array,  # (N,)
    cauchy_scale: float = 1.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (T_ab (7,), sqrt_info (6,6), strength ()).

    `strength` is the trace of the relative information — callers can skip
    edges that carry no information (e.g. no valid co-observations).
    """
    dtype = T_WS_a.dtype
    L = hp_W.shape[0]
    poses = jnp.stack([T_WS_a, T_WS_b])  # (2, 7)

    # --- 1. linearise all observations wrt (dpose_of_owner (6), dlm (3)) ---
    def one(pi, c, l, uv, si):
        cam = cams.at(c)

        def f(dpose, dhp):
            return reprojection.residual_on_manifold(
                cam, poses[pi], T_SC[c], hp_W[l], uv, si, dpose, dhp,
                jnp.zeros(6, dtype),
            )

        z6 = jnp.zeros(6, dtype)
        z3 = jnp.zeros(3, dtype)
        r = f(z6, z3)
        Jp, Jh = jax.jacfwd(f, argnums=(0, 1))(z6, z3)
        # scatter pose Jacobian into the 12-wide row at column 6*pi
        row = jnp.zeros((2, 12), dtype)
        row = jax.lax.dynamic_update_slice(
            row, Jp, (jnp.int32(0), (pi * 6).astype(jnp.int32))
        )
        valid = reprojection.residual(
            cam, poses[pi], T_SC[c], hp_W[l], uv, si
        )[1]
        return r, row, Jh, valid

    r, Jrow, Jh, valid = jax.vmap(one)(
        obs_pose, obs_cam, obs_lm, obs_uv, obs_sqrt_info
    )
    m = (valid & obs_mask & lm_mask[obs_lm]).astype(dtype)
    s = jnp.sum(r * r, axis=-1)
    w = robust.weight(robust.CAUCHY, s, cauchy_scale) * m
    sw = jnp.sqrt(w)[:, None]
    r = r * sw
    Jrow = Jrow * sw[..., None]
    Jh = Jh * sw[..., None]

    # --- 2. Schur out landmarks ---
    J12 = Jrow.reshape(-1, 12)
    H2 = J12.T @ J12  # (12, 12)
    H_ll = jax.ops.segment_sum(
        jnp.einsum("nri,nrj->nij", Jh, Jh), obs_lm, num_segments=L
    )
    W = jax.ops.segment_sum(
        jnp.einsum("nrp,nri->npi", Jrow, Jh), obs_lm, num_segments=L
    )  # (L, 12, 3)
    eye3 = jnp.eye(3, dtype=dtype)
    lm_ok = (jnp.einsum("lii->l", H_ll) > 1e-9) & lm_mask
    H_ll_inv = jnp.linalg.inv(H_ll + 1e-8 * eye3) * lm_ok.astype(dtype)[:, None, None]
    H2 = H2 - jnp.einsum("lpi,lij,lqj->pq", W, H_ll_inv, W)

    # --- 3. reparametrise to (delta_a, delta_rel) ---
    T_ab = se3.se3_multiply(se3.se3_inverse(T_WS_a), T_WS_b)

    def to_abs(da, drel):
        Ta = se3.retract(T_WS_a, da)
        Tb = se3.se3_multiply(Ta, se3.retract(T_ab, drel))
        db = se3.local_delta(T_WS_b, Tb)
        return jnp.concatenate([da, db])

    z6 = jnp.zeros(6, dtype)
    Aa, Ar = jax.jacfwd(to_abs, argnums=(0, 1))(z6, z6)  # (12,6) each
    A = jnp.concatenate([Aa, Ar], axis=1)  # (12, 12): x = A [da; drel]
    Hy = A.T @ H2 @ A
    H_aa = Hy[:6, :6]
    H_ar = Hy[:6, 6:]
    H_rr = Hy[6:, 6:]

    # --- 4. marginalise the absolute block with pseudo-inverse ---
    ea, Ua = jnp.linalg.eigh(0.5 * (H_aa + H_aa.T))
    tol = jnp.maximum(jnp.max(jnp.abs(ea)), 1.0) * 1e-9
    inv_ea = jnp.where(ea > tol, 1.0 / jnp.where(ea > tol, ea, 1.0), 0.0)
    H_aa_pinv = (Ua * inv_ea[None, :]) @ Ua.T
    H_rel = H_rr - H_ar.T @ H_aa_pinv @ H_ar

    # --- 5. rank-safe sqrt information ---
    er, Ur = jnp.linalg.eigh(0.5 * (H_rel + H_rel.T))
    er_c = jnp.maximum(er, 0.0)
    sqrt_info = (Ur * jnp.sqrt(er_c)[None, :]) @ Ur.T
    strength = jnp.sum(er_c)
    return T_ab, sqrt_info, strength


def two_pose_extrinsics_edge(
    cams: gn.StackedCameras,
    T_WS_a: jax.Array,
    T_WS_b: jax.Array,
    T_SC: jax.Array,  # (C, 7)
    hp_W: jax.Array,
    lm_mask: jax.Array,
    obs_pose: jax.Array,
    obs_cam: jax.Array,
    obs_lm: jax.Array,
    obs_uv: jax.Array,
    obs_sqrt_info: jax.Array,
    obs_mask: jax.Array,
    cauchy_scale: float = 1.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """TwoPoseGraphError variant that ALSO marginalises the camera
    extrinsics T_SC (≙ ceres::TwoPoseExtrinsicsGraphError,
    okvis_ceres/src/TwoPoseExtrinsicsGraphError.cpp): used when online
    extrinsics calibration is active, so the converted pose-graph edge does
    not silently pin the extrinsics at their linearisation point.

    Returns (T_ab (7,), sqrt_info (6,6), strength ()). The relative-pose
    information is never larger than the fixed-extrinsics variant's
    (marginalising extra unknowns can only remove information).
    """
    dtype = T_WS_a.dtype
    L = hp_W.shape[0]
    C = T_SC.shape[0]
    P = 12 + 6 * C
    poses = jnp.stack([T_WS_a, T_WS_b])

    def one(pi, c, l, uv, si):
        cam = cams.at(c)

        def f(dpose, dhp, dext):
            return reprojection.residual_on_manifold(
                cam, poses[pi], T_SC[c], hp_W[l], uv, si, dpose, dhp, dext
            )

        z6 = jnp.zeros(6, dtype)
        z3 = jnp.zeros(3, dtype)
        r = f(z6, z3, z6)
        Jp, Jh, Je = jax.jacfwd(f, argnums=(0, 1, 2))(z6, z3, z6)
        onehot_p = jax.nn.one_hot(pi, 2, dtype=dtype)
        onehot_c = jax.nn.one_hot(c, C, dtype=dtype)
        row_p = jnp.einsum("rd,k->rkd", Jp, onehot_p).reshape(2, 12)
        row_e = jnp.einsum("rd,k->rkd", Je, onehot_c).reshape(2, 6 * C)
        row = jnp.concatenate([row_p, row_e], axis=-1)
        valid = reprojection.residual(
            cam, poses[pi], T_SC[c], hp_W[l], uv, si
        )[1]
        return r, row, Jh, valid

    r, Jrow, Jh, valid = jax.vmap(one)(
        obs_pose, obs_cam, obs_lm, obs_uv, obs_sqrt_info
    )
    m = (valid & obs_mask & lm_mask[obs_lm]).astype(dtype)
    s = jnp.sum(r * r, axis=-1)
    w = robust.weight(robust.CAUCHY, s, cauchy_scale) * m
    sw = jnp.sqrt(w)[:, None]
    r = r * sw
    Jrow = Jrow * sw[..., None]
    Jh = Jh * sw[..., None]

    # Schur out landmarks from the (12 + 6C)-wide system
    Jp = Jrow.reshape(-1, P)
    H = Jp.T @ Jp
    H_ll = jax.ops.segment_sum(
        jnp.einsum("nri,nrj->nij", Jh, Jh), obs_lm, num_segments=L
    )
    W = jax.ops.segment_sum(
        jnp.einsum("nrp,nri->npi", Jrow, Jh), obs_lm, num_segments=L
    )
    eye3 = jnp.eye(3, dtype=dtype)
    lm_ok = (jnp.einsum("lii->l", H_ll) > 1e-9) & lm_mask
    H_ll_inv = (
        jnp.linalg.inv(H_ll + 1e-8 * eye3) * lm_ok.astype(dtype)[:, None, None]
    )
    H = H - jnp.einsum("lpi,lij,lqj->pq", W, H_ll_inv, W)

    # reparametrise the pose block to (delta_a, delta_rel); extrinsics stay
    T_ab = se3.se3_multiply(se3.se3_inverse(T_WS_a), T_WS_b)

    def to_abs(da, drel):
        Ta = se3.retract(T_WS_a, da)
        Tb = se3.se3_multiply(Ta, se3.retract(T_ab, drel))
        db = se3.local_delta(T_WS_b, Tb)
        return jnp.concatenate([da, db])

    z6 = jnp.zeros(6, dtype)
    Aa, Ar = jax.jacfwd(to_abs, argnums=(0, 1))(z6, z6)
    A = jnp.zeros((P, P), dtype)
    A = A.at[:12, :6].set(Aa)
    A = A.at[:12, 6:12].set(Ar)
    A = A.at[12:, 12:].set(jnp.eye(6 * C, dtype=dtype))
    Hy = A.T @ H @ A

    # marginalise gauge (delta_a) AND extrinsics blocks together
    keep = slice(6, 12)
    drop_idx = jnp.concatenate(
        [jnp.arange(6), jnp.arange(12, P)]
    )
    H_dd = Hy[drop_idx][:, drop_idx]
    H_dr = Hy[drop_idx][:, keep]
    H_rr = Hy[keep, keep]
    ed, Ud = jnp.linalg.eigh(0.5 * (H_dd + H_dd.T))
    tol = jnp.maximum(jnp.max(jnp.abs(ed)), 1.0) * 1e-9
    inv_ed = jnp.where(ed > tol, 1.0 / jnp.where(ed > tol, ed, 1.0), 0.0)
    H_dd_pinv = (Ud * inv_ed[None, :]) @ Ud.T
    H_rel = H_rr - H_dr.T @ H_dd_pinv @ H_dr

    er, Ur = jnp.linalg.eigh(0.5 * (H_rel + H_rel.T))
    er_c = jnp.maximum(er, 0.0)
    sqrt_info = (Ur * jnp.sqrt(er_c)[None, :]) @ Ur.T
    strength = jnp.sum(er_c)
    return T_ab, sqrt_info, strength
