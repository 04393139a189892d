"""Per-keypoint landmark-depth factor.

JAX counterpart of the reference's `okvis::ceres::DepthErrorT<ONESIDED>`
(okvis_ceres/include/okvis/ceres/DepthError.hpp:36-47,120-180): a 1-dof
residual  r = s · (d_meas − z_C)  on the depth of a landmark in the camera
frame, attached to (pose T_WS, homogeneous point hp_W, extrinsics T_SC).
The one-sided variant ignores the residual when the predicted depth exceeds
the measurement (larger depth is not penalised — used e.g. as a minimum-range
prior, ViGraph.hpp:248-255), and both variants ignore points at infinity
(|w| ≈ 0).

Residuals/Jacobians are produced per observation row in one `vmap`; the
solver folds them into the same Schur-eliminated landmark blocks as the
reprojection factors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


def predicted_depth(T_WS, T_SC, hp_W):
    """z-depth of homogeneous world point in the camera frame; (z, w)."""
    T_WC = se3.se3_multiply(T_WS, T_SC)
    hp_C = se3.se3_apply_homogeneous(se3.se3_inverse(T_WC), hp_W)
    return hp_C[2], hp_C[3]


def residual(T_WS, T_SC, hp_W, d_meas, sqrt_info, onesided: bool):
    """Whitened scalar residual with the reference's gating semantics."""
    z, w = predicted_depth(T_WS, T_SC, hp_W)
    w_safe = jnp.where(jnp.abs(w) < 1e-16, jnp.ones_like(w), w)
    p_z = z / w_safe
    ignore = jnp.abs(w) < 1e-16
    if onesided:
        ignore = ignore | (p_z > d_meas)
    r = sqrt_info * (d_meas - p_z)
    return jnp.where(ignore, jnp.zeros_like(r), r)


def linearize(T_WS, T_SC, hp_W, d_meas, sqrt_info, onesided: bool):
    """Residual + minimal Jacobians (pose 6, point 3, extrinsics 6).

    Autodiff through the manifold retraction at zero increment — the same
    minimal Jacobians as the reference's hand-derived
    `EvaluateWithMinimalJacobians` (DepthError.hpp:181-240).  The one-sided
    gate is applied outside the differentiated function so the Jacobians are
    exactly zero for ignored residuals (as in the reference).
    """
    dtype = T_WS.dtype

    def f(dpose, dl, dext):
        z, w = predicted_depth(
            se3.retract(T_WS, dpose),
            se3.retract(T_SC, dext),
            hp_W.at[:3].add(dl),
        )
        w_safe = jnp.where(jnp.abs(w) < 1e-16, jnp.ones_like(w), w)
        return sqrt_info * (d_meas - z / w_safe)

    z6 = jnp.zeros(6, dtype)
    z3 = jnp.zeros(3, dtype)
    r = f(z6, z3, z6)
    Jp, Jl, Je = jax.jacfwd(f, argnums=(0, 1, 2))(z6, z3, z6)

    z, w = predicted_depth(T_WS, T_SC, hp_W)
    w_safe = jnp.where(jnp.abs(w) < 1e-16, jnp.ones_like(w), w)
    ignore = jnp.abs(w) < 1e-16
    if onesided:
        ignore = ignore | (z / w_safe > d_meas)
    keep = jnp.logical_not(ignore).astype(dtype)
    return r * keep, Jp * keep, Jl * keep, Je * keep
