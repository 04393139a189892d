"""Bundle-adjustment problem containers (struct-of-arrays, fixed capacity).

This is the JAX replacement for the reference's `okvis::ViGraph`
residual-block bookkeeping (okvis_ceres/include/okvis/ViGraph.hpp:787-838):
instead of a `ceres::Problem` holding pointer-linked parameter blocks and
residual blocks, the whole sliding-window problem is a set of fixed-capacity
arrays with validity masks.  Graph surgery (adding states, marginalising,
freezing) becomes index/mask rewrites on the host; the solver consumes one
static-shape pytree, so XLA compiles a single program per capacity bucket.

Capacities (static): K frames, L landmarks, C cameras, N observations,
M imu links, R relative-pose edges.

Parameter layout of the reduced (frame) system, dimension P = K*15 + C*6:
    frame k: [k*15 : k*15+6]  pose tangent, [k*15+6 : k*15+15] speed/bias
    camera c extrinsics: [K*15 + c*6 : K*15 + (c+1)*6]
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3
from okvis2x_tpu.imu.preintegration import Preintegrated


class BAProblem(NamedTuple):
    # -- frame states -------------------------------------------------------
    T_WS: jax.Array  # (K, 7)
    sb: jax.Array  # (K, 9) [v_W, b_g, b_a]
    frame_valid: jax.Array  # (K,) bool
    pose_fixed: jax.Array  # (K,) bool — freezePosesUntil equivalent
    sb_fixed: jax.Array  # (K,) bool
    # -- extrinsics ---------------------------------------------------------
    T_SC: jax.Array  # (C, 7)
    ext_fixed: jax.Array  # (C,) bool
    # online extrinsics calibration priors (≙ CameraParameters::
    # OnlineCalibrationParameters sigma_r/sigma_alpha, Parameters.hpp:70-80)
    ext_prior_T: jax.Array  # (C, 7)
    ext_prior_sqrt_info: jax.Array  # (C, 6, 6)
    ext_prior_valid: jax.Array  # (C,) bool
    # -- landmarks ----------------------------------------------------------
    hp_W: jax.Array  # (L, 4) homogeneous
    lm_valid: jax.Array  # (L,) bool
    lm_fixed: jax.Array  # (L,) bool
    # -- reprojection observations -----------------------------------------
    obs_frame: jax.Array  # (N,) int32
    obs_cam: jax.Array  # (N,) int32
    obs_lm: jax.Array  # (N,) int32
    obs_uv: jax.Array  # (N, 2)
    obs_sqrt_info: jax.Array  # (N,) scalar whitening (1/sigma_px)
    obs_valid: jax.Array  # (N,) bool
    # -- per-keypoint depth priors (≙ ceres::DepthErrorT, DepthError.hpp:36) -
    obs_depth: jax.Array  # (N,) measured depth in camera frame
    obs_depth_si: jax.Array  # (N,) 1/sigma_depth
    obs_depth_valid: jax.Array  # (N,) bool
    # -- IMU links ----------------------------------------------------------
    imu_i: jax.Array  # (M,) int32 first frame
    imu_j: jax.Array  # (M,) int32 second frame
    imu_pre: Preintegrated  # batched (M, ...)
    imu_sqrt_info: jax.Array  # (M, 15, 15)
    imu_valid: jax.Array  # (M,) bool
    # -- unary priors -------------------------------------------------------
    pose_prior_T: jax.Array  # (K, 7)
    pose_prior_sqrt_info: jax.Array  # (K, 6, 6)
    pose_prior_valid: jax.Array  # (K,) bool
    sb_prior: jax.Array  # (K, 9)
    sb_prior_sqrt_info: jax.Array  # (K, 9, 9)
    sb_prior_valid: jax.Array  # (K,) bool
    # -- relative pose edges (pose graph / extrinsics links) ---------------
    rel_i: jax.Array  # (R,) int32
    rel_j: jax.Array  # (R,) int32
    rel_T: jax.Array  # (R, 7) measured T_ij
    rel_sqrt_info: jax.Array  # (R, 6, 6)
    rel_valid: jax.Array  # (R,) bool
    # -- GNSS: 4-dof world->GPS alignment + position factors ---------------
    T_GW: jax.Array  # (7,)
    tgw_fixed: jax.Array  # () bool
    gps_frame: jax.Array  # (G,) int32 host state
    gps_pre: "Preintegrated"  # batched (G, ...) host-state -> t_g
    gps_p_G: jax.Array  # (G, 3) measured positions in G
    gps_r_SA: jax.Array  # (3,) antenna offset in S
    gps_sqrt_info: jax.Array  # (G, 3, 3)
    gps_valid: jax.Array  # (G,) bool
    # -- per-point submap ICP factors (≙ ceres::SubmapIcpError,
    # okvis_ceres/src/SubmapIcpError.cpp:42-215; live frame-to-map residuals
    # added to the realtime problem at ViGraph.cpp:1470 and re-evaluated
    # every LM iteration).  `icp_map` is the target occupancy grid pytree
    # (mapping.submap.Submap or mapping.brick.BrickSubmap, static shapes);
    # the grid *config* travels statically in SolverConfig.icp_cfg.  The
    # submap anchor keyframe is referenced by window index so both the
    # anchor and the point-owner pose iterate inside the solve. ----------
    icp_a: jax.Array | None = None  # (Q,) int32 anchor (submap) frame
    icp_b: jax.Array | None = None  # (Q,) int32 point-owner frame
    icp_p_B: jax.Array | None = None  # (Q, 3) points in owner body frame
    icp_si: jax.Array | None = None  # (Q,) residual whitening (1/sigma)
    icp_valid: jax.Array | None = None  # (Q,) bool
    icp_map: object = None

    # ----- static helpers --------------------------------------------------
    @property
    def K(self) -> int:
        return self.T_WS.shape[0]

    @property
    def C(self) -> int:
        return self.T_SC.shape[0]

    @property
    def L(self) -> int:
        return self.hp_W.shape[0]

    @property
    def P(self) -> int:
        return self.K * 15 + self.C * 6 + 4


def _empty_pre(M: int, dtype) -> Preintegrated:
    return Preintegrated(
        dq=jnp.tile(se3.quat_identity(dtype), (M, 1)),
        dp=jnp.zeros((M, 3), dtype),
        dv=jnp.zeros((M, 3), dtype),
        dp_dbg=jnp.zeros((M, 3, 3), dtype),
        dp_dba=jnp.zeros((M, 3, 3), dtype),
        dv_dbg=jnp.zeros((M, 3, 3), dtype),
        dv_dba=jnp.zeros((M, 3, 3), dtype),
        dq_dbg=jnp.zeros((M, 3, 3), dtype),
        P=jnp.tile(jnp.eye(15, dtype=dtype), (M, 1, 1)),
        dt=jnp.zeros((M,), dtype),
        lin_bg=jnp.zeros((M, 3), dtype),
        lin_ba=jnp.zeros((M, 3), dtype),
    )


def empty_problem(
    K: int,
    L: int,
    C: int,
    N: int,
    M: int,
    R: int = 0,
    G: int = 1,
    Q: int = 0,
    dtype=jnp.float64,
) -> BAProblem:
    """Allocate an all-invalid problem of the given capacities.

    The dtype is resolved ONCE here (f64 only where x64 is enabled, i.e.
    CPU hosts; f32 on the GPU) so the precision choice is explicit rather than
    a per-array truncation warning."""
    import jax

    dtype = jax.dtypes.canonicalize_dtype(dtype)
    i32 = jnp.int32
    idq = jnp.tile(se3.se3_identity(dtype), (K, 1))
    pre = _empty_pre(M, dtype)
    return BAProblem(
        T_WS=idq,
        sb=jnp.zeros((K, 9), dtype),
        frame_valid=jnp.zeros((K,), bool),
        pose_fixed=jnp.zeros((K,), bool),
        sb_fixed=jnp.zeros((K,), bool),
        T_SC=jnp.tile(se3.se3_identity(dtype), (C, 1)),
        ext_fixed=jnp.ones((C,), bool),
        ext_prior_T=jnp.tile(se3.se3_identity(dtype), (C, 1)),
        ext_prior_sqrt_info=jnp.tile(jnp.eye(6, dtype=dtype), (C, 1, 1)),
        ext_prior_valid=jnp.zeros((C,), bool),
        hp_W=jnp.tile(jnp.array([0, 0, 0, 1], dtype), (L, 1)),
        lm_valid=jnp.zeros((L,), bool),
        lm_fixed=jnp.zeros((L,), bool),
        obs_frame=jnp.zeros((N,), i32),
        obs_cam=jnp.zeros((N,), i32),
        obs_lm=jnp.zeros((N,), i32),
        obs_uv=jnp.zeros((N, 2), dtype),
        obs_sqrt_info=jnp.ones((N,), dtype),
        obs_valid=jnp.zeros((N,), bool),
        obs_depth=jnp.ones((N,), dtype),
        obs_depth_si=jnp.ones((N,), dtype),
        obs_depth_valid=jnp.zeros((N,), bool),
        imu_i=jnp.zeros((M,), i32),
        imu_j=jnp.zeros((M,), i32),
        imu_pre=pre,
        imu_sqrt_info=jnp.tile(jnp.eye(15, dtype=dtype), (M, 1, 1)),
        imu_valid=jnp.zeros((M,), bool),
        pose_prior_T=idq,
        pose_prior_sqrt_info=jnp.tile(jnp.eye(6, dtype=dtype), (K, 1, 1)),
        pose_prior_valid=jnp.zeros((K,), bool),
        sb_prior=jnp.zeros((K, 9), dtype),
        sb_prior_sqrt_info=jnp.tile(jnp.eye(9, dtype=dtype), (K, 1, 1)),
        sb_prior_valid=jnp.zeros((K,), bool),
        rel_i=jnp.zeros((R,), i32),
        rel_j=jnp.zeros((R,), i32),
        rel_T=jnp.tile(se3.se3_identity(dtype), (R, 1)),
        rel_sqrt_info=jnp.tile(jnp.eye(6, dtype=dtype), (R, 1, 1)),
        rel_valid=jnp.zeros((R,), bool),
        T_GW=se3.se3_identity(dtype),
        tgw_fixed=jnp.asarray(True),
        gps_frame=jnp.zeros((G,), i32),
        gps_pre=_empty_pre(G, dtype),
        gps_p_G=jnp.zeros((G, 3), dtype),
        gps_r_SA=jnp.zeros((3,), dtype),
        gps_sqrt_info=jnp.tile(jnp.eye(3, dtype=dtype), (G, 1, 1)),
        gps_valid=jnp.zeros((G,), bool),
        icp_a=jnp.zeros((Q,), i32) if Q else None,
        icp_b=jnp.zeros((Q,), i32) if Q else None,
        icp_p_B=jnp.zeros((Q, 3), dtype) if Q else None,
        icp_si=jnp.ones((Q,), dtype) if Q else None,
        icp_valid=jnp.zeros((Q,), bool) if Q else None,
        icp_map=None,
    )


def free_mask(p: BAProblem) -> jax.Array:
    """(P,) bool — which reduced-system parameters are free to move."""
    pose_free = p.frame_valid & ~p.pose_fixed  # (K,)
    sb_free = p.frame_valid & ~p.sb_fixed
    per_frame = jnp.concatenate(
        [
            jnp.repeat(pose_free[:, None], 6, axis=1),
            jnp.repeat(sb_free[:, None], 9, axis=1),
        ],
        axis=1,
    ).reshape(-1)
    ext_free = jnp.repeat((~p.ext_fixed)[:, None], 6, axis=1).reshape(-1)
    tgw_free = jnp.repeat(jnp.logical_not(p.tgw_fixed)[None], 4, axis=0)
    return jnp.concatenate([per_frame, ext_free, tgw_free])


def apply_delta(p: BAProblem, dx: jax.Array, dl: jax.Array) -> BAProblem:
    """Retract the reduced-system step dx (P,) and landmark step dl (L,3)."""
    from okvis2x_tpu.factors.gps import retract_4dof

    K, C = p.K, p.C
    dframe = dx[: K * 15].reshape(K, 15)
    dT = jax.vmap(se3.retract)(p.T_WS, dframe[:, :6])
    sb = p.sb + dframe[:, 6:]
    dext = dx[K * 15 : K * 15 + C * 6].reshape(C, 6)
    T_SC = jax.vmap(se3.retract)(p.T_SC, dext)
    T_GW = retract_4dof(p.T_GW, dx[K * 15 + C * 6 :])
    hp = p.hp_W.at[:, :3].add(dl)
    return p._replace(T_WS=dT, sb=sb, T_SC=T_SC, T_GW=T_GW, hp_W=hp)
