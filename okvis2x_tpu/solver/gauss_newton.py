"""Batched Gauss-Newton / Levenberg-Marquardt with Schur landmark elimination.

The Ceres replacement (reference: okvis_ceres `ViGraph::optimise` ->
`ceres::Solve` with DENSE_SCHUR, okvis_ceres/src/ViGraph.cpp:1844).  Design:

  * every factor family is linearised in one `vmap` (autodiff through the
    manifold retraction at zero increment — same minimal Jacobians as the
    reference's analytic `EvaluateWithMinimalJacobians`);
  * frame/extrinsic Jacobians are scattered into dense rows of a tall
    (n_res, P) matrix — P = K*15 + C*6 is small (≤ a few hundred), so
    H_ff = J^T J is one dense matmul;
  * landmarks are eliminated with a batched Schur complement:
    3x3 block inverses + one einsum, never materialising the full system;
  * robustification is IRLS: residual/Jacobian scaled by sqrt(rho'(||r||^2))
    (the reference's corrector, TwoPoseGraphError.cpp:282-340);
  * frozen parameters (freezePosesUntil equivalent) are zeroed columns;
  * the LM loop is a `lax.fori_loop` with accept/reject on the robust cost —
    one compiled program, no host round-trips mid-solve.

The same program implements pose-only optimisation (landmarks all fixed),
sliding-window VIO, and full-batch BA — only capacities differ.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.cameras.pinhole import Camera
from okvis2x_tpu.core import se3
from okvis2x_tpu.factors import imu_factor, priors, reprojection, robust
from okvis2x_tpu.imu.preintegration import ImuParams, Preintegrated
from okvis2x_tpu.solver.problem import BAProblem, apply_delta, free_mask


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StackedCameras:
    """Per-rig camera intrinsics stacked for gather-by-obs (uniform model)."""

    fxfycxcy: jax.Array  # (C, 4)
    dist_params: jax.Array  # (C, Pd)
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    model: str = dataclasses.field(metadata=dict(static=True))

    def at(self, idx) -> Camera:
        return Camera(
            fxfycxcy=self.fxfycxcy[idx],
            dist_params=self.dist_params[idx],
            width=self.width,
            height=self.height,
            model=self.model,
        )


def stack_cameras(cams) -> StackedCameras:
    models = {c.model for c in cams}
    assert len(models) == 1, "stacked path requires a uniform distortion model"
    return StackedCameras(
        fxfycxcy=jnp.stack([c.fxfycxcy for c in cams]),
        dist_params=jnp.stack([c.dist_params for c in cams]),
        width=cams[0].width,
        height=cams[0].height,
        model=cams[0].model,
    )


class SolverConfig(NamedTuple):
    max_iterations: int = 10
    reproj_loss: str = robust.CAUCHY
    reproj_loss_scale: float = 1.0  # on whitened (unit-sigma) residuals
    init_lambda: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.5
    estimate_landmarks: bool = True
    imu_params: ImuParams = ImuParams()
    depth_onesided: bool = True  # ≙ ceres::OneSidedDepthError
    use_depth: bool = False  # static: compile depth-prior rows into the solve
    # Online extrinsics calibration: include the T_SC prior rows
    # (≙ OnlineCalibrationParameters; static so calibration-off runs
    # compile no extrinsics-prior kernels).
    use_ext_priors: bool = False
    # Per-point submap ICP rows (≙ ceres::SubmapIcpError): the static grid
    # config (mapping.submap.SubmapConfig or mapping.brick.BrickConfig) of
    # problem.icp_map.  None compiles no ICP kernels.
    icp_cfg: object = None
    # Early exit on convergence (≙ CeresIterationCallback trimming only
    # CONVERGED iterations, okvis_ceres/include/okvis/ceres/
    # CeresIterationCallback.hpp:80): > 0 switches the LM loop to a
    # lax.while_loop that stops once an accepted step's relative cost
    # decrease falls below this tolerance.  Warm-started window solves
    # typically stop at 3-5 instead of the compiled max of 10, trimming
    # only iterations that were not improving the estimate, unlike coarse
    # 3/5/10 iteration buckets (which parked the estimator on an accuracy
    # cliff).
    early_exit_rel: float = 0.0
    early_min_iterations: int = 2
    # Robust loss on relative-pose (pose-graph) edges — the pose-graph
    # solvers set HUBER (≙ the reference robustifying TwoPoseGraphError /
    # loop-closure constraints, okvis_ceres/src/TwoPoseGraphError.cpp:282),
    # bounding the damage one inconsistent high-information edge can do
    # (measured: an unbounded quadratic let a 408-node final pose graph
    # fold to 533 m ATE through monotone cost-DEcreasing LM steps).  The
    # realtime window keeps NONE: its rel edges are marginalisation priors.
    rel_loss: str = robust.NONE
    rel_loss_scale: float = 10.0  # whitened units


# ---------------------------------------------------------------------------
# linearisation
# ---------------------------------------------------------------------------


def _frame_rows(p: BAProblem, blocks, tgw: jax.Array | None = None) -> jax.Array:
    """Assemble batched dense Jacobian rows (n, r, P) from per-frame blocks.

    `blocks` is a list of (J (n, r, 15), frame_idx (n,)) pairs; each block is
    placed at column frame_idx*15 with a one-hot contraction (a matmul)
    instead of a vmapped dynamic_update_slice.  The choice was made where
    scatters serialise; it is untimed against the scatter form on the
    H100.  `tgw` optionally fills the trailing 4-dof T_GW columns."""
    K, C = p.K, p.C
    J0, _ = blocks[0]
    n, r = J0.shape[:2]
    dtype = J0.dtype
    acc = None
    for J, idx in blocks:
        onehot = jax.nn.one_hot(idx, K, dtype=dtype)  # (n, K)
        rows = jnp.einsum("nrd,nk->nrkd", J, onehot).reshape(n, r, K * 15)
        acc = rows if acc is None else acc + rows
    tail_e = jnp.zeros((n, r, C * 6), dtype)
    tail_g = tgw if tgw is not None else jnp.zeros((n, r, 4), dtype)
    return jnp.concatenate([acc, tail_e, tail_g], axis=-1)


def _pad15(J: jax.Array, col0: int) -> jax.Array:
    """Zero-pad a (n, r, w) block into the 15-wide per-frame layout at
    sub-column `col0` (0 = pose, 6 = speed/bias)."""
    n, r, w = J.shape
    dtype = J.dtype
    return jnp.concatenate(
        [
            jnp.zeros((n, r, col0), dtype),
            J,
            jnp.zeros((n, r, 15 - col0 - w), dtype),
        ],
        axis=-1,
    )


def _linearize_reprojection(p: BAProblem, cams: StackedCameras):
    """Returns per-obs (r (N,2), Jrow (N,2,P), Jh (N,2,3), valid (N,)).

    The dense rows are assembled with one-hot matmuls instead of scatters
    (see _frame_rows)."""
    K, C, P = p.K, p.C, p.P
    dtype = p.T_WS.dtype

    def one(f, c, l, uv, si):
        cam = cams.at(c)
        r, Jp, Jh, Je, valid = reprojection.linearize(
            cam, p.T_WS[f], p.T_SC[c], p.hp_W[l], uv, si
        )
        return r, Jp, Je, Jh, valid

    r, Jp, Je, Jh, valid = jax.vmap(one)(
        p.obs_frame, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_sqrt_info
    )
    N = r.shape[0]
    onehot_k = jax.nn.one_hot(p.obs_frame, K, dtype=dtype)  # (N, K)
    onehot_c = jax.nn.one_hot(p.obs_cam, C, dtype=dtype)  # (N, C)
    Jp15 = jnp.concatenate([Jp, jnp.zeros((N, 2, 9), dtype)], axis=-1)
    rows_f = jnp.einsum("nrd,nk->nrkd", Jp15, onehot_k).reshape(N, 2, K * 15)
    rows_e = jnp.einsum("nrd,nc->nrcd", Je, onehot_c).reshape(N, 2, C * 6)
    Jrow = jnp.concatenate(
        [rows_f, rows_e, jnp.zeros((N, 2, 4), dtype)], axis=-1
    )
    valid = valid & p.obs_valid
    return r, Jrow, Jh, valid


def _linearize_depth(p: BAProblem, cfg: SolverConfig):
    """Per-keypoint depth priors on the same observation rows
    (≙ ceres::DepthErrorT): returns (r (N,1), Jrow (N,1,P), Jh (N,1,3))."""
    from okvis2x_tpu.factors import depth as depth_mod

    K, C, P = p.K, p.C, p.P
    dtype = p.T_WS.dtype

    def one(f, c, l, d, si):
        return depth_mod.linearize(
            p.T_WS[f], p.T_SC[c], p.hp_W[l], d, si, cfg.depth_onesided
        )

    r, Jp, Jl, Je = jax.vmap(one)(
        p.obs_frame, p.obs_cam, p.obs_lm, p.obs_depth, p.obs_depth_si
    )
    N = r.shape[0]
    onehot_k = jax.nn.one_hot(p.obs_frame, K, dtype=dtype)
    onehot_c = jax.nn.one_hot(p.obs_cam, C, dtype=dtype)
    Jp15 = jnp.concatenate([Jp, jnp.zeros((N, 9), dtype)], axis=-1)[:, None, :]
    rows_f = jnp.einsum("nrd,nk->nrkd", Jp15, onehot_k).reshape(N, 1, K * 15)
    rows_e = jnp.einsum(
        "nrd,nc->nrcd", Je[:, None, :], onehot_c
    ).reshape(N, 1, C * 6)
    Jrow = jnp.concatenate(
        [rows_f, rows_e, jnp.zeros((N, 1, 4), dtype)], axis=-1
    )
    return r[:, None], Jrow, Jl[:, None, :], p.obs_depth_valid & p.obs_valid


def _linearize_imu(p: BAProblem, cfg: SolverConfig):
    def one(i, j, pre, si):
        def f(d0, dsb0, d1, dsb1):
            return imu_factor.residual_on_manifold(
                cfg.imu_params, pre, si, p.T_WS[i], p.sb[i], p.T_WS[j], p.sb[j],
                d0, dsb0, d1, dsb1,
            )

        z6 = jnp.zeros(6, p.T_WS.dtype)
        z9 = jnp.zeros(9, p.T_WS.dtype)
        r = f(z6, z9, z6, z9)
        J0, Jsb0, J1, Jsb1 = jax.jacfwd(f, argnums=(0, 1, 2, 3))(z6, z9, z6, z9)
        return r, jnp.concatenate([J0, Jsb0], axis=1), jnp.concatenate(
            [J1, Jsb1], axis=1
        )

    r, Ji, Jj = jax.vmap(one)(p.imu_i, p.imu_j, p.imu_pre, p.imu_sqrt_info)
    Jrow = _frame_rows(p, [(Ji, p.imu_i), (Jj, p.imu_j)])
    return r, Jrow, p.imu_valid


def _linearize_priors(p: BAProblem):
    dtype = p.T_WS.dtype

    def pose_one(k, Tp, si):
        def f(d):
            return priors.pose_prior_residual(Tp, se3.retract(p.T_WS[k], d), si)

        z = jnp.zeros(6, dtype)
        return f(z), jax.jacfwd(f)(z)

    ks = jnp.arange(p.K, dtype=jnp.int32)
    r_pp, Jp = jax.vmap(pose_one)(ks, p.pose_prior_T, p.pose_prior_sqrt_info)
    J_pp = _frame_rows(p, [(_pad15(Jp, 0), ks)])

    r_sb = jax.vmap(priors.speed_bias_prior_residual)(
        p.sb_prior, p.sb, p.sb_prior_sqrt_info
    )
    J_sb = _frame_rows(p, [(_pad15(p.sb_prior_sqrt_info, 6), ks)])
    return (r_pp, J_pp, p.pose_prior_valid), (r_sb, J_sb, p.sb_prior_valid)


def _linearize_gps(p: BAProblem, cfg: SolverConfig):
    """GNSS position factors (≙ GpsErrorAsynchronous): rows over
    (host frame pose+sb block, 4-dof T_GW block)."""
    from okvis2x_tpu.factors import gps as gps_mod

    dtype = p.T_WS.dtype

    def one(fi, pre, p_G, si):
        def f(dpose, dsb, d4):
            return gps_mod.residual_async_on_manifold(
                cfg.imu_params, pre, p.T_GW, p.T_WS[fi], p.sb[fi],
                p_G, p.gps_r_SA, si, dpose, dsb, d4,
            )

        z6 = jnp.zeros(6, dtype)
        z9 = jnp.zeros(9, dtype)
        z4 = jnp.zeros(4, dtype)
        r = f(z6, z9, z4)
        Jp, Jsb, J4 = jax.jacfwd(f, argnums=(0, 1, 2))(z6, z9, z4)
        return r, jnp.concatenate([Jp, Jsb], axis=1), J4

    r, Jf, J4 = jax.vmap(one)(p.gps_frame, p.gps_pre, p.gps_p_G, p.gps_sqrt_info)
    Jrow = _frame_rows(p, [(Jf, p.gps_frame)], tgw=J4)
    return r, Jrow, p.gps_valid


def _linearize_ext_priors(p: BAProblem):
    """Unary pose priors on the camera extrinsics T_SC (online calibration;
    ≙ the reference's extrinsics PoseError with sigma_r/sigma_alpha).  Rows
    target the extrinsics columns [K*15 + c*6 : K*15 + (c+1)*6]."""
    dtype = p.T_WS.dtype
    K, C = p.K, p.C

    def one(c, Tp, si):
        def f(d):
            return priors.pose_prior_residual(Tp, se3.retract(p.T_SC[c], d), si)

        z = jnp.zeros(6, dtype)
        return f(z), jax.jacfwd(f)(z)

    cs = jnp.arange(C, dtype=jnp.int32)
    r, J = jax.vmap(one)(cs, p.ext_prior_T, p.ext_prior_sqrt_info)  # (C,6),(C,6,6)
    onehot = jax.nn.one_hot(cs, C, dtype=dtype)  # (C, C)
    rows_e = jnp.einsum("nrd,nc->nrcd", J, onehot).reshape(C, 6, C * 6)
    Jrow = jnp.concatenate(
        [
            jnp.zeros((C, 6, K * 15), dtype),
            rows_e,
            jnp.zeros((C, 6, 4), dtype),
        ],
        axis=-1,
    )
    return r, Jrow, p.ext_prior_valid


def _so3_left_jacobian_inv(phi: jax.Array) -> jax.Array:
    """Inverse left Jacobian of SO(3) at rotation vector phi:
    Jl^{-1} = I - phi_x/2 + c(theta) phi_x^2, Taylor-safe (c -> 1/12)."""
    dtype = phi.dtype
    th2 = jnp.sum(phi * phi)
    th = jnp.sqrt(jnp.maximum(th2, 1e-24))
    small = th2 < 1e-10
    c = jnp.where(
        small,
        1.0 / 12.0 + th2 / 720.0,
        1.0 / jnp.maximum(th2, 1e-24)
        - (1.0 + jnp.cos(th)) / jnp.maximum(2.0 * th * jnp.sin(th), 1e-24),
    )
    px = se3.cross_matrix(phi)
    return jnp.eye(3, dtype=dtype) - 0.5 * px + c * (px @ px)


def rel_residual_jacobians(T_A, T_B, Trel, si):
    """Whitened relative-pose residual + closed-form minimal Jacobians for
    one edge (≙ RelativePoseError::EvaluateWithMinimalJacobians; autodiff
    through the quaternion chain emits ~200 unfused kernels for the same
    math — ~7x the launches).  Shared by the dense window solver and the
    edge-sharded distributed pose-graph solver (parallel/dist_posegraph)."""
    dtype = T_A.dtype
    q_A = se3.se3_q(T_A)
    R_AT = se3.quat_to_matrix(se3.quat_conjugate(q_A))  # R_A^T
    D = se3.se3_t(T_B) - se3.se3_t(T_A)  # world-frame baseline
    t_AB = R_AT @ D
    q_AB = se3.quat_multiply(se3.quat_conjugate(q_A), se3.se3_q(T_B))
    e0 = se3.quat_multiply(q_AB, se3.quat_conjugate(se3.se3_q(Trel)))
    phi = se3.quat_log(e0)
    r = si @ jnp.concatenate([t_AB - se3.se3_t(Trel), phi])
    # world-frame left perturbations (retract: q <- dq(a) q) map into the
    # error log through R_A^T; the exact log derivative is Jl^{-1}(phi)
    JlR = _so3_left_jacobian_inv(phi) @ R_AT
    Z = jnp.zeros((3, 3), dtype)
    Ji = si @ jnp.block([[-R_AT, R_AT @ se3.cross_matrix(D)], [Z, -JlR]])
    Jj = si @ jnp.block([[R_AT, Z], [Z, JlR]])
    return r, Ji, Jj


def _linearize_icp(p: BAProblem, cfg: SolverConfig):
    """Per-point submap ICP rows (≙ SubmapIcpError::
    EvaluateWithMinimalJacobians, okvis_ceres/src/SubmapIcpError.cpp:42):
    residual of each measured point against the occupancy field of the
    submap anchored at window frame icp_a, with Jacobians wrt BOTH the
    anchor and the owner pose — the rows iterate inside LM like every
    other factor family instead of being frozen into a relative-pose
    edge before the solve."""
    from okvis2x_tpu.mapping import icp_factor

    scfg = cfg.icp_cfg
    dtype = p.T_WS.dtype
    one_true = jnp.ones((1,), bool)

    def one(a, b, pt, si):
        def f(da, db):
            r, _ = icp_factor.icp_residuals(
                p.icp_map, scfg,
                se3.retract(p.T_WS[a], da), se3.retract(p.T_WS[b], db),
                pt[None, :], one_true, sigma=1.0,
            )
            return r[0] * si

        z6 = jnp.zeros(6, dtype)
        r = f(z6, z6)
        Ja, Jb = jax.jacfwd(f, argnums=(0, 1))(z6, z6)
        _, use = icp_factor.icp_residuals(
            p.icp_map, scfg, p.T_WS[a], p.T_WS[b], pt[None, :], one_true,
            sigma=1.0,
        )
        return r, Ja, Jb, use[0]

    r, Ja, Jb, use = jax.vmap(one)(p.icp_a, p.icp_b, p.icp_p_B, p.icp_si)
    Jrow = _frame_rows(
        p,
        [
            (_pad15(Ja[:, None, :], 0), p.icp_a),
            (_pad15(Jb[:, None, :], 0), p.icp_b),
        ],
    )
    return r[:, None], Jrow, use & p.icp_valid


def _icp_enabled(p: BAProblem, cfg: SolverConfig) -> bool:
    return (
        cfg.icp_cfg is not None
        and p.icp_a is not None
        and p.icp_a.shape[0] > 0
        and p.icp_map is not None
    )


def _linearize_rel(p: BAProblem, cfg: SolverConfig = SolverConfig()):
    """Relative-pose (pose-graph / marginalisation / extrinsics-link) rows;
    IRLS-robustified per `cfg.rel_loss` (NONE in the realtime window)."""

    def one(i, j, Trel, si):
        return rel_residual_jacobians(p.T_WS[i], p.T_WS[j], Trel, si)

    r, Ji, Jj = jax.vmap(one)(p.rel_i, p.rel_j, p.rel_T, p.rel_sqrt_info)
    if cfg.rel_loss != robust.NONE:
        s = jnp.sum(r * r, axis=-1)
        sw = jnp.sqrt(robust.weight(cfg.rel_loss, s, cfg.rel_loss_scale))
        r = r * sw[:, None]
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
    Jrow = _frame_rows(
        p, [(_pad15(Ji, 0), p.rel_i), (_pad15(Jj, 0), p.rel_j)]
    )
    return r, Jrow, p.rel_valid


# ---------------------------------------------------------------------------
# normal equations + Schur
# ---------------------------------------------------------------------------


class Linearization(NamedTuple):
    H_ff: jax.Array  # (P, P)
    b_f: jax.Array  # (P,)
    H_ll: jax.Array  # (L, 3, 3)
    b_l: jax.Array  # (L, 3)
    W: jax.Array  # (L, P, 3) frame-landmark coupling
    lm_free: jax.Array  # (L,)
    cost: jax.Array  # robustified total cost


def linearize(p: BAProblem, cams: StackedCameras, cfg: SolverConfig) -> Linearization:
    dtype = p.T_WS.dtype
    P, L = p.P, p.L

    r_o, Jrow_o, Jh_o, valid_o = _linearize_reprojection(p, cams)
    s = jnp.sum(r_o * r_o, axis=-1)
    w = robust.weight(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid_o
    cost = 0.5 * jnp.sum(robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid_o)
    sw = jnp.sqrt(w)[:, None]
    r_o = r_o * sw
    Jrow_o = Jrow_o * sw[..., None]
    Jh_o = Jh_o * sw[..., None]

    fmask = free_mask(p).astype(dtype)  # (P,)
    Jrow_o = Jrow_o * fmask[None, None, :]

    # frame-frame from reprojection
    Jo = Jrow_o.reshape(-1, P)
    ro = r_o.reshape(-1)
    H_ff = Jo.T @ Jo
    b_f = -(Jo.T @ ro)

    # landmark blocks via segment sums over observations
    lm_free = p.lm_valid & ~p.lm_fixed
    if not cfg.estimate_landmarks:
        lm_free = jnp.zeros_like(lm_free)
    # zero Jh for obs pointing at fixed landmarks
    lm_free_f = lm_free.astype(dtype)
    Jh_o = Jh_o * lm_free_f[p.obs_lm][:, None, None]

    # landmark blocks via one-hot matmuls (scatter-free, see _frame_rows)
    onehot_l = jax.nn.one_hot(p.obs_lm, L, dtype=dtype)  # (N, L)
    HtJ = jnp.einsum("nri,nrj->nij", Jh_o, Jh_o)  # (N,3,3)
    H_ll = jnp.einsum("nl,nij->lij", onehot_l, HtJ)
    b_l = -jnp.einsum("nl,ni->li", onehot_l, jnp.einsum("nri,nr->ni", Jh_o, r_o))
    Wn = jnp.einsum("nrp,nri->npi", Jrow_o, Jh_o)  # (N,P,3)
    W = jnp.einsum("nl,npi->lpi", onehot_l, Wn)

    # per-keypoint depth priors (share obs rows; Schur-eliminated like reproj)
    if cfg.use_depth:
        r_d, Jrow_d, Jh_d, valid_d = _linearize_depth(p, cfg)
        md = valid_d.astype(dtype)[:, None]
        r_d = r_d * md
        Jrow_d = Jrow_d * md[..., None] * fmask[None, None, :]
        Jh_d = Jh_d * md[..., None] * lm_free_f[p.obs_lm][:, None, None]
        Jd = Jrow_d.reshape(-1, P)
        rd = r_d.reshape(-1)
        H_ff = H_ff + Jd.T @ Jd
        b_f = b_f - Jd.T @ rd
        cost = cost + 0.5 * jnp.sum(rd * rd)
        HtJd = jnp.einsum("nri,nrj->nij", Jh_d, Jh_d)
        H_ll = H_ll + jnp.einsum("nl,nij->lij", onehot_l, HtJd)
        b_l = b_l - jnp.einsum(
            "nl,ni->li", onehot_l, jnp.einsum("nri,nr->ni", Jh_d, r_d)
        )
        Wd = jnp.einsum("nrp,nri->npi", Jrow_d, Jh_d)
        W = W + jnp.einsum("nl,npi->lpi", onehot_l, Wd)

    # IMU links, priors, relative-pose and GNSS factors: every small dense-row
    # family masked then stacked into ONE (M, P) system — a single matmul
    # instead of four kernel chains.  Families with zero static
    # capacity are skipped at trace time: their residual chains emit
    # hundreds of tiny unfused kernels (jacfwd through quaternion math),
    # pure overhead when a window carries no such factors.
    (r_pp, J_pp, v_pp), (r_sb, J_sb, v_sb) = _linearize_priors(p)
    fams = [(r_pp, J_pp, v_pp), (r_sb, J_sb, v_sb)]
    if p.imu_i.shape[0]:
        fams.append(_linearize_imu(p, cfg))
    if p.rel_i.shape[0]:
        fams.append(_linearize_rel(p, cfg))
    if p.gps_frame.shape[0]:
        fams.append(_linearize_gps(p, cfg))
    if cfg.use_ext_priors:
        fams.append(_linearize_ext_priors(p))
    if _icp_enabled(p, cfg):
        fams.append(_linearize_icp(p, cfg))
    rs, Js = [], []
    for r_, J_, v_ in fams:
        m = v_.astype(dtype)
        rs.append((r_ * m[:, None]).reshape(-1))
        Js.append((J_ * m[:, None, None]).reshape(-1, P))
    r_s = jnp.concatenate(rs)
    J_s = jnp.concatenate(Js) * fmask[None, :]
    H_ff = H_ff + J_s.T @ J_s
    b_f = b_f - J_s.T @ r_s
    cost = cost + 0.5 * jnp.sum(r_s * r_s)

    # gauge fixing for frozen / invalid params
    fmask_b = fmask > 0
    H_ff = jnp.where(
        (fmask_b[:, None] & fmask_b[None, :]), H_ff, jnp.zeros_like(H_ff)
    ) + jnp.diag((~fmask_b).astype(dtype))
    b_f = b_f * fmask

    return Linearization(H_ff, b_f, H_ll, b_l, W, lm_free, cost)


def compute_cost(p: BAProblem, cams: StackedCameras, cfg: SolverConfig) -> jax.Array:
    """Robustified total cost without Jacobians (for LM accept/reject)."""
    dtype = p.T_WS.dtype

    def obs_one(f, c, l, uv, si):
        r, valid = reprojection.residual(
            cams.at(c), p.T_WS[f], p.T_SC[c], p.hp_W[l], uv, si
        )
        return r, valid

    r_o, valid = jax.vmap(obs_one)(
        p.obs_frame, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_sqrt_info
    )
    valid = valid & p.obs_valid
    s = jnp.sum(r_o * r_o, axis=-1)
    cost = 0.5 * jnp.sum(
        robust.rho(cfg.reproj_loss, s, cfg.reproj_loss_scale) * valid
    )

    if cfg.use_depth:
        from okvis2x_tpu.factors import depth as depth_mod

        r_d = jax.vmap(
            lambda f, c, l, d, si: depth_mod.residual(
                p.T_WS[f], p.T_SC[c], p.hp_W[l], d, si, cfg.depth_onesided
            )
        )(p.obs_frame, p.obs_cam, p.obs_lm, p.obs_depth, p.obs_depth_si)
        vd = (p.obs_depth_valid & p.obs_valid).astype(dtype)
        cost = cost + 0.5 * jnp.sum((r_d * vd) ** 2)

    def imu_one(i, j, pre, si):
        return imu_factor.residual(
            cfg.imu_params, pre, si, p.T_WS[i], p.sb[i], p.T_WS[j], p.sb[j]
        )

    if p.imu_i.shape[0]:
        r_i = jax.vmap(imu_one)(p.imu_i, p.imu_j, p.imu_pre, p.imu_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_i * p.imu_valid.astype(dtype)[:, None]) ** 2
        )

    ks = jnp.arange(p.K, dtype=jnp.int32)
    r_pp = jax.vmap(
        lambda k, Tp, si: priors.pose_prior_residual(Tp, p.T_WS[k], si)
    )(ks, p.pose_prior_T, p.pose_prior_sqrt_info)
    cost = cost + 0.5 * jnp.sum((r_pp * p.pose_prior_valid.astype(dtype)[:, None]) ** 2)
    r_sb = jax.vmap(
        lambda k, sbp, si: priors.speed_bias_prior_residual(sbp, p.sb[k], si)
    )(ks, p.sb_prior, p.sb_prior_sqrt_info)
    cost = cost + 0.5 * jnp.sum((r_sb * p.sb_prior_valid.astype(dtype)[:, None]) ** 2)

    if p.rel_i.shape[0]:
        r_r = jax.vmap(
            lambda i, j, Tr, si: priors.relative_pose_residual(
                Tr, p.T_WS[i], p.T_WS[j], si
            )
        )(p.rel_i, p.rel_j, p.rel_T, p.rel_sqrt_info)
        s_r = jnp.sum(r_r * r_r, axis=-1) * p.rel_valid.astype(dtype)
        cost = cost + 0.5 * jnp.sum(
            robust.rho(cfg.rel_loss, s_r, cfg.rel_loss_scale)
        )

    if p.gps_frame.shape[0]:
        from okvis2x_tpu.factors import gps as gps_mod

        r_g = jax.vmap(
            lambda fi, pre, pg, si: gps_mod.residual_async(
                cfg.imu_params, pre, p.T_GW, p.T_WS[fi], p.sb[fi], pg,
                p.gps_r_SA, si,
            )
        )(p.gps_frame, p.gps_pre, p.gps_p_G, p.gps_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_g * p.gps_valid.astype(dtype)[:, None]) ** 2
        )

    if cfg.use_ext_priors:
        r_e = jax.vmap(
            lambda c, Tp, si: priors.pose_prior_residual(Tp, p.T_SC[c], si)
        )(jnp.arange(p.C, dtype=jnp.int32), p.ext_prior_T,
          p.ext_prior_sqrt_info)
        cost = cost + 0.5 * jnp.sum(
            (r_e * p.ext_prior_valid.astype(dtype)[:, None]) ** 2
        )

    if _icp_enabled(p, cfg):
        from okvis2x_tpu.mapping import icp_factor

        one_true = jnp.ones((1,), bool)

        def icp_one(a, b, pt, si):
            r, use = icp_factor.icp_residuals(
                p.icp_map, cfg.icp_cfg, p.T_WS[a], p.T_WS[b],
                pt[None, :], one_true, sigma=1.0,
            )
            return r[0] * si, use[0]

        r_icp, use_icp = jax.vmap(icp_one)(
            p.icp_a, p.icp_b, p.icp_p_B, p.icp_si
        )
        m = (use_icp & p.icp_valid).astype(dtype)
        cost = cost + 0.5 * jnp.sum((r_icp * m) ** 2)
    return cost


def _inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate/determinant).

    Pure elementwise ops that fuse into neighbouring kernels, where XLA's
    batched LU `linalg.inv` would be a separate factorisation."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    co_d = -(b * i - c * h)
    co_e = a * i - c * g
    co_f = -(a * h - b * g)
    co_g = b * f - c * e
    co_h = -(a * f - c * d)
    co_i = a * e - b * d
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [
            jnp.stack([co_a, co_d, co_g], axis=-1),
            jnp.stack([co_b, co_e, co_h], axis=-1),
            jnp.stack([co_c, co_f, co_i], axis=-1),
        ],
        axis=-2,
    )
    safe = jnp.where(jnp.abs(det) > jnp.finfo(m.dtype).tiny, det, 1.0)
    return adj / safe[..., None, None]


def solve_normal_equations(
    lin: Linearization, lam: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Schur-complement solve: returns (dx (P,), dl (L,3))."""
    dtype = lin.H_ff.dtype
    P = lin.H_ff.shape[0]
    L = lin.H_ll.shape[0]
    eye3 = jnp.eye(3, dtype=dtype)

    lm_free_f = lin.lm_free.astype(dtype)[:, None, None]
    H_ll_d = lin.H_ll + (lam + 1e-12) * jnp.einsum(
        "lii->l", lin.H_ll
    )[:, None, None] / 3.0 * eye3 + 1e-10 * eye3
    H_ll_inv = _inv3x3(H_ll_d) * lm_free_f  # masked: fixed lms contribute 0

    # Schur complement onto the frame system
    WHinv = jnp.einsum("lpi,lij->lpj", lin.W, H_ll_inv)  # (L,P,3)
    H_red = lin.H_ff - jnp.einsum("lpi,lqi->pq", WHinv, lin.W)
    b_red = lin.b_f - jnp.einsum("lpi,li->p", WHinv, lin.b_l)

    # LM damping on the reduced system (scaled by diagonal, Marquardt style)
    diag = jnp.diag(H_red)
    H_red = H_red + jnp.diag(lam * diag + 1e-12)

    # Jacobi-scaled inverse-multiply (chosen over cholesky/triangular_solve
    # on another backend; untimed against them on the H100).  The raw
    # reduced camera system's condition number grows with node count
    # (mixed px/rad/m/s units); unscaled f32 inversion degrades visibly
    # beyond ~80 frames (final BA), while the
    # symmetrically scaled system D H D (unit diagonal) stays solvable
    # (SURVEY §7.3 hard part 5: f32 + scaling instead of f64).
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diag(H_red)), 1e-20))
    Dinv = 1.0 / d
    Hs = H_red * Dinv[:, None] * Dinv[None, :]
    bs = b_red * Dinv
    if P <= 1024:
        dy = jnp.linalg.inv(Hs) @ bs
    else:
        # batch/final-BA scale: an O(P^3) factorisation is the wrong tool
        # — conjugate gradients on the Jacobi-scaled damped reduced camera
        # system are bandwidth-bound matvecs (the standard large-scale BA
        # recipe: sparse Schur + PCG).
        def cg_step(state, _):
            x, r, pv, rs = state
            Hp = Hs @ pv
            alpha = rs / jnp.maximum(pv @ Hp, 1e-30)
            x = x + alpha * pv
            r = r - alpha * Hp
            rs_new = r @ r
            pv = r + (rs_new / jnp.maximum(rs, 1e-30)) * pv
            return (x, r, pv, rs_new), None

        x0 = jnp.zeros_like(bs)
        (dy, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, bs, bs, bs @ bs), None, length=256
        )
    dx = dy * Dinv
    dx = jnp.where(jnp.isfinite(dx), dx, jnp.zeros_like(dx))

    # back-substitute landmarks; guard rank-deficient blocks (landmarks with
    # too few / degenerate observations have ~zero trace, the relative
    # damping vanishes and the f32 inverse can blow up or NaN)
    dl = jnp.einsum(
        "lij,lj->li", H_ll_inv, lin.b_l - jnp.einsum("lpi,p->li", lin.W, dx)
    )
    tr = jnp.einsum("lii->l", lin.H_ll)
    ok = jnp.isfinite(dl).all(axis=1) & (tr > 10 * jnp.finfo(dtype).tiny)
    dl = jnp.where(ok[:, None], dl, jnp.zeros_like(dl))
    return dx, dl


def optimize(
    p: BAProblem, cams: StackedCameras, cfg: SolverConfig
) -> Tuple[BAProblem, jax.Array]:
    """LM loop (fixed max_iterations, accept/reject; one compiled program).

    Returns the optimised problem and the final robust cost.

    The loop carries ONLY the mutable parameters (poses, speed/bias,
    extrinsics, landmarks, T_GW) — the full problem pytree has ~65 leaves,
    and a loop carry may copy every leaf each iteration.
    """

    def inject(params):
        T_WS, sb, T_SC, hp_W, T_GW = params
        return p._replace(T_WS=T_WS, sb=sb, T_SC=T_SC, hp_W=hp_W, T_GW=T_GW)

    def extract(prob):
        return (prob.T_WS, prob.sb, prob.T_SC, prob.hp_W, prob.T_GW)

    def body(_, carry):
        """Deferred accept/reject ("delayed gratification" LM): ONE
        linearization per iteration — its robust cost doubles as the
        accept test for the PREVIOUS step, halving residual evaluations
        vs the classic linearize+compute_cost pair.  On reject we revert
        to the backup point and re-linearize there next iteration."""
        params, backup, lam, best_cost = carry
        prob = inject(params)
        lin = linearize(prob, cams, cfg)
        accept = lin.cost <= best_cost
        # where we step from: current point if accepted, else the backup
        params_eff = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), params, backup
        )
        backup = params_eff
        best_cost = jnp.minimum(lin.cost, best_cost)
        lam = jnp.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
        lam = jnp.clip(lam, 1e-10, 1e6)
        # on reject the linearization is at the rejected point; stepping
        # from the backup with it would be inconsistent, so only step when
        # accepted (the rejected iteration is spent re-raising lambda).
        dx, dl = solve_normal_equations(lin, lam)
        cand = apply_delta(prob, dx, dl)
        params = jax.tree.map(
            lambda c, b: jnp.where(accept, c, b), extract(cand), backup
        )
        return params, backup, lam, best_cost

    lam0 = jnp.asarray(cfg.init_lambda, p.T_WS.dtype)
    inf = jnp.asarray(jnp.inf, p.T_WS.dtype)
    params0 = extract(p)
    carry = (params0, params0, lam0, inf)
    if cfg.early_exit_rel > 0:
        # convergence-gated LM: stop once an ACCEPTED step's relative cost
        # decrease drops below tolerance, so the device skips iterations
        # that were no longer improving the estimate
        tol = jnp.asarray(cfg.early_exit_rel, p.T_WS.dtype)

        def exit_test(i, prev_best, best):
            # only an ACCEPTED improving step can signal convergence: a
            # rejected step also leaves best_cost unchanged (rel = 0) but
            # means "raise lambda and retry", not "converged"
            rel = (prev_best - best) / jnp.maximum(prev_best, 1e-30)
            return (
                (i + 1 >= cfg.early_min_iterations)
                & jnp.isfinite(prev_best)
                & (best < prev_best)
                & (rel < tol)
            )

        # a rolled while_loop: unrolled iterations compiled 5-6x slower on
        # an H100 and solved no faster
        def w_cond(state):
            i, done, _ = state
            return (i < cfg.max_iterations) & ~done

        def w_body(state):
            i, _, carry = state
            prev_best = carry[3]
            carry = body(i, carry)
            done = exit_test(i, prev_best, carry[3])
            return i + 1, done, carry

        _, _, carry = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), jnp.bool_(False), carry)
        )
        params, backup, _, best_cost = carry
    else:
        params, backup, _, best_cost = jax.lax.fori_loop(
            0, cfg.max_iterations, body, carry
        )
    # the final step was never cost-checked; return the last accepted point
    final_cost = compute_cost(inject(params), cams, cfg)
    take_last = final_cost <= best_cost
    params = jax.tree.map(
        lambda a, b: jnp.where(take_last, a, b), params, backup
    )
    return inject(params), jnp.minimum(final_cost, best_cost)
