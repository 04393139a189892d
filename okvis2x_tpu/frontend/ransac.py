"""Vectorised RANSAC pose solvers.

Replaces the reference's opengv-based RANSAC glue (okvis_frontend
`runRansac3d2d` Frontend.cpp:2449, `runRansac2d2d` :2520, the opengv
adapters, and `verifyRecognisedPlace` :258) with batched
hypothesis scoring: all hypotheses are solved and scored at once (matmuls /
batched 3x3 linear algebra) instead of the sequential sample-test loop —
RANSAC as one fused device program.

Solvers:
  * `absolute_pose_known_rotation` — position-only RANSAC: with the
    IMU-predicted orientation (gravity-observable), each 2-point sample
    yields a linear system for the camera position; mirrors how the
    reference leans on the pose prediction for 3D-2D association.
  * `absolute_pose_p3p_refined` — full 6-dof: 3-point hypotheses solved by
    Kabsch on triangle-aligned point triples (closed-form batched),
    followed by inlier rescoring.
  * `relative_rotation_2pt` — rotation-only 2-point RANSAC for the
    stationary / pure-rotation frontend checks (≙ FrameRotationOnlySacProblem).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


class RansacResult(NamedTuple):
    T: jax.Array  # best model: pose (7,) or quaternion-only encoded in T[3:7]
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array  # ()


def _sample_indices(key, n_hyp, sample_size, n):
    """(n_hyp, sample_size) random index matrix (with replacement across
    hypotheses; distinct within a hypothesis by rejection-free offsetting)."""
    base = jax.random.randint(key, (n_hyp, sample_size), 0, n)
    # de-duplicate within rows by linear probing offsets (cheap approximation)
    offs = jnp.arange(sample_size)[None, :]
    return (base + offs * 7919) % n


def absolute_pose_known_rotation(
    key: jax.Array,
    q_WC: jax.Array,  # (4,) known/predicted camera orientation
    rays_C: jax.Array,  # (N, 3) unit bearing vectors in camera frame
    pts_W: jax.Array,  # (N, 3) corresponding world points
    mask: jax.Array,  # (N,)
    n_hyp: int = 256,
    threshold_rad: float = 0.012,
):
    """Position RANSAC with known rotation.

    Each 2-point sample: X_i = t + d_i * (C_WC r_i).  Eliminating depths via
    cross products gives a linear 6x3 LSQ for t per hypothesis, solved in
    closed form (normal equations, batched 3x3 inverse).
    Score: angular residual between predicted and measured bearings.
    """
    n = rays_C.shape[0]
    C_WC = se3.quat_to_matrix(q_WC)
    rays_W = rays_C @ C_WC.T  # (N, 3)

    idx = _sample_indices(key, n_hyp, 2, n)  # (H, 2)
    r = rays_W[idx]  # (H, 2, 3)
    X = pts_W[idx]  # (H, 2, 3)

    # For each point: [r]_x (X - t) = 0  ->  [r]_x t = [r]_x X
    A = jax.vmap(jax.vmap(se3.cross_matrix))(r)  # (H, 2, 3, 3)
    b = jnp.einsum("hpij,hpj->hpi", A, X)  # (H, 2, 3)
    AtA = jnp.einsum("hpij,hpik->hjk", A, A)  # (H, 3, 3)
    Atb = jnp.einsum("hpij,hpi->hj", A, b)
    t = jnp.linalg.solve(
        AtA + 1e-9 * jnp.eye(3, dtype=rays_C.dtype), Atb[..., None]
    )[..., 0]  # (H, 3)

    # score all hypotheses: bearing from t to all points vs measured rays
    d = pts_W[None, :, :] - t[:, None, :]  # (H, N, 3)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("hnj,nj->hn", d, rays_W)
    inl = (cosang > jnp.cos(threshold_rad)) & mask[None, :]
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    T = jnp.concatenate([t[best], q_WC])
    return RansacResult(T=T, inliers=inl[best], num_inliers=scores[best])


def absolute_pose_p3p_refined(
    key: jax.Array,
    rays_C: jax.Array,  # (N, 3) unit bearings
    pts_W: jax.Array,  # (N, 3)
    mask: jax.Array,
    depth_guess: jax.Array,  # (N,) rough depths (e.g. from map landmarks)
    n_hyp: int = 512,
    threshold_rad: float = 0.012,
):
    """Full 6-dof hypothesis RANSAC.

    Hypothesis from 3 correspondences: place the 3 points at the guessed
    depths along their rays in C, then solve the rigid alignment C<-W by
    Kabsch (batched SVD-free via quaternion from the 3x3 correlation).
    The depth guesses only shape the hypotheses — scoring is angular and
    depth-free, so biased guesses cost iterations, not correctness.
    """
    n = rays_C.shape[0]
    idx = _sample_indices(key, n_hyp, 3, n)
    r = rays_C[idx]  # (H, 3, 3)
    d = depth_guess[idx][..., None]
    Pc = r * d  # (H, 3, 3) points in camera frame
    Pw = pts_W[idx]

    # Kabsch: R = argmin ||(Pc - cc) - R (Pw - cw)||
    cc = Pc.mean(axis=1, keepdims=True)
    cw = Pw.mean(axis=1, keepdims=True)
    H3 = jnp.einsum("hpi,hpj->hij", Pc - cc, Pw - cw)  # (H, 3, 3)
    U, S, Vt = jnp.linalg.svd(H3)
    det = jnp.linalg.det(jnp.einsum("hij,hjk->hik", U, Vt))
    D = jnp.stack(
        [jnp.ones_like(det), jnp.ones_like(det), det], axis=-1
    )
    R = jnp.einsum("hij,hj,hjk->hik", U, D, Vt)  # (H, 3, 3) C<-W
    t = (cc[:, 0] - jnp.einsum("hij,hj->hi", R, cw[:, 0]))  # (H, 3)

    # score: all points into camera frame, angular residual
    pc = jnp.einsum("hij,nj->hni", R, pts_W) + t[:, None, :]
    pcn = pc / jnp.maximum(jnp.linalg.norm(pc, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("hni,ni->hn", pcn, rays_C)
    inl = (cosang > jnp.cos(threshold_rad)) & mask[None, :] & (pc[..., 2] > 0)
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    # T_CW -> T_WC for the returned pose
    q_CW = se3.matrix_to_quat(R[best])
    T_CW = jnp.concatenate([t[best], q_CW])
    T_WC = se3.se3_inverse(T_CW)
    return RansacResult(T=T_WC, inliers=inl[best], num_inliers=scores[best])


def absolute_pose_noncentral(
    key: jax.Array,
    rays_S: jax.Array,  # (N, 3) unit bearings in the BODY (sensor) frame
    origins_S: jax.Array,  # (N, 3) per-ray camera centres in the body frame
    pts_W: jax.Array,  # (N, 3) corresponding world points
    mask: jax.Array,
    depth_guess: jax.Array,  # (N,) rough depths along each ray
    n_hyp: int = 512,
    threshold_rad: float = 0.012,
):
    """Generalized (non-central) absolute pose RANSAC over a multi-camera
    rig (≙ opengv's GP3P through the reference's
    FrameNoncentralAbsoluteAdapter, okvis_frontend/include/okvis/
    FrameNoncentralAbsoluteAdapter.hpp): rays carry per-camera origins, so
    correspondences from every camera verify one body pose together.

    Hypotheses: 3 correspondences (possibly from different cameras) place
    points at origin + d*ray in the body frame; batched Kabsch aligns them
    to the world points — generalized resection with guessed depths.
    Scoring is angular about each ray's own origin (depth-free).

    Callers pad to a fixed capacity with the VALID ROWS AS A PREFIX:
    hypothesis sampling draws from the first sum(mask) rows only (sampling
    over the padded capacity would waste most triples on zero rows)."""
    n_eff = jnp.maximum(jnp.sum(mask), 3)
    idx = _sample_indices(key, n_hyp, 3, n_eff)
    r = rays_S[idx]  # (H, 3, 3)
    o = origins_S[idx]
    d = depth_guess[idx][..., None]
    Ps = o + r * d  # (H, 3, 3) points in body frame
    Pw = pts_W[idx]

    cc = Ps.mean(axis=1, keepdims=True)
    cw = Pw.mean(axis=1, keepdims=True)
    H3 = jnp.einsum("hpi,hpj->hij", Ps - cc, Pw - cw)  # (H, 3, 3)
    U, S, Vt = jnp.linalg.svd(H3)
    det = jnp.linalg.det(jnp.einsum("hij,hjk->hik", U, Vt))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = jnp.einsum("hij,hj,hjk->hik", U, D, Vt)  # (H, 3, 3) S<-W
    t = cc[:, 0] - jnp.einsum("hij,hj->hi", R, cw[:, 0])  # (H, 3)

    # score: world points into body frame, angle about each ray's origin
    ps = jnp.einsum("hij,nj->hni", R, pts_W) + t[:, None, :]
    v = ps - origins_S[None, :, :]
    depth = jnp.einsum("hni,ni->hn", v, rays_S)
    vn = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("hni,ni->hn", vn, rays_S)
    inl = (cosang > jnp.cos(threshold_rad)) & mask[None, :] & (depth > 0)
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)

    # iterated refinement on the consensus set (≙ the reference's
    # nonlinear refinement after RANSAC, Frontend.cpp verifyRecognisedPlace
    # :258-604): the 3-point hypothesis was built on GUESSED depths, so
    # its pose is decimetres off at room scale — which poisons every loop
    # edge built from it.  Alternate (a) depth-consistent placement of
    # the world points on their measured rays with (b) a weighted Kabsch
    # over all current angular inliers; re-select inliers each round.
    cos_thr = jnp.cos(threshold_rad)

    def refine(carry, _):
        R_c, t_c = carry
        ps1 = pts_W @ R_c.T + t_c
        v1 = ps1 - origins_S
        d1 = jnp.einsum("ni,ni->n", v1, rays_S)
        v1n = v1 / jnp.maximum(
            jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-12
        )
        w = (
            (jnp.einsum("ni,ni->n", v1n, rays_S) > cos_thr)
            & mask & (d1 > 0)
        ).astype(pts_W.dtype)
        P_s = origins_S + rays_S * d1[:, None]
        wsum = jnp.maximum(w.sum(), 1.0)
        cc1 = (P_s * w[:, None]).sum(0) / wsum
        cw1 = (pts_W * w[:, None]).sum(0) / wsum
        H1 = jnp.einsum(
            "ni,nj->ij", (P_s - cc1) * w[:, None], pts_W - cw1
        )
        U1, _S1, Vt1 = jnp.linalg.svd(H1)
        det1 = jnp.linalg.det(U1 @ Vt1)
        R_n = (U1 * jnp.stack(
            [jnp.ones_like(det1), jnp.ones_like(det1), det1]
        )[None, :]) @ Vt1
        t_n = cc1 - R_n @ cw1
        # guard: a degenerate consensus (wsum ~ 3) keeps the old pose
        ok = w.sum() >= 4
        return (jnp.where(ok, R_n, R_c), jnp.where(ok, t_n, t_c)), None

    (R_f, t_f), _ = jax.lax.scan(refine, (R[best], t[best]), None, length=8)

    # final consensus at the refined pose
    psf = pts_W @ R_f.T + t_f
    vf = psf - origins_S
    df = jnp.einsum("ni,ni->n", vf, rays_S)
    vfn = vf / jnp.maximum(jnp.linalg.norm(vf, axis=-1, keepdims=True), 1e-12)
    inl_f = (
        (jnp.einsum("ni,ni->n", vfn, rays_S) > cos_thr) & mask & (df > 0)
    )
    q_SW = se3.matrix_to_quat(R_f)
    T_SW = jnp.concatenate([t_f, q_SW])
    T_WS = se3.se3_inverse(T_SW)
    return RansacResult(T=T_WS, inliers=inl_f, num_inliers=inl_f.sum())


def relative_rotation_2pt(
    key: jax.Array,
    rays_a: jax.Array,  # (N, 3) unit bearings frame A
    rays_b: jax.Array,  # (N, 3) matched bearings frame B
    mask: jax.Array,
    n_hyp: int = 128,
    threshold_rad: float = 0.01,
):
    """Rotation-only relative pose (2-point Wahba per hypothesis)."""
    n = rays_a.shape[0]
    idx = _sample_indices(key, n_hyp, 2, n)
    a = rays_a[idx]  # (H, 2, 3)
    b = rays_b[idx]
    H3 = jnp.einsum("hpi,hpj->hij", a, b)
    U, S, Vt = jnp.linalg.svd(H3)
    det = jnp.linalg.det(jnp.einsum("hij,hjk->hik", U, Vt))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = jnp.einsum("hij,hj,hjk->hik", U, D, Vt)  # a ≈ R b
    pred = jnp.einsum("hij,nj->hni", R, rays_b)
    cosang = jnp.einsum("hni,ni->hn", pred, rays_a)
    inl = (cosang > jnp.cos(threshold_rad)) & mask[None, :]
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    q = se3.matrix_to_quat(R[best])
    T = jnp.concatenate([jnp.zeros(3, rays_a.dtype), q])
    return RansacResult(T=T, inliers=inl[best], num_inliers=scores[best])
