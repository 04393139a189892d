"""Synthetic full-estimator simulation.

Mirrors okvis_ceres/test/TestEstimator.cpp: constant-velocity trajectory,
noisy IMU at high rate, 3D landmark grid projected through the stereo rig to
simulated keypoints; run add-state/observe/optimise/marginalise per frame and
assert final pose error bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from okvis2x_tpu.cameras import distortion as dist
from okvis2x_tpu.cameras import pinhole
from okvis2x_tpu.core import se3
from okvis2x_tpu.graph import EstimatorConfig, SlidingWindowEstimator
from okvis2x_tpu.imu.preintegration import ImuParams

# NOTE: helpers below take a fresh seeded generator per call so results do
# not depend on test execution order (test_gps.py imports them too).
RNG = np.random.default_rng(7)


def make_rig():
    cam = pinhole.make_pinhole(
        fx=460.0, fy=460.0, cx=376.0, cy=240.0, width=752, height=480,
        model=dist.RADTAN, dist_params=[-0.28, 0.07, 1e-4, 1e-5],
    )
    T_SC = np.array(
        [[-0.055, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
         [0.055, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]]
    )
    return [cam, cam], T_SC


def simulate(duration=4.0, frame_rate=10.0, imu_rate=200.0, imu_noise=True,
             seed=7):
    """Constant world velocity, slight yaw rate; returns dense IMU + frame
    ground truth."""
    rng = np.random.default_rng(seed)
    imu = ImuParams()
    v_W = np.array([0.4, 0.0, 0.05])
    yaw_rate = 0.1
    g_W = np.array([0, 0, -imu.g])

    t_imu = np.arange(0.0, duration, 1.0 / imu_rate)
    n = len(t_imu)
    yaw = yaw_rate * t_imu
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    p = v_W[None] * t_imu[:, None]
    C_WS = np.asarray(se3.quat_to_matrix(jnp.asarray(q)))
    f_S = np.einsum("nji,j->ni", C_WS, -g_W)  # zero accel, gravity only
    w_S = np.einsum("nji,j->ni", C_WS, np.array([0, 0, yaw_rate]))
    if imu_noise:
        f_S = f_S + rng.normal(0, imu.sigma_a * np.sqrt(imu_rate), (n, 3))
        w_S = w_S + rng.normal(0, imu.sigma_g * np.sqrt(imu_rate), (n, 3))

    t_frames = np.arange(0.2, duration, 1.0 / frame_rate)
    fq = np.stack(
        [np.zeros_like(t_frames), np.zeros_like(t_frames),
         np.sin(yaw_rate * t_frames / 2), np.cos(yaw_rate * t_frames / 2)], -1
    )
    fp = v_W[None] * t_frames[:, None]
    T_WS_gt = np.concatenate([fp, fq], -1)
    return dict(
        t_imu=t_imu, gyr=w_S, acc=f_S, t_frames=t_frames, T_WS_gt=T_WS_gt,
        v_W=v_W,
    )


def make_landmarks(n=160, seed=8):
    """Grid of landmarks along the trajectory corridor."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 4.0, n)
    y = rng.uniform(1.5, 4.0, n)  # in front (camera looks +y? no: +z)
    z = rng.uniform(-1.5, 1.5, n)
    # cameras look along +z of S (identity extrinsic rotation): put points ahead in z
    pts = np.stack([x, z, y], -1)
    return pts


@pytest.mark.slow
def test_estimator_vio_bounded_error():
    cams, T_SC = make_rig()
    sim = simulate()
    pts = make_landmarks()
    cfg = EstimatorConfig(
        cap_frames=10, num_keyframes=4, num_imu_frames=3,
        cap_landmarks=256, cap_obs=2048, cap_imu_links=9,
        max_iterations=5,
    )
    est = SlidingWindowEstimator(cfg, cams, T_SC)

    # feed initial IMU for initialisation window
    for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
        if t > sim["t_frames"][0] + 0.01:
            break
        est.add_imu_measurement(t, w, a)

    cam = cams[0]
    lid_by_pt = {}
    errs = []
    imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)

    for k, tf in enumerate(sim["t_frames"]):
        # stream IMU up to frame time
        while imu_idx < len(sim["t_imu"]) and sim["t_imu"][imu_idx] <= tf + 0.005:
            est.add_imu_measurement(
                sim["t_imu"][imu_idx], sim["gyr"][imu_idx], sim["acc"][imu_idx]
            )
            imu_idx += 1

        fid = est.add_state(tf)
        T_WS_gt = sim["T_WS_gt"][k]

        # simulate observations from ground truth pose
        for c in range(2):
            T_CW = se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(T_SC[c])),
                se3.se3_inverse(jnp.asarray(T_WS_gt)),
            )
            p_C = np.asarray(jax.vmap(lambda pt: se3.se3_apply(T_CW, pt))(
                jnp.asarray(pts)
            ))
            uv, valid = pinhole.project(cam, jnp.asarray(p_C))
            uv = np.asarray(uv)
            valid = np.asarray(valid)
            for i in np.nonzero(valid)[0][:40]:
                if i not in lid_by_pt:
                    # initialise landmark from (noisy) ground truth position
                    hp = np.concatenate([pts[i] + RNG.normal(0, 0.05, 3), [1.0]])
                    lid_by_pt[i] = est.add_landmark(hp)
                est.add_observation(
                    fid, c, lid_by_pt[i], uv[i] + RNG.normal(0, 0.5, 2)
                )

        est.set_keyframe(fid, k % 3 == 0)
        est.optimise()
        est.marginalise()

        T_est = est.get_state().T_WS
        errs.append(np.linalg.norm(T_est[:3] - T_WS_gt[:3]))

    errs = np.array(errs)
    assert errs[-1] < 0.1, errs
    assert errs.max() < 0.2, errs


@pytest.mark.slow
def test_final_ba_improves_or_holds():
    """Run the VIO simulation, then full-batch final BA over the archived
    history (≙ doFinalBa); the trajectory error must stay bounded and the
    final cost must be finite."""
    cams, T_SC = make_rig()
    sim = simulate(duration=3.0)
    pts = make_landmarks()
    cfg = EstimatorConfig(
        cap_frames=10, num_keyframes=4, num_imu_frames=3,
        cap_landmarks=256, cap_obs=2048, cap_imu_links=9,
        max_iterations=5,
    )
    est = SlidingWindowEstimator(cfg, cams, T_SC)

    for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
        if t > sim["t_frames"][0] + 0.01:
            break
        est.add_imu_measurement(t, w, a)

    cam = cams[0]
    lid_by_pt = {}
    imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
    for k, tf in enumerate(sim["t_frames"]):
        while imu_idx < len(sim["t_imu"]) and sim["t_imu"][imu_idx] <= tf + 0.005:
            est.add_imu_measurement(
                sim["t_imu"][imu_idx], sim["gyr"][imu_idx], sim["acc"][imu_idx]
            )
            imu_idx += 1
        fid = est.add_state(tf)
        T_WS_gt = sim["T_WS_gt"][k]
        for c in range(2):
            T_CW = se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(T_SC[c])),
                se3.se3_inverse(jnp.asarray(T_WS_gt)),
            )
            p_C = np.asarray(jax.vmap(lambda pt: se3.se3_apply(T_CW, pt))(
                jnp.asarray(pts)))
            uv, valid = pinhole.project(cam, jnp.asarray(p_C))
            uv, valid = np.asarray(uv), np.asarray(valid)
            for i in np.nonzero(valid)[0][:30]:
                if i not in lid_by_pt:
                    hp = np.concatenate([pts[i] + RNG.normal(0, 0.05, 3), [1.0]])
                    lid_by_pt[i] = est.add_landmark(hp)
                est.add_observation(fid, c, lid_by_pt[i], uv[i] + RNG.normal(0, 0.5, 2))
        est.set_keyframe(fid, k % 3 == 0)
        est.optimise()
        est.marginalise()

    # archived history exists
    assert len(est.archive_frames) + len(est.frames) > 5
    assert len(est.arch_obs_fid) > 100
    cost = est.final_ba(iterations=8)
    assert np.isfinite(cost) and cost > 0
    fts, fTs = est.full_trajectory()
    # compare against ground truth at matching timestamps
    errs = []
    for t, T in zip(fts, fTs):
        k = int(np.argmin(np.abs(sim["t_frames"] - t)))
        errs.append(np.linalg.norm(T[:3] - sim["T_WS_gt"][k][:3]))
    assert max(errs) < 0.2, errs


def _run_vio_then_final_ba(redo_imu: bool, bias_g=0.004) -> float:
    """VIO with a constant gyro bias injected into the measurements; the
    online window absorbs it into the bias states, and the final BA either
    re-propagates IMU from raw data at the solved biases (redo_imu) or
    falls back to frozen odometry glue.  Returns max position error."""
    cams, T_SC = make_rig()
    sim = simulate(duration=3.0, imu_noise=False)
    pts = make_landmarks()
    cfg = EstimatorConfig(
        cap_frames=10, num_keyframes=4, num_imu_frames=3,
        cap_landmarks=256, cap_obs=2048, cap_imu_links=9,
        max_iterations=5,
    )
    est = SlidingWindowEstimator(cfg, cams, T_SC)
    bias = np.array([bias_g, -bias_g, bias_g])

    for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
        if t > sim["t_frames"][0] + 0.01:
            break
        est.add_imu_measurement(t, w + bias, a)
    cam = cams[0]
    lid_by_pt = {}
    rng = np.random.default_rng(17)
    imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
    for k, tf in enumerate(sim["t_frames"]):
        while imu_idx < len(sim["t_imu"]) and sim["t_imu"][imu_idx] <= tf + 0.005:
            est.add_imu_measurement(
                sim["t_imu"][imu_idx], sim["gyr"][imu_idx] + bias,
                sim["acc"][imu_idx],
            )
            imu_idx += 1
        fid = est.add_state(tf)
        T_WS_gt = sim["T_WS_gt"][k]
        for c in range(2):
            T_CW = se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(T_SC[c])),
                se3.se3_inverse(jnp.asarray(T_WS_gt)),
            )
            p_C = np.asarray(jax.vmap(lambda pt: se3.se3_apply(T_CW, pt))(
                jnp.asarray(pts)))
            uv, valid = pinhole.project(cam, jnp.asarray(p_C))
            uv, valid = np.asarray(uv), np.asarray(valid)
            for i in np.nonzero(valid)[0][:30]:
                if i not in lid_by_pt:
                    hp = np.concatenate([pts[i] + rng.normal(0, 0.05, 3), [1.0]])
                    lid_by_pt[i] = est.add_landmark(hp)
                est.add_observation(fid, c, lid_by_pt[i],
                                    uv[i] + rng.normal(0, 0.5, 2))
        est.set_keyframe(fid, k % 3 == 0)
        est.optimise()
        est.marginalise()

    est.final_ba(iterations=8, redo_imu=redo_imu)
    fts, fTs = est.full_trajectory()
    errs = []
    for t, T in zip(fts, fTs):
        k = int(np.argmin(np.abs(sim["t_frames"] - t)))
        errs.append(np.linalg.norm(T[:3] - sim["T_WS_gt"][k][:3]))
    return float(max(errs))


@pytest.mark.slow
def test_final_ba_repropagated_imu_beats_glue():
    """VERDICT item 10 gate: with a biased IMU, re-propagated final-BA IMU
    links (redoPropagationAlways=true) must not lose to the frozen
    odometry-glue approximation, and must stay within the online bound."""
    err_redo = _run_vio_then_final_ba(redo_imu=True)
    err_glue = _run_vio_then_final_ba(redo_imu=False)
    assert err_redo < 0.15, (err_redo, err_glue)
    assert err_redo <= err_glue * 1.05, (err_redo, err_glue)


@pytest.mark.slow
def test_long_keyframe_spans_chain_merge():
    """Round-2 crash regression: keyframes far apart in time make window
    IMU links outgrow any fixed raw-sample capacity (the old design died
    at `IMU span 522 exceeds capacity 512`).  With chained preintegration
    (≙ ImuError::append + eliminateImuFrames) the estimator must survive
    links spanning many seconds and keep the error bounded."""
    cams, T_SC = make_rig()
    sim = simulate(duration=11.0, frame_rate=5.0)
    rng = np.random.default_rng(11)
    n_pts = 300
    pts = np.stack([
        rng.uniform(-1.0, 7.0, n_pts),
        rng.uniform(-1.5, 1.5, n_pts),
        rng.uniform(1.5, 4.0, n_pts),
    ], -1)
    cfg = EstimatorConfig(
        cap_frames=10, num_keyframes=4, num_imu_frames=3,
        cap_landmarks=512, cap_obs=3072, cap_imu_links=9,
        max_iterations=5,
    )
    est = SlidingWindowEstimator(cfg, cams, T_SC)

    for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
        if t > sim["t_frames"][0] + 0.01:
            break
        est.add_imu_measurement(t, w, a)

    cam = cams[0]
    lid_by_pt = {}
    errs = []
    imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
    max_link_dt = 0.0

    for k, tf in enumerate(sim["t_frames"]):
        while imu_idx < len(sim["t_imu"]) and sim["t_imu"][imu_idx] <= tf + 0.005:
            est.add_imu_measurement(
                sim["t_imu"][imu_idx], sim["gyr"][imu_idx], sim["acc"][imu_idx]
            )
            imu_idx += 1
        fid = est.add_state(tf)
        T_WS_gt = sim["T_WS_gt"][k]
        for c in range(2):
            T_CW = se3.se3_multiply(
                se3.se3_inverse(jnp.asarray(T_SC[c])),
                se3.se3_inverse(jnp.asarray(T_WS_gt)),
            )
            p_C = np.asarray(jax.vmap(lambda pt: se3.se3_apply(T_CW, pt))(
                jnp.asarray(pts)
            ))
            uv, valid = pinhole.project(cam, jnp.asarray(p_C))
            uv = np.asarray(uv)
            valid = np.asarray(valid)
            for i in np.nonzero(valid)[0][:40]:
                if i not in lid_by_pt:
                    hp = np.concatenate([pts[i] + RNG.normal(0, 0.05, 3), [1.0]])
                    lid_by_pt[i] = est.add_landmark(hp)
                est.add_observation(
                    fid, c, lid_by_pt[i], uv[i] + RNG.normal(0, 0.5, 2)
                )
        # keyframes every ~3.6 s: chain links between surviving keyframes
        # span ~720 raw samples at 200 Hz — beyond the old 512 cap
        est.set_keyframe(fid, k % 18 == 0)
        est.optimise()
        est.marginalise()
        if est.imu_links:
            max_link_dt = max(
                max_link_dt,
                max(float(e.dt) for e, _ in est.imu_links.values()),
            )
        T_est = est.get_state().T_WS
        errs.append(np.linalg.norm(T_est[:3] - sim["T_WS_gt"][k][:3]))

    # the scenario must actually have exercised >cap-sample links
    assert max_link_dt * 200.0 > cfg.cap_imu_samples, max_link_dt
    errs = np.array(errs)
    assert errs[-1] < 0.25, errs
    assert errs.max() < 0.4, errs


@pytest.mark.slow
def test_f32_matches_f64_over_long_run():
    """SURVEY §7.3 hard part 5: the production GPU path runs the estimator
    in f32 (+ Jacobi scaling and iterative refinement in the reduced
    solve); validate that over a 60 s trajectory the f32 ATE stays at the
    f64 solution's level rather than drifting off numerically."""
    cams, T_SC = make_rig()
    sim = simulate(duration=60.0, frame_rate=4.0)
    rng = np.random.default_rng(21)
    n_pts = 500
    pts = np.stack([
        rng.uniform(-2.0, 26.0, n_pts),
        rng.uniform(-1.5, 1.5, n_pts),
        rng.uniform(1.5, 4.0, n_pts),
    ], -1)

    def run(dtype):
        cfg = EstimatorConfig(
            cap_frames=10, num_keyframes=4, num_imu_frames=3,
            cap_landmarks=512, cap_obs=3072, cap_imu_links=9,
            max_iterations=5, dtype=dtype,
        )
        est = SlidingWindowEstimator(cfg, cams, T_SC)
        for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
            if t > sim["t_frames"][0] + 0.01:
                break
            est.add_imu_measurement(t, w, a)
        cam = cams[0]
        lid_by_pt = {}
        errs = []
        obs_rng = np.random.default_rng(5)
        imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
        for k, tf in enumerate(sim["t_frames"]):
            while (imu_idx < len(sim["t_imu"])
                   and sim["t_imu"][imu_idx] <= tf + 0.005):
                est.add_imu_measurement(
                    sim["t_imu"][imu_idx], sim["gyr"][imu_idx],
                    sim["acc"][imu_idx])
                imu_idx += 1
            fid = est.add_state(tf)
            T_WS_gt = sim["T_WS_gt"][k]
            for c in range(2):
                T_CW = se3.se3_multiply(
                    se3.se3_inverse(jnp.asarray(T_SC[c])),
                    se3.se3_inverse(jnp.asarray(T_WS_gt)),
                )
                p_C = np.asarray(jax.vmap(
                    lambda pt: se3.se3_apply(T_CW, pt))(jnp.asarray(pts)))
                uv, valid = pinhole.project(cam, jnp.asarray(p_C))
                uv = np.asarray(uv)
                valid = np.asarray(valid)
                for i in np.nonzero(valid)[0][:30]:
                    if i not in lid_by_pt:
                        hp = np.concatenate(
                            [pts[i] + obs_rng.normal(0, 0.05, 3), [1.0]])
                        lid_by_pt[i] = est.add_landmark(hp)
                    est.add_observation(
                        fid, c, lid_by_pt[i],
                        uv[i] + obs_rng.normal(0, 0.5, 2))
            est.set_keyframe(fid, k % 4 == 0)
            est.optimise()
            est.marginalise()
            errs.append(np.linalg.norm(
                est.get_state().T_WS[:3] - T_WS_gt[:3]))
        return np.sqrt(np.mean(np.square(errs)))

    ate64 = run(jnp.float64)
    ate32 = run(jnp.float32)
    # f32 must hold the f64 trajectory's error level over the full minute
    assert ate32 < max(1.5 * ate64, ate64 + 0.02), (ate32, ate64)
    assert ate32 < 0.3, ate32


@pytest.mark.slow
def test_segmented_final_ba_matches_joint():
    """Beyond max_nodes the final BA runs global-pose-graph + overlapping
    exact segments (HBM-bounded); on a trajectory where both paths are
    feasible the segmented result must match the joint solve's accuracy."""
    def run_sim(max_nodes):
        cams, T_SC = make_rig()
        sim = simulate(duration=5.0)
        pts = make_landmarks()
        cfg = EstimatorConfig(
            cap_frames=10, num_keyframes=4, num_imu_frames=3,
            cap_landmarks=256, cap_obs=2048, cap_imu_links=9,
            max_iterations=5,
        )
        est = SlidingWindowEstimator(cfg, cams, T_SC)
        for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
            if t > sim["t_frames"][0] + 0.01:
                break
            est.add_imu_measurement(t, w, a)
        cam = cams[0]
        lid_by_pt = {}
        obs_rng = np.random.default_rng(13)
        imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
        for k, tf in enumerate(sim["t_frames"]):
            while (imu_idx < len(sim["t_imu"])
                   and sim["t_imu"][imu_idx] <= tf + 0.005):
                est.add_imu_measurement(
                    sim["t_imu"][imu_idx], sim["gyr"][imu_idx],
                    sim["acc"][imu_idx])
                imu_idx += 1
            fid = est.add_state(tf)
            T_WS_gt = sim["T_WS_gt"][k]
            for c in range(2):
                T_CW = se3.se3_multiply(
                    se3.se3_inverse(jnp.asarray(T_SC[c])),
                    se3.se3_inverse(jnp.asarray(T_WS_gt)),
                )
                p_C = np.asarray(jax.vmap(
                    lambda pt: se3.se3_apply(T_CW, pt))(jnp.asarray(pts)))
                uv, valid = pinhole.project(cam, jnp.asarray(p_C))
                uv, valid = np.asarray(uv), np.asarray(valid)
                for i in np.nonzero(valid)[0][:30]:
                    if i not in lid_by_pt:
                        hp = np.concatenate(
                            [pts[i] + obs_rng.normal(0, 0.05, 3), [1.0]])
                        lid_by_pt[i] = est.add_landmark(hp)
                    est.add_observation(
                        fid, c, lid_by_pt[i],
                        uv[i] + obs_rng.normal(0, 0.5, 2))
            est.set_keyframe(fid, k % 3 == 0)
            est.optimise()
            est.marginalise()
        cost = est.final_ba(iterations=8, max_nodes=max_nodes)
        assert np.isfinite(cost)
        fts, fTs = est.full_trajectory()
        errs = []
        for t, T in zip(fts, fTs):
            k = int(np.argmin(np.abs(sim["t_frames"] - t)))
            errs.append(np.linalg.norm(T[:3] - sim["T_WS_gt"][k][:3]))
        return float(np.sqrt(np.mean(np.square(errs))))

    ate_joint = run_sim(max_nodes=512)  # joint path
    ate_seg = run_sim(max_nodes=10)  # forces 3+ overlapping segments
    assert ate_seg < max(2.0 * ate_joint, ate_joint + 0.03), (
        ate_seg, ate_joint)
