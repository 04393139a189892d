"""Tightly-coupled LiDAR-visual-inertial pipeline.

Combines the visual pipeline with LiDAR submapping, mirroring the
reference's LiDAR path in ThreadedSlam (okvis_multisensor_processing/src/
ThreadedSlam.cpp:781-845: live deskew → filter → downsample → SubmapIcp
factors; LiDAR-overlap keyframe trigger `needsNewLidarKeyframe`:1241) and
SubmappingInterface ray integration.

Per sweep:
  1. deskew between the bracketing estimator states (mapping/lidar.deskew);
  2. voxel-downsample;
  3. frame-to-map alignment edge against the active submap (the aggregated
     Gaussian form of the reference's per-point SubmapIcpError live
     factors) pushed into the estimator as a refreshed relative-pose edge;
  4. ray-batch integration into the active submap;
  5. low map overlap → request a new keyframe (the reference's LiDAR
     keyframe trigger).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from okvis2x_tpu.core import se3
from okvis2x_tpu.mapping import icp_factor, lidar
from okvis2x_tpu.pipeline.submapping import SubmappingConfig, SubmappingInterface
from okvis2x_tpu.pipeline.vio import VioPipeline


class LidarVioPipeline:
    """VioPipeline + LiDAR submapping, one synchronous object."""

    def __init__(
        self,
        vio: VioPipeline,
        submapping_cfg: SubmappingConfig = SubmappingConfig(),
        T_SL: Optional[np.ndarray] = None,  # LiDAR extrinsics (S<-L)
        voxel: float = 0.3,
        max_points_per_sweep: int = 2048,
    ):
        self.vio = vio
        self.est = vio.est
        self.submapper = SubmappingInterface(
            submapping_cfg, align_callback=self._on_align_edge
        )
        self.T_SL = (
            np.array([0, 0, 0, 0, 0, 0, 1.0]) if T_SL is None else np.asarray(T_SL)
        )
        self.voxel = voxel
        self.max_points = max_points_per_sweep
        self._live_edge_idx: Optional[int] = None
        self.request_keyframe = False

    # -- estimator plumbing --------------------------------------------------
    def _on_align_edge(self, edge: dict):
        """Map-to-map alignment edge from the submapper -> estimator."""
        self.est.rel_edges.append(edge)

    def add_imu_measurement(self, t, gyr, acc):
        self.vio.add_imu_measurement(t, gyr, acc)

    def process_frame(self, t, images):
        info = self.vio.process_frame(t, images)
        if self.request_keyframe and not info["is_keyframe"]:
            self.est.set_keyframe(info["fid"], True)
            info["is_keyframe"] = True
            self.vio.last_kf_fid = info["fid"]
            self.request_keyframe = False
        # push updated keyframe poses to the submapper (re-anchoring)
        self.submapper.on_state_update(
            {f.fid: f.T_WS for f in self.est.frames}
        )
        return info

    # -- LiDAR path ----------------------------------------------------------
    def _bracketing_states(self, t0: float, t1: float):
        frames = self.est.frames
        if not frames:
            return None, None
        before = [f for f in frames if f.timestamp <= t0] or [frames[0]]
        after = [f for f in frames if f.timestamp >= t1] or [frames[-1]]
        return before[-1], after[0]

    def process_lidar_sweep(self, sweep) -> dict:
        """Consume an io.xdataset.LidarSweep."""
        est = self.est
        if not est.frames:
            return dict(integrated=False)
        t0 = float(sweep.t_point[0])
        t1 = float(sweep.t_point[-1])
        fa, fb = self._bracketing_states(t0, t1)

        # points into the sensor frame S (host math: cheaper than a device
        # dispatch and sync)
        from okvis2x_tpu.core import se3np

        R_SL = se3np.quat_to_matrix(self.T_SL[3:7])
        pts_S = np.asarray(sweep.pts) @ R_SL.T + self.T_SL[:3]

        # deskew: per-ray IMU propagation from the bracketing state when
        # the raw buffer covers the sweep (≙ LidarMotionUndistortion's
        # Propagator path — intra-sweep dynamics matter under aggressive
        # motion); two-state geodesic interpolation as the fallback
        t_tgt = float(fb.timestamp)
        i0, i1 = est._imu_span(fa.timestamp, max(t1, t_tgt))
        if i1 - i0 >= 2 and est.imu_t[i0] <= fa.timestamp + 1e-6 \
                and est.imu_t[i1 - 1] >= t1 - 1e-3:
            # deskew into the (IMU-consistent) frame at fb's time so the
            # live factor attaches to fb's pose variable without offset
            pts_S, _ = lidar.deskew_imu(
                est.cfg.imu, est.imu_t[i0:i1], est.imu_gyr[i0:i1],
                est.imu_acc[i0:i1], fa, sweep.t_point, pts_S,
                t_end=t_tgt,
            )
        else:
            dt = max(t1 - t0, 1e-6)
            frac = jnp.asarray(
                np.clip((sweep.t_point - t0) / dt, 0, 1), jnp.float32
            )
            pts_S = np.asarray(
                lidar.deskew(
                    jnp.asarray(fa.T_WS, jnp.float32),
                    jnp.asarray(fb.T_WS, jnp.float32),
                    frac,
                    jnp.asarray(pts_S, jnp.float32),
                )
            )

        # range gate + voxel downsample
        rng = np.linalg.norm(pts_S, axis=-1)
        pts_S = pts_S[(rng > 0.5) & (rng < 60.0)]
        pts_S = lidar.voxel_downsample(pts_S, self.voxel)
        if len(pts_S) > self.max_points:
            pts_S = pts_S[
                np.random.default_rng(0).choice(
                    len(pts_S), self.max_points, replace=False
                )
            ]
        if len(pts_S) < 10:
            return dict(integrated=False)

        T_WS = fb.T_WS
        host_kf = self.vio.last_kf_fid
        if host_kf is None:
            host_kf = est.frames[-1].fid
        try:
            T_WK = est.get_state(host_kf).T_WS
        except KeyError:
            host_kf = est.frames[-1].fid
            T_WK = est.get_state(host_kf).T_WS

        # frame-to-map live factor BEFORE integrating this sweep.  With
        # cap_icp > 0 the points enter the window solver as per-point
        # SubmapIcp rows re-evaluated every LM iteration (≙ the reference's
        # live SubmapIcpError factors, ViGraph.cpp:1470); otherwise fall
        # back to the compressed relative-pose edge.
        made_edge = False
        a = self.submapper.active
        if a is not None and a.n_frames >= 2 and a.anchor_fid != fb.fid:
            anchor_in_window = any(
                f.fid == a.anchor_fid for f in est.frames
            )
            if anchor_in_window and est.cfg.cap_icp > 0:
                est.set_icp_map(a.sm, self.submapper.cfg.submap)
                est.set_live_icp_points(
                    a.anchor_fid, fb.fid, pts_S,
                    self.submapper.cfg.sensor_sigma,
                )
                made_edge = True
            elif anchor_in_window:
                edge = self._live_alignment_edge(a, fb, pts_S)
                if edge is not None:
                    edge["live"] = True
                    est.rel_edges = [
                        e for e in est.rel_edges if not e.get("live")
                    ]
                    est.rel_edges.append(edge)
                    made_edge = True

        # overlap-based keyframe trigger (≙ needsNewLidarKeyframe)
        if a is not None and a.n_frames >= 2:
            pts_W = np.asarray(
                se3.se3_apply(
                    jnp.asarray(T_WS, jnp.float32), jnp.asarray(pts_S, jnp.float32)
                )
            )
            pts_K = self.submapper._to_submap_frame(a, pts_W)
            if self.submapper._overlap_fraction(a, pts_K) < 0.5:
                self.request_keyframe = True

        # integration AFTER factor creation: the live rows constrain against
        # the pre-sweep field, so a drifted sweep cannot pull its own
        # correction target along (matches the reference's ordering —
        # factors in processFrame, integration in the submapping threads)
        self.submapper.integrate_lidar(host_kf, T_WK, T_WS, pts_S, 0.1)
        return dict(integrated=True, n_points=len(pts_S), live_edge=made_edge)

    def _live_alignment_edge(self, entry, frame, pts_S) -> Optional[dict]:
        cfgs = self.submapper.cfg.submap
        npts = self.submapper.cfg.align_points
        pts = np.zeros((npts, 3), np.float32)
        valid = np.zeros(npts, bool)
        n = min(len(pts_S), npts)
        pts[:n] = pts_S[:n]
        valid[:n] = True
        key = ("live_align", npts)
        if key not in self.submapper._jit:
            import jax

            sigma = self.submapper.cfg.sensor_sigma

            @jax.jit
            def f(sm, T_WA, T_WB, pts_, valid_):
                return icp_factor.make_alignment_edge(
                    sm, cfgs, T_WA, T_WB, pts_, valid_, sigma
                )

            self.submapper._jit[key] = f
        anchor_T = None
        for f2 in self.est.frames:
            if f2.fid == entry.anchor_fid:
                anchor_T = f2.T_WS
                break
        if anchor_T is None:
            return None
        T_AB, sqrt_info, strength = self.submapper._jit[key](
            entry.sm,
            jnp.asarray(entry.sm.T_WK, jnp.float32),
            jnp.asarray(frame.T_WS, jnp.float32),
            jnp.asarray(pts), jnp.asarray(valid),
        )
        if not np.isfinite(float(strength)) or float(strength) < 1.0:
            return None
        return dict(
            i=entry.anchor_fid, j=frame.fid,
            T_ij=np.asarray(T_AB, np.float64),
            sqrt_info=np.asarray(sqrt_info, np.float64),
        )
