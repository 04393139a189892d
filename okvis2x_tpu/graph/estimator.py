"""Sliding-window VIO estimator.

Host-side graph orchestration over the device solver — the round-1 core of
the reference's `ViSlamBackend`/`ViGraph` (okvis_ceres/src/ViSlamBackend.cpp:
175 `addStates`, :555 `applyStrategy`, :811 `optimiseRealtimeGraph`).

Design split:
  * graph *structure* (which frames/landmarks/observations exist, window
    policy, marginalisation) lives on the host as plain numpy arrays +
    python dicts — cheap, dynamic, no recompiles;
  * all *numerics* (IMU preintegration, linearisation, Schur solve, state
    retraction) run as a handful of fixed-shape jitted programs; the problem
    is padded to static capacities so one compiled executable serves every
    frame.

Window policy (mirrors the reference's applyStrategy semantics):
  * the newest `num_imu_frames` frames are always kept;
  * older frames that are not keyframes are eliminated by IMU-chain merge
    (`eliminateStateByImuMerge`): their IMU spans are concatenated and
    re-preintegrated, their observations dropped;
  * keyframes beyond `num_keyframes` are eliminated; their co-observation
    information is summarised into a relative-pose edge against the most
    covisible surviving keyframe (TwoPoseGraphError-style marginalisation,
    okvis_ceres/src/TwoPoseGraphError.cpp:162) and their poses removed;
  * landmarks without remaining observations are deleted.

Bias handling: preintegrations are *recomputed* (batched, one vmap'd scan)
at the current bias estimate before every optimisation — strictly better
than the reference's first-order correction + occasional redo, and cheap
where the scan is a single fused program.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from okvis2x_tpu.core import se3, se3np
from okvis2x_tpu.factors import imu_factor
from okvis2x_tpu.factors.reprojection import residual as reprojection_residual
from okvis2x_tpu.imu import preintegration as pre
from okvis2x_tpu.imu import preintegration_np as pre_np
from okvis2x_tpu.solver import gauss_newton as gn
from okvis2x_tpu.solver import problem as prb


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    num_keyframes: int = 5
    num_imu_frames: int = 3
    cap_frames: int = 12
    cap_landmarks: int = 768
    cap_obs: int = 6144
    cap_imu_links: int = 11
    cap_imu_samples: int = 512
    # chained-preintegration cache policy (≙ ImuError::redoPreintegration's
    # lazy bias-deviation trigger, okvis_ceres/src/ImuError.cpp:258): a
    # cached link is re-propagated from raw samples when the host-side bias
    # estimate moved past these thresholds from its linearisation point —
    # below them the factor's first-order bias correction is exact enough.
    imu_bias_redo_g: float = 0.01  # [rad/s]
    imu_bias_redo_a: float = 0.05  # [m/s^2]
    # spans longer than this many raw samples are never re-scanned on a
    # bias jump (first-order correction only — the O(n) host loop would
    # stall the frame path); merged links keep their composed state.
    imu_redo_max_samples: int = 4096
    cap_rel_edges: int = 16
    cap_gps: int = 8
    # per-point submap ICP rows in the window solve (≙ live SubmapIcpError
    # factors, ViGraph.cpp:1470; 0 disables — se2.yaml n_factors_per_state
    # is the reference budget, config/euroc/se2.yaml:24)
    cap_icp: int = 0
    keypoint_sigma_px: float = 0.8
    max_iterations: int = 10
    # realtime solve budget (≙ okvis2.yaml realtime_time_limit 0.035 +
    # realtime_min_iterations, enforced by CeresIterationCallback,
    # okvis_ceres/include/okvis/ceres/CeresIterationCallback.hpp:80).
    # Iteration counts are compile-time constants here, so instead of
    # aborting mid-solve the estimator ADAPTS the next solve's iteration
    # bucket (max_iterations -> ... -> min_iterations) whenever the
    # measured solve wall time's EMA overruns the budget, and steps back
    # up when there is slack.  0 disables adaptation.
    realtime_time_limit: float = 0.0
    min_iterations: int = 3
    # early exit on convergence inside the compiled realtime LM loop
    # (gauss_newton.SolverConfig.early_exit_rel): > 0 lets the device skip
    # iterations whose relative cost decrease fell below the tolerance —
    # the budget controller's complement that trims only CONVERGED
    # iterations (no accuracy cliff, unlike hard iteration buckets)
    early_exit_rel: float = 0.0
    imu: pre.ImuParams = pre.ImuParams()
    dtype: object = jnp.float64
    # online extrinsics calibration (≙ CameraParameters::
    # OnlineCalibrationParameters, Parameters.hpp:70-80): estimate T_SC with
    # a pose prior of the given stdevs around the initial calibration
    do_extrinsics: bool = False
    do_extrinsics_final_ba: bool = False
    extrinsics_sigma_r: float = 0.001  # [m]
    extrinsics_sigma_alpha: float = 0.005  # [rad]
    extrinsics_sigma_r_final_ba: float = 0.001
    extrinsics_sigma_alpha_final_ba: float = 0.005
    # priors applied at initialisation (reference addStatesInitialise)
    init_pos_sigma: float = 1e-4
    init_yaw_sigma: float = 1e-4
    init_rollpitch_sigma: float = 0.03
    init_v_sigma: float = 0.1


@dataclasses.dataclass
class FrameState:
    fid: int
    timestamp: float
    T_WS: np.ndarray  # (7,)
    sb: np.ndarray  # (9,)
    is_keyframe: bool = False
    pose_fixed: bool = False
    sb_fixed: bool = False
    # marginalised keyframe kept as a frozen pose-graph anchor: its
    # observations were converted to a two-pose edge, it carries no
    # speed/bias estimate and no IMU links (≙ freezePosesUntil +
    # convertToPoseGraphMst semantics)
    pose_graph_frame: bool = False
    # pose-graph frame whose observations were re-expanded into the window
    # (≙ expandKeyframe) — pose optimises again, still no IMU chain
    expanded: bool = False
    # pose at loop-closure restore time (sanity anchor for re-archival)
    pre_hold_T: object = None


class SlidingWindowEstimator:
    """Keyframe-based sliding-window visual-inertial estimator."""

    def __init__(self, config: EstimatorConfig, cameras, T_SC: np.ndarray):
        self.cfg = config
        # the gated solve packs its outlier mask 16 bits/word
        assert config.cap_obs % 16 == 0, "cap_obs must be a multiple of 16"
        # stacked intrinsics at the estimator dtype: f64 camera leaves
        # would silently promote an f32 solve's whole dataflow under x64
        _cdt = jax.dtypes.canonicalize_dtype(config.dtype)
        self.cams = jax.tree.map(
            lambda x: x.astype(_cdt)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x,
            gn.stack_cameras(cameras),
        )
        self.T_SC = np.asarray(T_SC, dtype=np.float64)  # (C, 7)
        self.C = self.T_SC.shape[0]
        # online-calibration prior anchored at the initial calibration
        self.T_SC_prior = self.T_SC.copy()

        self.frames: List[FrameState] = []
        self._next_fid = 0
        self._next_lid = 0

        # realtime-budget adaptation state (≙ CeresIterationCallback):
        # current iteration bucket + solve-time EMA + overrun counter
        self._rt_iters = config.max_iterations
        self._rt_ema = 0.0
        self.n_budget_overruns = 0

        # correction-epoch counter: bumped by every applied global
        # correction (loop-closure surgery, background pose-graph /
        # full-BA sync, GPS re-alignment).  Background snapshots record
        # it; FullGraphOptimizer.synchronise discards any result whose
        # snapshot epoch is stale — the conservative equivalent of the
        # reference replaying realtime mutations into fullGraph_ before
        # applying (synchroniseRealtimeAndFullGraph,
        # okvis_ceres/src/ViSlamBackend.cpp:1589-1870).  Without it, a
        # result computed before a surgery re-anchors the live window
        # into the PRE-surgery frame: measured as a 6.75 m teleport at
        # t=160 s of the 185 s circuit, which marginalisation then baked
        # into unfixable two-pose edges (final ATE 8.1 m vs 0.05 m).
        self.correction_epoch = 0

        # deferred two-pose-edge jobs (deferred pipeline: the pipeline
        # drains these into its prefetch batch; apply_pending_edges)
        self.defer_edge_jobs = False
        self.pending_edge_jobs: List[dict] = []

        # landmark store: lid -> row index in dense arrays
        self.lm_ids: List[int] = []
        self.lm_index: Dict[int, int] = {}
        self.hp_W = np.zeros((0, 4))
        self.lm_quality = np.zeros((0,))

        # observations as numpy columns
        self.obs_fid = np.zeros((0,), np.int64)
        self.obs_cam = np.zeros((0,), np.int64)
        self.obs_lid = np.zeros((0,), np.int64)
        self.obs_uv = np.zeros((0, 2))
        self.obs_sigma = np.zeros((0,))
        self.obs_depth = np.zeros((0,))        # per-keypoint depth prior
        self.obs_depth_sigma = np.zeros((0,))  # 0 => inactive
        # persistent observation row ids: dispatched solves flag outliers
        # by uid, so removal stays correct even when marginalisation
        # reorders/filters the tables between dispatch and collect
        self.obs_uid = np.zeros((0,), np.int64)
        self._obs_uid_next = 0

        # IMU raw measurement buffer: amortised growable arrays + start
        # offset (per-sample np.append is O(n²) over minutes-long runs)
        cap0 = 4096
        self._imu_buf = np.zeros((cap0, 7))  # [t, gyr(3), acc(3)]
        self._imu_start = 0
        self._imu_n = 0
        # trimmed samples archived for final-BA IMU re-propagation
        # (≙ doFinalBa's ImuError::redoPropagationAlways=true,
        # ViSlamBackend.cpp:2036 — needs the raw spans of archived frames)
        self._arch_imu_buf = np.zeros((cap0, 7))
        self._arch_imu_n = 0

        # chained per-link preintegration cache: (fid_a, fid_b) ->
        # (Preintegrated f64 numpy, sqrt_info (15,15) f64).  Links are
        # created from short raw spans as frames arrive, COMPOSED when a
        # chain frame is eliminated (≙ ImuError::append +
        # eliminateImuFrames, ViSlamBackend.cpp:511), and lazily
        # re-propagated on bias jumps — so a window link never re-scans an
        # unbounded raw span (the round-2 fixed-capacity design crashed
        # once keyframe links outgrew 512 samples).
        self.imu_links: Dict[tuple, tuple] = {}

        # relative-pose (pose-graph / marginalisation) edges between frame ids
        self.rel_edges: List[dict] = []
        # long-term pose graph: frames/edges that left the active window
        # (consumed by loop closure / final BA; ≙ the full graph's pose-graph
        # part in ViSlamBackend's dual-graph design)
        self.archive_frames: Dict[int, FrameState] = {}
        self.archive_edges: List[dict] = []
        # archived observations + landmark snapshots for the final BA
        # (≙ doFinalBa re-expanding pose-graph edges back to observations).
        # Amortised growable backing stores (per-frame np.append over the
        # whole archive is O(n²) on minutes-long sequences); read through
        # the arch_obs_* view properties below.
        self._arch_obs_i = np.zeros((1024, 3), np.int64)  # fid, cam, lid
        self._arch_obs_f = np.zeros((1024, 5))  # uv(2), sigma, d, d_sigma
        self._arch_obs_n = 0
        self.arch_lm: Dict[int, np.ndarray] = {}

        # GNSS fusion state machine (≙ ViGraph gpsStatus_,
        # okvis_ceres/include/okvis/ViGraph.hpp:73-79: Off/Idle/Initialising/
        # Initialised/ReInitialising; alignment ≙ attemptFullGpsAlignment,
        # ViSlamBackend.cpp:2557)
        self.gps_status = "Off"
        self.gps_meas: List[tuple] = []  # (t, pos_G (3,), err (3,))
        self.T_GW = np.array([0, 0, 0, 0, 0, 0, 1.0])
        self.gps_r_SA = np.zeros(3)
        self.gps_min_fixes = 6
        self.gps_min_span = 1.0  # [m] trajectory extent before alignment
        self.gps_timeout = 2.0  # [s] dropout -> re-initialise

        # loop-closure frames protected from window-cap archival while the
        # pipeline holds them (≙ numLoopClosureFrames window budget)
        self.lc_protected: set = set()
        # live per-point submap ICP factors: one refreshed set per sweep
        # (anchor_fid, owner_fid, pts_S (n, 3), sigma) against `icp_map`
        # whose grid config is `icp_grid_cfg` (static for the solver)
        self.icp_live: Optional[tuple] = None
        self.icp_map = None
        self.icp_grid_cfg = None

        # priors (on first state)
        self.prior_fid: Optional[int] = None
        self.prior_T: Optional[np.ndarray] = None
        self.prior_sqrt_info: Optional[np.ndarray] = None
        self.prior_sb: Optional[np.ndarray] = None
        self.prior_sb_sqrt_info: Optional[np.ndarray] = None

        self._jit_cache = {}

    # ------------------------------------------------------------------ imu
    @property
    def imu_t(self):
        return self._imu_buf[self._imu_start:self._imu_n, 0]

    @property
    def imu_gyr(self):
        return self._imu_buf[self._imu_start:self._imu_n, 1:4]

    @property
    def imu_acc(self):
        return self._imu_buf[self._imu_start:self._imu_n, 4:7]

    @property
    def arch_imu_t(self):
        return self._arch_imu_buf[:self._arch_imu_n, 0]

    @property
    def arch_imu_gyr(self):
        return self._arch_imu_buf[:self._arch_imu_n, 1:4]

    @property
    def arch_imu_acc(self):
        return self._arch_imu_buf[:self._arch_imu_n, 4:7]

    def add_imu_measurement(self, t: float, gyr, acc):
        if self._imu_n == len(self._imu_buf):
            # compact the trimmed prefix away, then double if still full
            live = self._imu_buf[self._imu_start:self._imu_n]
            cap = len(self._imu_buf)
            if len(live) > cap // 2:
                cap *= 2
            buf = np.zeros((cap, 7))
            buf[: len(live)] = live
            self._imu_buf = buf
            self._imu_n = len(live)
            self._imu_start = 0
        self._imu_buf[self._imu_n, 0] = t
        self._imu_buf[self._imu_n, 1:4] = gyr
        self._imu_buf[self._imu_n, 4:7] = acc
        self._imu_n += 1

    def _imu_span(self, t0: float, t1: float):
        """Measurements covering [t0, t1] incl. one sample beyond each end."""
        i0 = max(int(np.searchsorted(self.imu_t, t0, "right")) - 1, 0)
        i1 = min(int(np.searchsorted(self.imu_t, t1, "left")) + 1, len(self.imu_t))
        return i0, i1

    def _trim_imu_buffer(self):
        if not self.frames:
            return
        t_min = self.frames[0].timestamp - 0.5
        keep = self.imu_t >= t_min
        first = int(np.argmax(keep)) if keep.any() else len(self.imu_t)
        first = max(first - 1, 0)
        if first > 0:
            # archive instead of dropping: the final BA re-propagates IMU
            # links over archived keyframe spans
            rows = self._imu_buf[self._imu_start:self._imu_start + first]
            need = self._arch_imu_n + first
            if need > len(self._arch_imu_buf):
                cap = max(need, 2 * len(self._arch_imu_buf))
                buf = np.zeros((cap, 7))
                buf[: self._arch_imu_n] = self._arch_imu_buf[: self._arch_imu_n]
                self._arch_imu_buf = buf
            self._arch_imu_buf[self._arch_imu_n:need] = rows
            self._arch_imu_n = need
            self._imu_start += first

    def _full_imu_arrays(self):
        """(t, gyr, acc) over archive + live buffers (time-ordered)."""
        return (
            np.append(self.arch_imu_t, self.imu_t),
            np.vstack([self.arch_imu_gyr, self.imu_gyr]),
            np.vstack([self.arch_imu_acc, self.imu_acc]),
        )

    # ---------------------------------------------------------------- states
    def add_state(self, timestamp: float) -> int:
        """Create a new state at `timestamp`.

        First call: gravity-aligned initialisation from accelerometer mean +
        strong priors (reference ViGraph::addStatesInitialise).  Subsequent:
        IMU propagation from the newest state (addStatesPropagate).
        """
        cfg = self.cfg
        if not self.frames:
            i0, i1 = self._imu_span(timestamp - 0.2, timestamp + 0.01)
            acc_mean = self.imu_acc[i0:i1].mean(axis=0)
            gyr_mean = self.imu_gyr[i0:i1].mean(axis=0)
            T0 = np.asarray(
                pre.init_pose_from_accel(
                    jnp.asarray(acc_mean), jnp.asarray(gyr_mean)
                )
            )
            sb0 = np.zeros(9)
            sb0[3:6] = gyr_mean  # stationary assumption: gyro mean = bias
            f = FrameState(self._next_fid, timestamp, T0, sb0, is_keyframe=True)
            self.frames.append(f)
            self._next_fid += 1
            # priors
            self.prior_fid = f.fid
            self.prior_T = T0.copy()
            si = np.zeros((6, 6))
            si[0:3, 0:3] = np.eye(3) / cfg.init_pos_sigma
            si[3, 3] = si[4, 4] = 1.0 / cfg.init_rollpitch_sigma
            si[5, 5] = 1.0 / cfg.init_yaw_sigma
            self.prior_sqrt_info = si
            self.prior_sb = sb0.copy()
            sbsi = np.diag(
                [1.0 / cfg.init_v_sigma] * 3
                + [1.0 / cfg.imu.sigma_bg] * 3
                + [1.0 / cfg.imu.sigma_ba] * 3
            )
            self.prior_sb_sqrt_info = sbsi
            return f.fid

        last = self.frames[-1]
        assert timestamp > last.timestamp, "states must be added in time order"
        # host-side prediction (imu/preintegration_np.py): the per-frame
        # propagation is microseconds of math; the device programs are
        # reserved for the factor-grade batched preintegration
        i0, i1 = self._imu_span(last.timestamp, timestamp)
        T1, v1 = pre_np.predict_state(
            cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
            self.imu_acc[i0:i1], last.timestamp, timestamp,
            last.T_WS, last.sb[0:3], last.sb[3:6], last.sb[6:9],
        )
        sb1 = np.concatenate([v1, last.sb[3:9]])
        f = FrameState(self._next_fid, timestamp, T1, sb1)
        self.frames.append(f)
        self._next_fid += 1
        return f.fid

    def _preintegrate_batch_fn(self):
        """ONE vmapped jitted program preintegrating every IMU link of the
        window (+ whitening): replaces M per-link program dispatches per
        build."""
        key = "preint_batch"
        if key not in self._jit_cache:
            cfg = self.cfg
            out_dtype = jax.dtypes.canonicalize_dtype(cfg.dtype)

            @jax.jit
            def run(t, gyr, acc, mask, t0, t1, bg, ba, valid):
                def one(t_, g_, a_, m_, t0_, t1_, bg_, ba_):
                    batch = pre.ImuBatch(t=t_, gyr=g_, acc=a_, mask=m_)
                    return pre.preintegrate(cfg.imu, batch, t0_, t1_, bg_, ba_)

                P = jax.vmap(one)(t, gyr, acc, mask, t0, t1, bg, ba)
                eye15 = jnp.eye(15, dtype=P.P.dtype)
                P_cov = jnp.where(valid[:, None, None], P.P, eye15[None])
                W = jax.vmap(imu_factor.sqrt_information)(P_cov)
                W = jnp.where(valid[:, None, None], W, eye15[None])
                P = jax.tree.map(
                    lambda x: x.astype(out_dtype)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x,
                    P,
                )
                return P, W.astype(out_dtype)

            self._jit_cache[key] = run
        return self._jit_cache[key]

    def _span_buffers(self, spans, n_rows: int, S: int | None = None,
                      imu_arrays=None):
        """Numpy padded IMU-span buffers (t, gyr, acc, mask, t0, t1, bg,
        ba, valid) for `n_rows` links — uploaded with the problem so the
        batched preintegration FUSES into the solve program (one device
        execution instead of two)."""
        cfg = self.cfg
        S = S or cfg.cap_imu_samples
        if imu_arrays is None:
            t_arr, gyr_arr, acc_arr = self.imu_t, self.imu_gyr, self.imu_acc
        else:
            t_arr, gyr_arr, acc_arr = imu_arrays
        m = len(spans)
        assert m <= n_rows
        # build at the canonical device dtype: f64 buffers double the
        # per-solve upload for nothing when the device runs f32 (times are
        # dataset-rebased, so f32 keeps microsecond resolution)
        bdt = np.dtype(jax.dtypes.canonicalize_dtype(np.float64))
        tB = np.zeros((n_rows, S), bdt)
        gyrB = np.zeros((n_rows, S, 3), bdt)
        accB = np.zeros((n_rows, S, 3), bdt)
        maskB = np.zeros((n_rows, S), bool)
        t0B = np.zeros(n_rows, bdt)
        t1B = np.ones(n_rows, bdt) * 1e-3
        bgB = np.zeros((n_rows, 3), bdt)
        baB = np.zeros((n_rows, 3), bdt)
        valid = np.zeros(n_rows, bool)
        for r, (t0, t1, bg, ba) in enumerate(spans):
            i0 = max(int(np.searchsorted(t_arr, t0, "right")) - 1, 0)
            i1 = min(int(np.searchsorted(t_arr, t1, "left")) + 1, len(t_arr))
            n = i1 - i0
            if n > S:
                # degrade, don't die: uniformly subsample the span to fit
                # the buffer (coarser integration steps ≙ the reference's
                # warn-and-cap behaviour rather than an assert)
                logging.warning(
                    "IMU span %d samples exceeds capacity %d — "
                    "subsampling", n, S)
                idx = np.unique(np.linspace(i0, i1 - 1, S).astype(int))
                n = len(idx)
            else:
                idx = np.arange(i0, i1)
            tB[r] = t1 + 1.0
            tB[r, :n] = t_arr[idx]
            gyrB[r, :n] = gyr_arr[idx]
            accB[r, :n] = acc_arr[idx]
            maskB[r, :n] = True
            t0B[r], t1B[r] = t0, t1
            bgB[r], baB[r] = bg, ba
            valid[r] = True
        return (tB, gyrB, accB, maskB, t0B, t1B, bgB, baB, valid)

    def _preintegrate_batch(self, spans, n_rows: int, S: int | None = None,
                            imu_arrays=None):
        """spans: list of (t0, t1, bg, ba); returns (Preintegrated batched
        to n_rows, W (n_rows,15,15)) as device arrays, invalid rows padded
        with identity.  `S` overrides the per-span sample capacity and
        `imu_arrays` the measurement source (final BA passes the archived
        + live buffers with a larger capacity)."""
        run = self._preintegrate_batch_fn()
        return run(*self._span_buffers(spans, n_rows, S, imu_arrays))

    def repredict_after(self, fid: int):
        """Re-run the IMU prediction of every chain state NEWER than
        `fid` (the newest frame covered by a just-collected solve), so
        the next dispatched problem linearises around predictions rolled
        forward from corrected states — never overwriting a solved pose
        with a prediction."""
        chain = self._chain_frames()
        idx = None
        for i, f in enumerate(chain):
            if f.fid <= fid:
                idx = i
        if idx is None:
            return
        self.repredict_latest(tail=len(chain) - 1 - idx)

    def repredict_latest(self, tail: int = 1):
        """Re-run the IMU prediction of the newest `tail` chain states
        from their (just-corrected) predecessors — used by the pipelined
        frame loop after collecting a previous solve, so the dispatched
        problem linearises around the corrected prediction rather than
        the stale one."""
        if tail <= 0:
            return
        chain = self._chain_frames()
        for k in range(max(len(chain) - tail, 1), len(chain)):
            a, b = chain[k - 1], chain[k]
            i0, i1 = self._imu_span(a.timestamp, b.timestamp)
            if i1 - i0 < 2:
                continue
            T1, v1 = pre_np.predict_state(
                self.cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
                self.imu_acc[i0:i1], a.timestamp, b.timestamp,
                a.T_WS, a.sb[0:3], a.sb[3:6], a.sb[6:9],
            )
            b.T_WS = T1
            b.sb = np.concatenate([v1, a.sb[3:9]])

    # -------------------------------------------------- chained imu links
    def _chain_frames(self) -> List[FrameState]:
        """Frames on the live IMU chain (non-pose-graph), in time order."""
        return [f for f in self.frames if not f.pose_graph_frame]

    def _link_for(self, a: FrameState, b: FrameState):
        """Cached chained preintegration + sqrt-info for chain link a->b.

        Cache policy ≙ ImuError: constructed incrementally as frames
        arrive, re-propagated from raw samples only when the bias moved
        past the redo thresholds (okvis_ceres/src/ImuError.cpp:258) AND the
        raw span is still short enough to re-scan; merged links otherwise
        rely on the factor's first-order bias correction."""
        cfg = self.cfg
        key = (a.fid, b.fid)
        ent = self.imu_links.get(key)
        bg, ba = a.sb[3:6], a.sb[6:9]
        if ent is not None:
            e = ent[0]
            if (np.linalg.norm(bg - e.lin_bg) < cfg.imu_bias_redo_g
                    and np.linalg.norm(ba - e.lin_ba) < cfg.imu_bias_redo_a):
                return ent
            i0, i1 = self._imu_span(a.timestamp, b.timestamp)
            if i1 - i0 > cfg.imu_redo_max_samples or not self._imu_covers(
                    i0, i1, a.timestamp, b.timestamp):
                return ent  # keep composed state; first-order correction
        ent = self._host_preintegrate_link(a.timestamp, b.timestamp, bg, ba)
        self.imu_links[key] = ent
        return ent

    def _imu_covers(self, i0: int, i1: int, t0: float, t1: float) -> bool:
        """True if live samples [i0, i1) actually bracket [t0, t1]."""
        if i1 - i0 < 2:
            return False
        return (self.imu_t[i0] <= t0 + 1e-6
                and self.imu_t[i1 - 1] >= t1 - 1e-6)

    def _host_preintegrate_link(self, t0: float, t1: float, bg, ba):
        """f64 host preintegration over the live raw buffer, with a weak
        fallback when samples don't cover the span (component reload,
        trimmed buffer): degrade to a near-uninformative factor instead of
        dying — the reference warns and caps rather than asserting."""
        i0, i1 = self._imu_span(t0, t1)
        e = pre_np.preintegrate_full(
            self.cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
            self.imu_acc[i0:i1], t0, t1, np.asarray(bg, float),
            np.asarray(ba, float),
        )
        span = max(t1 - t0, 1e-3)
        if e.dt < 0.5 * span:
            logging.warning(
                "IMU link [%0.3f, %0.3f] covered %0.3fs of %0.3fs — "
                "weak-factor fallback", t0, t1, e.dt, span)
            e = e._replace(dt=span, P=np.eye(15) * 1e6)
        W = pre_np.sqrt_information(e.P)
        return (e, W)

    def _merge_chain_link(self, mid_fid: int):
        """Compose the two cached links around `mid_fid` before it leaves
        the IMU chain (≙ eliminateImuFrames' ImuError::append merge,
        ViSlamBackend.cpp:511), then drop links touching it."""
        chain = self._chain_frames()
        idx = next(
            (i for i, f in enumerate(chain) if f.fid == mid_fid), None)
        if idx is not None and 0 < idx < len(chain) - 1:
            a, m, b = chain[idx - 1], chain[idx], chain[idx + 1]
            ea, _ = self._link_for(a, m)
            eb, _ = self._link_for(m, b)
            merged = pre_np.compose(ea, eb)
            self.imu_links[(a.fid, b.fid)] = (
                merged, pre_np.sqrt_information(merged.P))
        self.imu_links = {
            k: v for k, v in self.imu_links.items() if mid_fid not in k
        }

    def _prune_imu_links(self):
        chain_fids = {f.fid for f in self._chain_frames()}
        self.imu_links = {
            k: v for k, v in self.imu_links.items()
            if k[0] in chain_fids and k[1] in chain_fids
        }

    @staticmethod
    def _stack_links(entries, Mcap: int):
        """Batch per-link (Preintegrated, W) into (Preintegrated[Mcap], W
        (Mcap,15,15)) with identity-padded invalid rows."""
        dq = np.tile(np.array([0.0, 0, 0, 1.0]), (Mcap, 1))
        z3 = np.zeros((Mcap, 3))
        z33 = np.zeros((Mcap, 3, 3))
        P = np.tile(np.eye(15), (Mcap, 1, 1))
        W = np.tile(np.eye(15), (Mcap, 1, 1))
        dt = np.full(Mcap, 1e-3)
        out = pre.Preintegrated(
            dq=dq, dp=z3.copy(), dv=z3.copy(),
            dp_dbg=z33.copy(), dp_dba=z33.copy(),
            dv_dbg=z33.copy(), dv_dba=z33.copy(), dq_dbg=z33.copy(),
            P=P, dt=dt, lin_bg=z3.copy(), lin_ba=z3.copy(),
        )
        for m, (e, w) in enumerate(entries):
            for fld in pre.Preintegrated._fields:
                getattr(out, fld)[m] = getattr(e, fld)
            W[m] = w
        return out, W

    # ------------------------------------------------------------------ gps
    def add_gps_measurement(self, t: float, pos_G, err):
        """(≙ ViGraph::addGpsMeasurement + the status machine)."""
        self.gps_meas.append(
            (float(t), np.asarray(pos_G, float), np.asarray(err, float))
        )
        if self.gps_status == "Off":
            self.gps_status = "Idle"
        if self.gps_status == "Idle":
            self._attempt_gps_alignment()

    def _gps_state_pos(self, t: float) -> Optional[np.ndarray]:
        """Interpolated estimator position at time t (host-side)."""
        frames = sorted(
            list(self.archive_frames.values()) + self.frames,
            key=lambda f: f.timestamp,
        )
        if not frames or t < frames[0].timestamp - 0.2 or t > frames[-1].timestamp + 0.2:
            return None
        ts = np.array([f.timestamp for f in frames])
        i = int(np.clip(np.searchsorted(ts, t), 1, len(ts) - 1))
        a, b = frames[i - 1], frames[i]
        dt = max(b.timestamp - a.timestamp, 1e-9)
        w = np.clip((t - a.timestamp) / dt, 0.0, 1.0)
        return (1 - w) * a.T_WS[:3] + w * b.T_WS[:3]

    def _attempt_gps_alignment(self):
        """Estimate the 4-dof T_GW by yaw+translation least squares over
        (trajectory, fix) pairs (≙ attemptFullGpsAlignment)."""
        pairs = []
        for t, pg, err in self.gps_meas:
            pw = self._gps_state_pos(t)
            if pw is not None:
                pairs.append((pw, pg))
        if len(pairs) < self.gps_min_fixes:
            return
        PW = np.stack([p[0] for p in pairs])
        PG = np.stack([p[1] for p in pairs])
        if np.ptp(PW, axis=0)[:2].max() < self.gps_min_span:
            return  # not enough horizontal motion to observe yaw
        # yaw: maximise sum cos(yaw)*(x.x'+y.y') + sin(yaw)*(x.y'-y.x')
        cw = PW - PW.mean(0)
        cg = PG - PG.mean(0)
        a = float(np.sum(cw[:, 0] * cg[:, 0] + cw[:, 1] * cg[:, 1]))
        b = float(np.sum(cw[:, 0] * cg[:, 1] - cw[:, 1] * cg[:, 0]))
        yaw = np.arctan2(b, a)
        q = se3np.delta_q(np.array([0.0, 0.0, yaw]))
        Rz = se3np.quat_to_matrix(q)
        tr = PG.mean(0) - Rz @ PW.mean(0)
        self.T_GW = np.concatenate([tr, q])
        self.gps_status = "Initialised"

    def _check_gps_dropout(self, t_now: float):
        if self.gps_status == "Initialised" and self.gps_meas:
            if t_now - self.gps_meas[-1][0] > self.gps_timeout:
                # dropout: keep T_GW but flag for realignment on return
                self.gps_status = "ReInitialising"
        elif self.gps_status == "ReInitialising" and self.gps_meas:
            if t_now - self.gps_meas[-1][0] < self.gps_timeout:
                self._attempt_gps_alignment()

    # ------------------------------------------------------------- landmarks
    def add_landmark(self, hp_W) -> int:
        """Returns the new landmark id, or -1 when the capacity table is
        full (callers skip; slots free up at the next marginalisation)."""
        if len(self.lm_ids) >= self.cfg.cap_landmarks:
            return -1
        lid = self._next_lid
        self._next_lid += 1
        self.lm_index[lid] = len(self.lm_ids)
        self.lm_ids.append(lid)
        self.hp_W = np.vstack([self.hp_W, np.asarray(hp_W, np.float64)[None]])
        self.lm_quality = np.append(self.lm_quality, 0.0)
        return lid

    def add_observation(
        self, fid: int, cam: int, lid: int, uv, sigma=None,
        depth: float = 0.0, depth_sigma: float = 0.0,
    ):
        """Add a reprojection observation; optionally attach a per-keypoint
        depth prior (≙ ceres::DepthErrorT; depth_sigma>0 activates it)."""
        self.obs_fid = np.append(self.obs_fid, fid)
        self.obs_cam = np.append(self.obs_cam, cam)
        self.obs_lid = np.append(self.obs_lid, lid)
        self.obs_uv = np.vstack([self.obs_uv, np.asarray(uv, np.float64)[None]])
        self.obs_sigma = np.append(
            self.obs_sigma, self.cfg.keypoint_sigma_px if sigma is None else sigma
        )
        self.obs_depth = np.append(self.obs_depth, depth)
        self.obs_depth_sigma = np.append(self.obs_depth_sigma, depth_sigma)
        self.obs_uid = np.append(self.obs_uid, self._obs_uid_next)
        self._obs_uid_next += 1

    def add_observations_batch(
        self, fid: int, cam, lid, uv, sigma=None, depth=None,
        depth_sigma=None,
    ):
        """Vectorised multi-observation add — one array reallocation instead
        of one per observation (the per-frame hot path adds hundreds)."""
        n = len(lid)
        if n == 0:
            return
        uv = np.asarray(uv, np.float64).reshape(n, 2)
        self.obs_fid = np.append(self.obs_fid, np.full(n, fid, np.int64))
        self.obs_cam = np.append(
            self.obs_cam, np.broadcast_to(np.asarray(cam, np.int64), (n,))
        )
        self.obs_lid = np.append(self.obs_lid, np.asarray(lid, np.int64))
        self.obs_uv = np.vstack([self.obs_uv, uv])
        self.obs_sigma = np.append(
            self.obs_sigma,
            np.full(n, self.cfg.keypoint_sigma_px) if sigma is None
            else np.asarray(sigma, np.float64),
        )
        self.obs_depth = np.append(
            self.obs_depth,
            np.zeros(n) if depth is None else np.asarray(depth, np.float64),
        )
        self.obs_depth_sigma = np.append(
            self.obs_depth_sigma,
            np.zeros(n) if depth_sigma is None
            else np.asarray(depth_sigma, np.float64),
        )
        self.obs_uid = np.append(
            self.obs_uid,
            np.arange(self._obs_uid_next, self._obs_uid_next + n),
        )
        self._obs_uid_next += n

    def set_keyframe(self, fid: int, is_kf: bool = True):
        self._frame_by_id(fid).is_keyframe = is_kf

    def _frame_by_id(self, fid: int) -> FrameState:
        for f in self.frames:
            if f.fid == fid:
                return f
        raise KeyError(fid)

    # ------------------------------------------------------------- optimise
    def _build_problem(self):
        cfg = self.cfg
        dtype = cfg.dtype
        K, L, C = cfg.cap_frames, cfg.cap_landmarks, self.C
        Ncap, Mcap = cfg.cap_obs, cfg.cap_imu_links
        nf = len(self.frames)
        assert nf <= K, f"{nf} frames exceed capacity {K}"
        nl = len(self.lm_ids)
        assert nl <= L, f"{nl} landmarks exceed capacity {L}"

        fid2slot = {f.fid: i for i, f in enumerate(self.frames)}

        # cached immutable template: empty_problem creates ~50 device
        # arrays; per-frame rebuilds only _replace the live fields
        if "empty_p" not in self._jit_cache:
            self._jit_cache["empty_p"] = prb.empty_problem(
                K=K, L=L, C=C, N=Ncap, M=Mcap, R=cfg.cap_rel_edges,
                G=cfg.cap_gps, Q=cfg.cap_icp, dtype=dtype,
            )
        p = self._jit_cache["empty_p"]

        T_WS = np.stack([f.T_WS for f in self.frames]) if nf else np.zeros((0, 7))
        sb = np.stack([f.sb for f in self.frames]) if nf else np.zeros((0, 9))
        frame_valid = np.zeros(K, bool)
        frame_valid[:nf] = True
        pose_fixed = np.zeros(K, bool)
        pose_fixed[:nf] = [
            f.pose_fixed or (f.pose_graph_frame and not f.expanded)
            for f in self.frames
        ]
        # speed/bias only estimable for IMU-chained (non-pose-graph) frames
        sb_fixed = np.ones(K, bool)
        sb_fixed[:nf] = [f.pose_graph_frame or f.sb_fixed for f in self.frames]

        # observations: keep only those whose frame & landmark are active
        # (vectorised: searchsorted over the sorted fid / lid tables — the
        # python-loop version cost milliseconds per frame at 5k obs)
        fid_arr = np.fromiter(fid2slot.keys(), np.int64, nf)
        slot_arr = np.fromiter(fid2slot.values(), np.int64, nf)
        f_order = np.argsort(fid_arr)
        fid_sorted = fid_arr[f_order]
        slot_sorted = slot_arr[f_order]
        lm_arr = np.asarray(self.lm_ids, np.int64)
        l_order = np.argsort(lm_arr)
        lm_sorted = lm_arr[l_order]
        row_sorted = np.arange(nl, dtype=np.int64)[l_order]

        def _lookup(sorted_keys, sorted_vals, queries):
            pos = np.searchsorted(sorted_keys, queries)
            pos = np.clip(pos, 0, max(len(sorted_keys) - 1, 0))
            if len(sorted_keys):
                ok = sorted_keys[pos] == queries
                return sorted_vals[pos], ok
            return np.zeros(len(queries), np.int64), np.zeros(
                len(queries), bool
            )

        if len(self.obs_fid):
            obs_slot_all, f_ok = _lookup(
                fid_sorted, slot_sorted, self.obs_fid
            )
            obs_row_all, l_ok = _lookup(lm_sorted, row_sorted, self.obs_lid)
            live = f_ok & l_ok
        else:
            live = np.zeros((0,), bool)
            obs_slot_all = np.zeros((0,), np.int64)
            obs_row_all = np.zeros((0,), np.int64)
        obs_src = np.nonzero(live)[0]  # problem row -> host obs index
        obs_src_uids = None
        if len(obs_src) > Ncap:
            # degrade, don't die: drop the OLDEST live observations beyond
            # capacity (obs arrays are append-ordered)
            logging.warning(
                "window observations %d exceed capacity %d — dropping "
                "oldest", len(obs_src), Ncap)
            obs_src = obs_src[-Ncap:]
            live = np.zeros_like(live)
            live[obs_src] = True
        of = self.obs_fid[live]
        obs_src_uids = self.obs_uid[live]
        n_obs = len(of)
        obs_frame = np.zeros(Ncap, np.int32)
        obs_cam = np.zeros(Ncap, np.int32)
        obs_lm = np.zeros(Ncap, np.int32)
        obs_uv = np.zeros((Ncap, 2))
        obs_si = np.ones(Ncap)
        obs_valid = np.zeros(Ncap, bool)
        obs_depth = np.ones(Ncap)
        obs_depth_si = np.ones(Ncap)
        obs_depth_valid = np.zeros(Ncap, bool)
        obs_frame[:n_obs] = obs_slot_all[live]
        obs_cam[:n_obs] = self.obs_cam[live]
        obs_lm[:n_obs] = obs_row_all[live]
        obs_uv[:n_obs] = self.obs_uv[live]
        obs_si[:n_obs] = 1.0 / self.obs_sigma[live]
        obs_valid[:n_obs] = True
        dsig = self.obs_depth_sigma[live]
        has_d = dsig > 0
        obs_depth[:n_obs] = np.where(has_d, self.obs_depth[live], 1.0)
        obs_depth_si[:n_obs] = np.where(has_d, 1.0 / np.maximum(dsig, 1e-12), 1.0)
        obs_depth_valid[:n_obs] = has_d

        # imu links between consecutive IMU-chained frames, served from the
        # chained-preintegration cache (pose-graph frames are excluded —
        # their kinematic information lives in the two-pose edges).  The
        # cached f64 deltas + sqrt-infos upload directly; the factor applies
        # first-order bias correction around each link's linearisation
        # point, so no raw-sample span ever re-scans inside the solve.
        chain = [
            i for i, f in enumerate(self.frames) if not f.pose_graph_frame
        ]
        imu_i = np.zeros(Mcap, np.int32)
        imu_j = np.zeros(Mcap, np.int32)
        imu_valid = np.zeros(Mcap, bool)
        link_rows = []
        for m, (ia, ib) in enumerate(zip(chain[:-1], chain[1:])):
            a, b = self.frames[ia], self.frames[ib]
            assert m < Mcap
            link_rows.append(self._link_for(a, b))
            imu_i[m] = ia
            imu_j[m] = ib
            imu_valid[m] = True
        imu_pre_b, imu_W_b = self._stack_links(link_rows, Mcap)

        # landmarks
        hp = np.tile(np.array([0, 0, 0, 1.0]), (L, 1))
        hp[:nl] = self.hp_W
        lm_valid = np.zeros(L, bool)
        lm_valid[:nl] = True

        # priors
        pose_prior_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        pose_prior_si = np.tile(np.eye(6), (K, 1, 1))
        pose_prior_valid = np.zeros(K, bool)
        sb_prior = np.zeros((K, 9))
        sb_prior_si = np.tile(np.eye(9), (K, 1, 1))
        sb_prior_valid = np.zeros(K, bool)
        if self.prior_fid is not None and self.prior_fid in fid2slot:
            s = fid2slot[self.prior_fid]
            pose_prior_T[s] = self.prior_T
            pose_prior_si[s] = self.prior_sqrt_info
            pose_prior_valid[s] = True
            sb_prior[s] = self.prior_sb
            sb_prior_si[s] = self.prior_sb_sqrt_info
            sb_prior_valid[s] = True
        # weak damping prior on every expanded pose-graph (loop-closure)
        # frame, anchored at its CURRENT estimate each assembly: these
        # frames carry no IMU chain and only restored observations, and
        # when merges/outlier cuts leave one under-constrained the robust
        # reprojection loss makes scattering it nearly cost-free — the
        # solver then parks it hundreds of metres out, and re-archival
        # bakes the garbage pose into the long-term graph (measured: 15
        # scattered nodes at up to 1394 m poisoned every later background
        # snapshot on the 185 s circuit).  sigma 10 m / 3 rad: for a
        # frame with NO effective constraints the solve just keeps it at
        # the anchor (any nonzero stiffness does), while for constrained
        # frames the prior is orders below the observation information so
        # refinement converges through it
        # (test_expand_merge_recovers_drift measures drift recovery).
        damp_si = np.diag([0.1, 0.1, 0.1, 0.3, 0.3, 0.3])
        for sl, fr in enumerate(self.frames):
            if (fr.pose_graph_frame and fr.expanded and not fr.pose_fixed
                    and not pose_prior_valid[sl]):
                # FIXED anchor (pre-hold pose, moved only by applied
                # corrections): re-anchoring at the current estimate each
                # assembly lets the pose random-walk metres per solve with
                # no restoring force (measured: 143 m over one hold span)
                anchor = (fr.pre_hold_T if fr.pre_hold_T is not None
                          else fr.T_WS)
                pose_prior_T[sl] = anchor
                pose_prior_si[sl] = damp_si
                pose_prior_valid[sl] = True

        # relative pose edges (weakest dropped beyond capacity)
        Rcap = cfg.cap_rel_edges
        if len(self.rel_edges) > Rcap:
            self.rel_edges.sort(
                key=lambda e: -float(np.trace(e["sqrt_info"]))
            )
            self.rel_edges = self.rel_edges[:Rcap]
        rel_i = np.zeros(Rcap, np.int32)
        rel_j = np.zeros(Rcap, np.int32)
        rel_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (Rcap, 1))
        rel_si = np.tile(np.eye(6), (Rcap, 1, 1))
        rel_valid = np.zeros(Rcap, bool)
        nrel = 0
        for e in self.rel_edges:
            if e["i"] in fid2slot and e["j"] in fid2slot:
                rel_i[nrel] = fid2slot[e["i"]]
                rel_j[nrel] = fid2slot[e["j"]]
                rel_T[nrel] = e["T_ij"]
                rel_si[nrel] = e["sqrt_info"]
                rel_valid[nrel] = True
                nrel += 1

        # GNSS factors: newest fixes attached to the latest frame at/before
        # the fix time, with a preintegration bridging the gap (async factor).
        # GNSS-free runs allocate zero capacity so the whole factor family
        # drops out of the compiled program (one recompile when GPS appears).
        Gcap = cfg.cap_gps if self.gps_status != "Off" else 0
        gps_frame = np.zeros(Gcap, np.int32)
        gps_p_G = np.zeros((Gcap, 3))
        gps_si = np.tile(np.eye(3), (Gcap, 1, 1))
        gps_valid = np.zeros(Gcap, bool)
        gps_pres = []
        if self.gps_status in ("Initialised", "ReInitialising") and nf:
            t_lo = self.frames[0].timestamp
            recent = [m for m in self.gps_meas if m[0] >= t_lo][-Gcap:]
            g = 0
            for t_g, pos_G, err in recent:
                host = None
                for i in range(nf - 1, -1, -1):
                    if self.frames[i].timestamp <= t_g + 1e-9:
                        host = i
                        break
                if host is None:
                    continue
                hf = self.frames[host]
                gps_frame[g] = host
                gps_p_G[g] = pos_G
                gps_si[g] = np.diag(1.0 / np.maximum(err, 1e-3))
                gps_valid[g] = True
                gps_pres.append(
                    (hf.timestamp, max(t_g, hf.timestamp), hf.sb[3:6],
                     hf.sb[6:9])
                )
                g += 1
        gps_bufs = self._span_buffers(gps_pres, Gcap) if Gcap else None

        # numpy leaves throughout: the jitted solver call transfers them in
        # one batch at dispatch — eager jnp.asarray here would pay ~40
        # individual host-to-device transfers per build
        npdt = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
        cvt = lambda x: np.asarray(x, npdt)
        T_full = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        T_full[:nf] = T_WS
        sb_full = np.zeros((K, 9))
        sb_full[:nf] = sb
        p = p._replace(
            T_GW=cvt(self.T_GW),
            tgw_fixed=np.asarray(self.gps_status != "Initialised"),
            gps_frame=np.asarray(gps_frame),
            gps_p_G=cvt(gps_p_G),
            gps_r_SA=cvt(self.gps_r_SA),
            gps_sqrt_info=cvt(gps_si),
            gps_valid=np.asarray(gps_valid),
        )
        if cfg.do_extrinsics:
            si_ext = np.diag(
                np.concatenate(
                    [
                        np.full(3, 1.0 / max(cfg.extrinsics_sigma_r, 1e-9)),
                        np.full(3, 1.0 / max(cfg.extrinsics_sigma_alpha, 1e-9)),
                    ]
                )
            )
            p = p._replace(
                ext_fixed=np.zeros((self.C,), bool),
                ext_prior_T=cvt(self.T_SC_prior),
                ext_prior_sqrt_info=cvt(np.tile(si_ext, (self.C, 1, 1))),
                ext_prior_valid=np.ones((self.C,), bool),
            )
        p = p._replace(
            T_WS=cvt(T_full),
            sb=cvt(sb_full),
            frame_valid=frame_valid,
            pose_fixed=pose_fixed,
            sb_fixed=sb_fixed,
            T_SC=cvt(self.T_SC),
            hp_W=cvt(hp),
            lm_valid=lm_valid,
            obs_frame=obs_frame,
            obs_cam=obs_cam,
            obs_lm=obs_lm,
            obs_uv=cvt(obs_uv),
            obs_sqrt_info=cvt(obs_si),
            obs_valid=obs_valid,
            obs_depth=cvt(obs_depth),
            obs_depth_si=cvt(obs_depth_si),
            obs_depth_valid=obs_depth_valid,
            imu_i=imu_i,
            imu_j=imu_j,
            imu_valid=imu_valid,
            imu_pre=jax.tree.map(cvt, imu_pre_b),
            imu_sqrt_info=cvt(imu_W_b),
            pose_prior_T=cvt(pose_prior_T),
            pose_prior_sqrt_info=cvt(pose_prior_si),
            pose_prior_valid=pose_prior_valid,
            sb_prior=cvt(sb_prior),
            sb_prior_sqrt_info=cvt(sb_prior_si),
            sb_prior_valid=sb_prior_valid,
            rel_i=rel_i,
            rel_j=rel_j,
            rel_T=cvt(rel_T),
            rel_sqrt_info=cvt(rel_si),
            rel_valid=rel_valid,
        )
        # live per-point submap ICP rows (≙ SubmapIcpError live factors)
        if cfg.cap_icp and self.icp_map is not None and self.icp_live:
            a_fid, b_fid, pts_S, sig = self.icp_live
            if a_fid in fid2slot and b_fid in fid2slot:
                Qc = cfg.cap_icp
                n = min(len(pts_S), Qc)
                icp_p = np.zeros((Qc, 3))
                icp_p[:n] = pts_S[:n]
                icp_valid = np.zeros(Qc, bool)
                icp_valid[:n] = True
                p = p._replace(
                    icp_a=np.full(Qc, fid2slot[a_fid], np.int32),
                    icp_b=np.full(Qc, fid2slot[b_fid], np.int32),
                    icp_p_B=cvt(icp_p),
                    icp_si=cvt(np.full(Qc, 1.0 / max(sig, 1e-3))),
                    icp_valid=icp_valid,
                    icp_map=self.icp_map,
                )
        return p, fid2slot, gps_bufs, (obs_src, obs_src_uids)

    def set_icp_map(self, sm, grid_cfg):
        """Register the active submap as the live ICP target (called after
        each integration; shapes are static so no recompiles)."""
        self.icp_map = sm
        self.icp_grid_cfg = grid_cfg

    def set_live_icp_points(self, anchor_fid: int, owner_fid: int,
                            pts_S: np.ndarray, sigma: float):
        """Refresh the live frame-to-map per-point factor set (the previous
        sweep's rows are dropped, matching the reference's per-frame live
        factor refresh, ThreadedSlam.cpp:781-845)."""
        self.icp_live = (anchor_fid, owner_fid, np.asarray(pts_S), sigma)

    def _optimize_fn(self, rcap: int, iters: int, pose_only: bool,
                     use_depth: bool = False, use_icp: bool = False,
                     gated: bool = False, gate_iters2: int = 2):
        key = ("opt", rcap, iters, pose_only, use_depth, use_icp, gated,
               gate_iters2, self.cfg.early_exit_rel)
        if key not in self._jit_cache:
            cfg = gn.SolverConfig(
                max_iterations=iters,
                imu_params=self.cfg.imu,
                estimate_landmarks=not pose_only,
                use_depth=use_depth,
                use_ext_priors=self.cfg.do_extrinsics,
                icp_cfg=self.icp_grid_cfg if use_icp else None,
                early_exit_rel=self.cfg.early_exit_rel,
            )
            imu_params = self.cfg.imu
            out_dtype = jax.dtypes.canonicalize_dtype(self.cfg.dtype)

            def preint(bufs, whiten):
                t, gyr, acc, mask, t0, t1, bg, ba, valid = bufs

                def one(t_, g_, a_, m_, t0_, t1_, bg_, ba_):
                    batch = pre.ImuBatch(t=t_, gyr=g_, acc=a_, mask=m_)
                    return pre.preintegrate(
                        imu_params, batch, t0_, t1_, bg_, ba_
                    )

                P = jax.vmap(one)(t, gyr, acc, mask, t0, t1, bg, ba)
                W = None
                if whiten:
                    eye15 = jnp.eye(15, dtype=P.P.dtype)
                    P_cov = jnp.where(valid[:, None, None], P.P, eye15[None])
                    W = jax.vmap(imu_factor.sqrt_information)(P_cov)
                    W = jnp.where(valid[:, None, None], W, eye15[None])
                    W = W.astype(out_dtype)
                P = jax.tree.map(
                    lambda x: x.astype(out_dtype)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, P
                )
                return P, W

            def fused(p, cams, gps_bufs):
                # window IMU links arrive pre-chained (host cache, f64);
                # only the short GPS bridge spans still preintegrate
                # in-program — fused with the LM solve: ONE device
                # execution per optimise call
                if gps_bufs is not None:
                    Pg, _ = preint(gps_bufs, whiten=False)
                    p = p._replace(gps_pre=Pg)
                return gn.optimize(p, cams, cfg)

            if not gated:
                self._jit_cache[key] = jax.jit(fused)
                return self._jit_cache[key]

            cfg2 = cfg._replace(max_iterations=gate_iters2)

            def fused_gated(p, cams, gps_bufs, gate_slot, gate_px):
                # solve -> chi2 outlier gate on the gated frame's rows ->
                # short re-solve, ONE device execution (replaces the
                # Optimise + host reject_outliers + OutlierReoptimise
                # three-round-trip sequence; ≙ Frontend::removeOutliers
                # between the inline optimisation stages, Frontend.cpp:2398)
                if gps_bufs is not None:
                    Pg, _ = preint(gps_bufs, whiten=False)
                    p = p._replace(gps_pre=Pg)
                p1, _ = gn.optimize(p, cams, cfg)

                def obs_err(f, c, l, uv, si):
                    r, ok = reprojection_residual(
                        cams.at(c), p1.T_WS[f], p1.T_SC[c], p1.hp_W[l],
                        uv, si,
                    )
                    return jnp.linalg.norm(r) / jnp.maximum(si, 1e-12), ok

                err_px, proj_ok = jax.vmap(obs_err)(
                    p1.obs_frame, p1.obs_cam, p1.obs_lm, p1.obs_uv,
                    p1.obs_sqrt_info,
                )
                out = (
                    p1.obs_valid
                    & (p1.obs_frame == gate_slot)
                    & (~proj_ok | (err_px > gate_px))
                )
                p2 = p1._replace(obs_valid=p1.obs_valid & ~out)
                p3, cost = gn.optimize(p2, cams, cfg2)
                # ALL host-consumed outputs in ONE array (one
                # device-to-host fetch per solve):
                # [T_WS | sb | hp_W | outlier mask | cost] — at the solve
                # dtype (f32 on the GPU; f64 on CPU hosts where truncating
                # the state handoff each frame would bleed precision)
                pdt = p3.T_WS.dtype
                # outlier mask packed 16 bits/word (exact in f32): the
                # fetch time grows with payload, and the raw mask was
                # 60% of it
                ob = out.reshape(-1, 16).astype(jnp.float32)
                w16 = (
                    ob * (2.0 ** jnp.arange(16, dtype=jnp.float32))
                ).sum(axis=1)
                packed = jnp.concatenate([
                    p3.T_WS.reshape(-1),
                    p3.sb.reshape(-1).astype(pdt),
                    p3.hp_W.reshape(-1).astype(pdt),
                    w16.astype(pdt),
                    p3.T_SC.reshape(-1).astype(pdt),
                    p3.T_GW.reshape(-1).astype(pdt),
                    cost.reshape(1).astype(pdt),
                ])
                return p3, packed

            self._jit_cache[key] = jax.jit(fused_gated)
        return self._jit_cache[key]

    def _clamp_held(self, fr, T_new):
        """Writeback guard for held loop-closure frames: a solve result
        outside the pre-hold anchor's trust region is scatter (an
        under-constrained pose walked by the robust loss), not a
        correction — keep the anchor (see the damping-prior comment in
        the assembly)."""
        if fr.pre_hold_T is not None and np.linalg.norm(
            np.asarray(T_new)[:3] - fr.pre_hold_T[:3]
        ) > 8.0:
            return np.asarray(fr.pre_hold_T, np.float64).copy()
        return T_new

    def _writeback(self, p_opt, fid2slot):
        T = np.asarray(p_opt.T_WS)
        sb = np.asarray(p_opt.sb)
        hp = np.asarray(p_opt.hp_W)
        for f, slot in fid2slot.items():
            fr = self._frame_by_id(f)
            fr.T_WS = self._clamp_held(fr, T[slot])
            fr.sb = sb[slot]
        nl = len(self.lm_ids)
        self.hp_W = hp[:nl]
        if self.cfg.do_extrinsics:
            self.T_SC = np.asarray(p_opt.T_SC, np.float64)
        if self.gps_status == "Initialised":
            self.T_GW = np.asarray(p_opt.T_GW)

    def precompile(self, background: bool = True, full_ba: bool = True,
                   verbose: bool = False):
        """Force-compile (trace + XLA compile/cache-load + one execution)
        every device program the realtime, loop-closure and background
        full-graph paths can dispatch, so NONE of them compiles mid-run in
        front of the realtime queue (≙ the reference's realtime thread
        never stalling on loop closure, ThreadedSlam.cpp:949-960 — here
        the hazard is XLA compilation, which a warm persistent cache
        turns into a load).

        Call once at pipeline init; all dummy invocations use empty
        (all-invalid) problems, so no estimator state is touched."""
        import time as _time

        from okvis2x_tpu.solver import problem as prb

        t_start = _time.perf_counter()
        cfg = self.cfg

        def _log(tag, t0):
            if verbose:
                logging.info("precompile %s: %.1f s", tag,
                             _time.perf_counter() - t0)

        # 1. realtime gated window solve (all iteration buckets the budget
        # controller can request) + the non-gated solve the sync
        # loop-closure path dispatches
        if "empty_p" not in self._jit_cache:
            self._jit_cache["empty_p"] = prb.empty_problem(
                K=cfg.cap_frames, L=cfg.cap_landmarks, C=self.C,
                N=cfg.cap_obs, M=cfg.cap_imu_links, R=cfg.cap_rel_edges,
                G=cfg.cap_gps, Q=cfg.cap_icp, dtype=cfg.dtype,
            )
        p0 = self._jit_cache["empty_p"]
        npdt = np.dtype(jax.dtypes.canonicalize_dtype(cfg.dtype))
        cvt = lambda x: np.asarray(x, npdt)  # noqa: E731
        pre_b, W_b = self._stack_links([], cfg.cap_imu_links)
        p0 = p0._replace(imu_pre=jax.tree.map(cvt, pre_b),
                         imu_sqrt_info=cvt(W_b))
        if self.gps_status == "Off":
            # mirror _build_problem exactly: GNSS-free runs shrink the GPS
            # factor family to zero rows (a G=cap_gps dummy would compile
            # a DIFFERENT program than the one the frame loop dispatches)
            p0 = p0._replace(
                gps_frame=np.zeros(0, np.int32),
                gps_p_G=np.zeros((0, 3), npdt),
                gps_sqrt_info=np.zeros((0, 3, 3), npdt),
                gps_valid=np.zeros(0, bool),
            )
        rcap = int(p0.rel_valid.shape[0])
        iters_set = {cfg.max_iterations}
        if cfg.realtime_time_limit:
            iters_set |= {cfg.min_iterations,
                          (cfg.min_iterations + cfg.max_iterations) // 2}
        for iters in sorted(iters_set):
            t0 = _time.perf_counter()
            run = self._optimize_fn(rcap, iters, False, False, False,
                                    gated=True, gate_iters2=2)
            _p, packed = run(p0, self.cams, None, np.int32(-1),
                             np.float32(1e9))
            jax.block_until_ready(packed)
            _log(f"gated solve x{iters}", t0)
        t0 = _time.perf_counter()
        run = self._optimize_fn(rcap, cfg.max_iterations, False, False,
                                False)
        _p, cost = run(p0, self.cams, None)
        jax.block_until_ready(cost)
        _log("lc solve", t0)

        # 1b. first-frame initialisation program (eager; compiled here
        # rather than on frame 1)
        t0 = _time.perf_counter()
        jax.block_until_ready(pre.init_pose_from_accel(
            jnp.asarray(np.array([0.0, 0.0, 9.81])),
            jnp.asarray(np.zeros(3)),
        ))
        _log("init pose", t0)

        # 2. marginalisation two-pose edge program (fixed B=3 caps)
        t0 = _time.perf_counter()
        tpe = self._two_pose_edge_fn(3, 512, 128)
        id7 = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], npdt), (3, 1))
        out = tpe(
            id7, id7, np.asarray(self.T_SC, npdt),
            np.tile(np.array([0, 0, 0, 1], npdt), (3, 128, 1)),
            np.zeros((3, 128), bool), np.zeros((3, 512), np.int32),
            np.zeros((3, 512), np.int32), np.zeros((3, 512), np.int32),
            np.zeros((3, 512, 2), npdt), np.ones((3, 512), npdt),
            np.zeros((3, 512), bool),
        )
        jax.block_until_ready(out)
        _log("two-pose edges", t0)

        if not background:
            return _time.perf_counter() - t_start

        # 3. background full BA at the PINNED caps (one program serves the
        # whole <= full_ba_threshold early session) — preint program first
        # (its (M, S) shape is what the pinned snapshot dispatches).
        # Skipped when the dispatcher's threshold is 0 (pose-graph-only
        # background, the default).
        if not full_ba:
            t0 = _time.perf_counter()
            from okvis2x_tpu.graph import posegraph

            posegraph.precompile(iterations=15, dtype=cfg.dtype)
            _log("pose graph dense", t0)
            return _time.perf_counter() - t_start
        t0 = _time.perf_counter()
        K, L, N, R, M = self.FULL_BA_PIN
        empty_imu = (np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)))
        imu_pre, imu_si = self._preintegrate_batch(
            [], M, S=1024, imu_arrays=empty_imu)
        pf = prb.empty_problem(K=K, L=L, C=self.C, N=N, M=M, R=R,
                               dtype=cfg.dtype)
        pf = pf._replace(imu_pre=imu_pre, imu_sqrt_info=imu_si)
        aux = dict(caps=(K, L, N, R, M),
                   do_ext=cfg.do_extrinsics_final_ba)
        if aux["do_ext"]:
            pf = pf._replace(
                ext_fixed=jnp.zeros((self.C,), bool),
                ext_prior_valid=jnp.ones((self.C,), bool),
            )
        run = self._full_ba_run_fn(aux, 15)
        p_opt, cost = run(pf, self.cams)
        jax.block_until_ready(cost)
        _log("full BA (pinned)", t0)

        # 4. dense background pose-graph programs (both pinned K buckets)
        t0 = _time.perf_counter()
        from okvis2x_tpu.graph import posegraph

        posegraph.precompile(iterations=15, dtype=cfg.dtype)
        _log("pose graph dense", t0)
        return _time.perf_counter() - t_start

    def optimise(self, iterations: Optional[int] = None, pose_only: bool = False):
        """Run the window solver and write results back to host state."""
        from okvis2x_tpu.utils import timing

        iters = iterations or self.cfg.max_iterations
        if self.frames:
            self._check_gps_dropout(self.frames[-1].timestamp)
        with timing.Timer("3.1 BuildProblem"):
            p, fid2slot, gps_bufs, _ = self._build_problem()
        use_depth = bool(np.asarray(p.obs_depth_valid).any())
        use_icp = p.icp_map is not None
        run = self._optimize_fn(
            int(p.rel_valid.shape[0]), iters, pose_only, use_depth, use_icp
        )
        with timing.Timer("3.2 SolveDevice"):
            p_opt, cost = run(p, self.cams, gps_bufs)
            cost = float(cost)
        with timing.Timer("3.3 Readback"):
            self._writeback(p_opt, fid2slot)
        return float(cost)

    def optimise_gated_dispatch(self, fid: int, gate_px: float,
                                iterations: Optional[int] = None,
                                iterations2: int = 2) -> dict:
        """Build + dispatch the gated window solve WITHOUT waiting for the
        result; returns a handle for `optimise_gated_collect`.

        The pipeline collects one frame later, overlapping the solve's
        device execution with the next frame's detection + association —
        the counterpart of the reference's backend optimisation
        thread running concurrently with the frontend
        (okvis_multisensor_processing/src/ThreadedSlam.cpp:945-960).
        Between dispatch and collect the host may only APPEND frames /
        landmarks / observations (association does exactly that); removal
        or reordering waits until after collect."""
        from okvis2x_tpu.utils import timing

        iters = iterations or self._rt_iters
        if self.frames:
            self._check_gps_dropout(self.frames[-1].timestamp)
        with timing.Timer("3.1 BuildProblem"):
            p, fid2slot, gps_bufs, obs_src = self._build_problem()
        use_depth = bool(np.asarray(p.obs_depth_valid).any())
        use_icp = p.icp_map is not None
        run = self._optimize_fn(
            int(p.rel_valid.shape[0]), iters, False, use_depth, use_icp,
            gated=True, gate_iters2=iterations2,
        )
        gate_slot = np.int32(fid2slot.get(fid, -1))
        with timing.Timer("3.2 SolveDevice"):
            _p_opt, packed_d = run(
                p, self.cams, gps_bufs, gate_slot,
                np.asarray(gate_px, np.float32),
            )
        # NOTE: the full optimised problem (_p_opt) is intentionally NOT
        # kept in the handle — everything host-consumed rides `packed`,
        # and holding ~50 device buffers per in-flight solve doubles HBM
        # traffic for nothing
        return dict(
            packed=packed_d, fid2slot=fid2slot,
            obs_src=obs_src, nl=len(self.lm_ids), fid=fid,
            lm_lids=np.array(self.lm_ids, np.int64),
        )

    def optimise_gated_collect(self, h: dict):
        """Fetch + write back a dispatched gated solve: poses/speed-bias
        for the snapshot frames, landmarks for the snapshot rows, and
        removal of the chi2-flagged observations.  Accepts a pre-fetched
        numpy result in h["packed_np"] (background prefetch thread);
        otherwise fetches h["packed"] itself.  Returns
        (cost, n_outliers)."""
        from okvis2x_tpu.utils import timing

        with timing.Timer("3.3 Readback"):
            # ONE device->host transfer (unless prefetched off-thread)
            packed = h.get("packed_np")
            if packed is None:
                packed = np.asarray(h["packed"])
            K = self.cfg.cap_frames
            L = self.cfg.cap_landmarks
            o = 0
            T = packed[o:o + K * 7].reshape(K, 7); o += K * 7
            sb = packed[o:o + K * 9].reshape(K, 9); o += K * 9
            hp = packed[o:o + L * 4].reshape(L, 4); o += L * 4
            nw = self.cfg.cap_obs // 16
            words = packed[o:o + nw].astype(np.int64); o += nw
            out_mask = (
                (words[:, None] >> np.arange(16)) & 1
            ).reshape(-1).astype(bool)
            T_SC = packed[o:o + self.C * 7].reshape(self.C, 7); o += self.C * 7
            T_GW = packed[o:o + 7]
            cost = float(packed[-1])
            live = {f.fid for f in self.frames}
            for f, slot in h["fid2slot"].items():
                if f not in live:
                    continue
                fr = self._frame_by_id(f)
                fr.T_WS = self._clamp_held(fr, T[slot].astype(np.float64))
                fr.sb = sb[slot].astype(np.float64)
            # landmark writeback BY ID: rows map through the dispatch-time
            # lid snapshot, so landmarks pruned/compacted between dispatch
            # and collect (pipeline depth >= 2 runs marginalisation in
            # that window) land in the right rows — or nowhere
            snap = h["lm_lids"]
            if len(snap):
                tgt = np.array(
                    [self.lm_index.get(l, -1) for l in snap], np.int64
                )
                ok = tgt >= 0
                if not self.hp_W.flags.writeable:
                    self.hp_W = self.hp_W.copy()
                self.hp_W[tgt[ok]] = hp[:len(snap)][ok].astype(np.float64)
            if self.cfg.do_extrinsics:
                self.T_SC = T_SC.astype(np.float64)
            if self.gps_status == "Initialised":
                self.T_GW = T_GW.astype(np.float64)
            out_rows = np.nonzero(out_mask)[0]
        obs_src, obs_uids = h["obs_src"]
        n_out = len(out_rows)
        if n_out:
            # outlier removal BY UID (indices shift under concurrent
            # marginalisation; uids never do)
            bad_uids = obs_uids[out_rows[out_rows < len(obs_uids)]]
            keep = ~np.isin(self.obs_uid, bad_uids)
            self.obs_fid = self.obs_fid[keep]
            self.obs_cam = self.obs_cam[keep]
            self.obs_lid = self.obs_lid[keep]
            self.obs_uv = self.obs_uv[keep]
            self.obs_sigma = self.obs_sigma[keep]
            self.obs_depth = self.obs_depth[keep]
            self.obs_depth_sigma = self.obs_depth_sigma[keep]
            self.obs_uid = self.obs_uid[keep]
        return float(cost), n_out

    def adapt_realtime_budget(self, solve_wall_s: float) -> bool:
        """Feed one measured realtime-solve wall time into the budget
        controller (≙ CeresIterationCallback's time limit,
        okvis_ceres/include/okvis/ceres/CeresIterationCallback.hpp:80,
        okvis2.yaml realtime_time_limit): when the EMA overruns the
        budget, step the next solves down an iteration bucket
        (max -> midpoint -> min); step back up on sustained slack.
        Returns True when this sample overran the budget."""
        cfg = self.cfg
        limit = cfg.realtime_time_limit
        if not limit:
            return False
        self._rt_ema = 0.7 * self._rt_ema + 0.3 * solve_wall_s
        over = solve_wall_s > limit
        if over:
            self.n_budget_overruns += 1
        buckets = sorted({
            cfg.min_iterations,
            (cfg.min_iterations + cfg.max_iterations) // 2,
            cfg.max_iterations,
        })
        i = min(
            range(len(buckets)), key=lambda k: abs(buckets[k] - self._rt_iters)
        )
        if self._rt_ema > limit and i > 0:
            self._rt_iters = buckets[i - 1]
        elif self._rt_ema < 0.5 * limit and i < len(buckets) - 1:
            self._rt_iters = buckets[i + 1]
        return over

    def optimise_gated(self, fid: int, gate_px: float,
                       iterations: Optional[int] = None,
                       iterations2: int = 2):
        """Window solve + in-program chi2 outlier gate on frame `fid` +
        short re-solve, all in ONE device execution; flagged observations
        are removed from the host tables afterwards.  Returns
        (cost, n_outliers).  Replaces the optimise → reject_outliers →
        optimise(2) sequence, which paid three device round trips per
        frame (≙ the realtime optimisation loop's interleaved
        removeOutliers, Frontend.cpp:2398)."""
        h = self.optimise_gated_dispatch(fid, gate_px, iterations,
                                         iterations2)
        return self.optimise_gated_collect(h)

    # -------------------------------------------------------- marginalisation
    def covisibilities(self, fid: int) -> Dict[int, int]:
        """Count shared landmarks with every other frame (reference
        ViGraph::computeCovisibilities)."""
        mask = self.obs_fid == fid
        lms = set(self.obs_lid[mask].tolist())
        out: Dict[int, int] = {}
        for f in self.frames:
            if f.fid == fid:
                continue
            m2 = self.obs_fid == f.fid
            out[f.fid] = len(lms & set(self.obs_lid[m2].tolist()))
        return out

    def _drop_frame(self, fid: int, drop_obs: bool = True):
        idx = next(i for i, f in enumerate(self.frames) if f.fid == fid)
        self.frames.pop(idx)
        if drop_obs:
            keep = self.obs_fid != fid
            self.obs_fid = self.obs_fid[keep]
            self.obs_cam = self.obs_cam[keep]
            self.obs_lid = self.obs_lid[keep]
            self.obs_uv = self.obs_uv[keep]
            self.obs_sigma = self.obs_sigma[keep]
            self.obs_depth = self.obs_depth[keep]
            self.obs_depth_sigma = self.obs_depth_sigma[keep]
        self.obs_uid = self.obs_uid[keep]

    def _prune_landmarks(self):
        """Remove landmarks with no remaining observations (their final
        positions are snapshotted for the final BA)."""
        seen = set(self.obs_lid.tolist())
        keep_rows = []
        for i, lid in enumerate(self.lm_ids):
            if lid in seen:
                keep_rows.append(i)
            else:
                self.arch_lm[lid] = self.hp_W[i].copy()
        self.lm_ids = [self.lm_ids[i] for i in keep_rows]
        self.hp_W = self.hp_W[keep_rows]
        self.lm_quality = self.lm_quality[keep_rows]
        self.lm_index = {lid: i for i, lid in enumerate(self.lm_ids)}

    def marginalise(self):
        """Apply the window policy (reference applyStrategy,
        ViSlamBackend.cpp:555):
          1. drop surplus old non-keyframes (IMU-chain merge: links are
             rebuilt over the merged span at the next optimisation);
          2. convert surplus keyframes into frozen pose-graph frames with a
             two-pose edge (≙ convertToPoseGraphMst + freezePosesUntil);
          3. drop the oldest pose-graph frames beyond frame capacity;
          4. prune landmarks without observations.
        """
        cfg = self.cfg
        # 1. eliminate surplus non-keyframes among the old frames
        while True:
            old = self.frames[: -cfg.num_imu_frames] if cfg.num_imu_frames else self.frames
            candidates = [
                f for f in old if not f.is_keyframe and not f.pose_graph_frame
            ]
            if not candidates:
                break
            # IMU-chain merge BEFORE the frame leaves the chain
            # (≙ eliminateImuFrames, ViSlamBackend.cpp:511)
            self._merge_chain_link(candidates[0].fid)
            self._drop_frame(candidates[0].fid)

        # 2. convert surplus keyframes to pose-graph frames.  Victim =
        # the keyframe LEAST covisible with the newest keyframe (FIFO
        # keeps redundant views and evicts still-covisible frames in
        # slow-motion segments); the newest surplus keyframe itself is
        # never picked (≙ applyStrategy's minimum-covisibility selection,
        # ViSlamBackend.cpp:555-809 via computeCovisibilities)
        while True:
            kfs = [
                f
                for f in self.frames[: -cfg.num_imu_frames]
                if f.is_keyframe and not f.pose_graph_frame
            ]
            if len(kfs) <= cfg.num_keyframes:
                break
            ref_fid = kfs[-1].fid
            fids = [f.fid for f in kfs]
            cov = self._covis_matrix(fids)
            ref_i = len(fids) - 1
            # exclude the reference keyframe itself from victim choice
            scores = cov[:ref_i, ref_i]
            victim = kfs[int(np.argmin(scores))] if len(scores) else kfs[0]
            self._marginalise_keyframe(victim)

        # 3. cap total frames: archive oldest pose-graph frames (they stay
        # in the long-term pose graph for loop closure / final BA)
        while len(self.frames) > cfg.cap_frames - 1:
            pg = [
                f for f in self.frames
                if f.pose_graph_frame and f.fid not in self.lc_protected
            ]
            if not pg:
                # only protected loop-closure frames left: release the
                # oldest rather than overflow the fixed capacities
                pg = [f for f in self.frames if f.pose_graph_frame]
                if not pg:
                    break
                self.lc_protected.discard(pg[0].fid)
            victim = pg[0]
            if victim.expanded:
                # loop-closure/expanded frame: its live observations return
                # to the archive rather than being dropped
                gone = self.obs_fid == victim.fid
                self._archive_obs(gone)
                victim.expanded = False
                victim.pose_fixed = True
            self.archive_frames[victim.fid] = victim
            self._drop_frame(victim.fid)
            keep = []
            for e in self.rel_edges:
                if e["i"] == victim.fid or e["j"] == victim.fid:
                    self.archive_edges.append(e)
                else:
                    keep.append(e)
            self.rel_edges = keep

        self._prune_landmarks()
        self._prune_imu_links()
        self._trim_imu_buffer()

    def _covis_matrix(self, fids):
        """(n, n) covisibility counts among `fids` over the live
        observations — one vectorised pass instead of per-frame Python
        set intersections (≙ ViGraph::computeCovisibilities)."""
        n = len(fids)
        idx = {f: i for i, f in enumerate(fids)}
        sel = np.isin(self.obs_fid, list(fids))
        if not sel.any():
            return np.zeros((n, n))
        fi = np.array([idx[int(f)] for f in self.obs_fid[sel]])
        pairs = np.unique(
            np.stack([fi, self.obs_lid[sel]], axis=1), axis=0
        )
        _, lm_inv = np.unique(pairs[:, 1], return_inverse=True)
        M = np.zeros((n, lm_inv.max() + 1), np.float32)
        M[pairs[:, 0], lm_inv] = 1.0
        return M @ M.T

    def _two_pose_edge_fn(self, B: int, ncap: int, lcap: int):
        """Batched TwoPoseGraphError program: B edges in ONE execution
        with a single packed (B, 44) f32 output [T_ab | sqrt_info |
        strength] instead of one dispatch and sync per edge."""
        key = ("tpe", B, ncap, lcap)
        if key not in self._jit_cache:
            from okvis2x_tpu.graph.marginalization import two_pose_edge

            def one(Ta, Tb, T_SC, hp, lmm, op, oc, ol, uv, si, om):
                T_ab, W, strength = two_pose_edge(
                    self.cams, Ta, Tb, T_SC, hp, lmm, op, oc, ol, uv, si,
                    om,
                )
                f32 = jnp.float32
                return jnp.concatenate([
                    T_ab.astype(f32), W.reshape(36).astype(f32),
                    strength.reshape(1).astype(f32),
                ])

            self._jit_cache[key] = jax.jit(jax.vmap(
                one,
                in_axes=(0, 0, None, 0, 0, 0, 0, 0, 0, 0, 0),
            ))
        return self._jit_cache[key]

    def _compute_two_pose_edges(self, victim: FrameState, targets):
        """TwoPoseGraphError-style edges victim->target for up to B
        targets in ONE batched device execution
        (graph/marginalization.py).  Returns a list of edge dicts."""
        job = self._dispatch_two_pose_edges(victim, targets)
        if job is None:
            return []
        return self._collect_two_pose_edges(job)

    def _dispatch_two_pose_edges(self, victim: FrameState, targets):
        """Stage + dispatch the batched two-pose-edge program WITHOUT
        waiting (the deferred pipeline fetches the result with the next
        frame's prefetch batch instead of a synced round trip on the
        frame path).  Returns a job dict or None."""
        cfg = self.cfg
        dtype = cfg.dtype
        # fixed capacities: one compiled program regardless of window
        # content (surplus co-observations are subsampled — they carry
        # diminishing information for a single 6-dof edge)
        B = 3
        ncap = 512
        lcap = 128
        targets = list(targets)[:B]
        if not targets:
            return None
        va = self.obs_fid == victim.fid
        Tb_rows = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (B, 1))
        hp_rows = np.tile(np.array([0, 0, 0, 1.0]), (B, lcap, 1))
        lmm_rows = np.zeros((B, lcap), bool)
        op_rows = np.zeros((B, ncap), np.int32)
        oc_rows = np.zeros((B, ncap), np.int32)
        ol_rows = np.zeros((B, ncap), np.int32)
        uv_rows = np.zeros((B, ncap, 2))
        si_rows = np.ones((B, ncap))
        om_rows = np.zeros((B, ncap), bool)
        row_targets = []
        for r, target in enumerate(targets):
            vb = self.obs_fid == target.fid
            shared = set(self.obs_lid[va]) & set(self.obs_lid[vb])
            shared = [l for l in shared if l in self.lm_index]
            if not shared:
                row_targets.append(None)
                continue
            if len(shared) > lcap:
                shared = shared[:lcap]
            lrow = {l: i for i, l in enumerate(shared)}
            sel = np.nonzero(
                (va | vb) & np.isin(self.obs_lid, list(shared))
            )[0]
            if len(sel) > ncap:
                sel = sel[:: len(sel) // ncap + 1][:ncap]
            n = len(sel)
            Tb_rows[r] = target.T_WS
            hp_rows[r, : len(shared)] = self.hp_W[
                [self.lm_index[l] for l in shared]
            ]
            lmm_rows[r, : len(shared)] = True
            op_rows[r, :n] = (self.obs_fid[sel] == target.fid).astype(
                np.int32
            )
            oc_rows[r, :n] = self.obs_cam[sel]
            ol_rows[r, :n] = [lrow[l] for l in self.obs_lid[sel]]
            uv_rows[r, :n] = self.obs_uv[sel]
            si_rows[r, :n] = 1.0 / self.obs_sigma[sel]
            om_rows[r, :n] = True
            row_targets.append(target)
        if all(t is None for t in row_targets):
            return None

        run = self._two_pose_edge_fn(B, ncap, lcap)
        npdt = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
        cvt = lambda x: np.asarray(x, npdt)
        Ta_rows = np.tile(victim.T_WS, (B, 1))
        out_d = run(
            cvt(Ta_rows), cvt(Tb_rows), cvt(self.T_SC),
            cvt(hp_rows), lmm_rows,
            op_rows, oc_rows, ol_rows,
            cvt(uv_rows), cvt(si_rows), om_rows,
        )
        return dict(
            victim_fid=victim.fid,
            target_fids=[t.fid if t is not None else None
                         for t in row_targets],
            out=out_d,
        )

    def _collect_two_pose_edges(self, job: dict, out_np=None):
        """Parse a dispatched two-pose-edge job into edge dicts."""
        out = np.asarray(job["out"]) if out_np is None else out_np
        edges = []
        for r, target_fid in enumerate(job["target_fids"]):
            if target_fid is None:
                continue
            strength = float(out[r, 43])
            if not np.isfinite(strength) or strength < 1e-3:
                continue
            edges.append(dict(
                i=job["victim_fid"], j=target_fid,
                T_ij=out[r, :7].astype(np.float64),
                sqrt_info=out[r, 7:43].reshape(6, 6).astype(np.float64),
                # marginalisation summary: dropped when its observations
                # are re-expanded (final BA / full-graph BA) to avoid
                # double counting
                marg=True,
            ))
        return edges

    def apply_pending_edges(self, job: dict, out_np: np.ndarray) -> int:
        """Fold a deferred two-pose-edge result into the graph (deferred
        pipeline: fetched with the NEXT frame's prefetch batch).  Edges
        whose endpoints were archived in the meantime go straight to the
        archive edge store."""
        edges = self._collect_two_pose_edges(job, out_np)
        live = {f.fid for f in self.frames}
        n = 0
        for e in edges:
            if e["i"] in live and e["j"] in live:
                self.rel_edges.append(e)
            else:
                self.archive_edges.append(e)
            n += 1
        return n

    def _marginalise_keyframe(self, victim: FrameState):
        """Summarise the keyframe into relative-pose edges selected by a
        maximum spanning tree over the covisibility graph
        (≙ convertToPoseGraphMst creating TwoPoseGraphError edges along MST
        edges, ViGraphEstimator.cpp:334 + buildMst :935) and drop it.

        The MST spans {victim ∪ surviving keyframes} with covisibility
        counts as weights; every MST edge incident to the victim becomes a
        two-pose edge, which preserves graph rigidity when the victim
        co-observes landmarks with several keyframes (the single-best-edge
        shortcut under-constrains wide-covisibility windows)."""
        from okvis2x_tpu.graph.posegraph import max_spanning_tree

        kfs = [
            f
            for f in self.frames
            if f.is_keyframe and not f.pose_graph_frame and f.fid != victim.fid
        ]
        nodes = [victim] + kfs
        fids = [f.fid for f in nodes]
        C = self._covis_matrix(fids)
        cov_edges = []
        for ai in range(len(nodes)):
            for bi in range(ai + 1, len(nodes)):
                n = C[ai, bi]
                if n >= 3:
                    cov_edges.append((fids[ai], fids[bi], float(n)))
        mst = max_spanning_tree(cov_edges)
        targets = [
            j if i == victim.fid else i
            for (i, j, _) in mst
            if victim.fid in (i, j)
        ]
        by_fid = {f.fid: f for f in kfs}
        edge_targets = [by_fid[t] for t in targets[:3]]
        if not edge_targets and len(nodes) > 1:
            # no MST edge touches the victim: fall back to the single
            # most covisible keyframe
            bi = int(np.argmax(C[0, 1:])) + 1
            if C[0, bi] >= 3:
                edge_targets = [nodes[bi]]
        if self.defer_edge_jobs:
            # deferred pipeline: dispatch only — the result rides the next
            # frame's prefetch batch (apply_pending_edges); the in-between
            # solve runs without this one edge for a single iteration
            job = self._dispatch_two_pose_edges(victim, edge_targets)
            if job is not None:
                self.pending_edge_jobs.append(job)
        else:
            # bounded fan-out per marginalised frame, ONE batched call
            edges = self._compute_two_pose_edges(victim, edge_targets)
            if not edges and len(nodes) > 1:
                # MST edges all too weak: retry vs the most covisible
                bi = int(np.argmax(C[0, 1:])) + 1
                if C[0, bi] >= 3:
                    edges = self._compute_two_pose_edges(
                        victim, [nodes[bi]]
                    )
            self.rel_edges.extend(edges)
        # keep the frame as a frozen pose-graph anchor; its observations
        # are summarised in the edge, so they leave the active problem —
        # but are archived for the final BA re-expansion.  The IMU chain
        # merges across it first (its kinematic info moves into the edge).
        self._merge_chain_link(victim.fid)
        victim.pose_graph_frame = True
        gone = self.obs_fid == victim.fid
        self._archive_obs(gone)
        keep = ~gone
        self.obs_fid = self.obs_fid[keep]
        self.obs_cam = self.obs_cam[keep]
        self.obs_lid = self.obs_lid[keep]
        self.obs_uv = self.obs_uv[keep]
        self.obs_sigma = self.obs_sigma[keep]
        self.obs_depth = self.obs_depth[keep]
        self.obs_depth_sigma = self.obs_depth_sigma[keep]
        self.obs_uid = self.obs_uid[keep]

    # -- archived-observation views (backed by the growable stores) --------
    @property
    def arch_obs_fid(self):
        return self._arch_obs_i[:self._arch_obs_n, 0]

    @property
    def arch_obs_cam(self):
        return self._arch_obs_i[:self._arch_obs_n, 1]

    @property
    def arch_obs_lid(self):
        return self._arch_obs_i[:self._arch_obs_n, 2]

    @property
    def arch_obs_uv(self):
        return self._arch_obs_f[:self._arch_obs_n, 0:2]

    @property
    def arch_obs_sigma(self):
        return self._arch_obs_f[:self._arch_obs_n, 2]

    @property
    def arch_obs_depth(self):
        return self._arch_obs_f[:self._arch_obs_n, 3]

    @property
    def arch_obs_depth_sigma(self):
        return self._arch_obs_f[:self._arch_obs_n, 4]

    def _archive_obs(self, mask: np.ndarray):
        k = int(mask.sum())
        if k == 0:
            return
        need = self._arch_obs_n + k
        if need > len(self._arch_obs_i):
            cap = max(need, 2 * len(self._arch_obs_i))
            bi = np.zeros((cap, 3), np.int64)
            bf = np.zeros((cap, 5))
            bi[: self._arch_obs_n] = self._arch_obs_i[: self._arch_obs_n]
            bf[: self._arch_obs_n] = self._arch_obs_f[: self._arch_obs_n]
            self._arch_obs_i, self._arch_obs_f = bi, bf
        sl = slice(self._arch_obs_n, need)
        self._arch_obs_i[sl, 0] = self.obs_fid[mask]
        self._arch_obs_i[sl, 1] = self.obs_cam[mask]
        self._arch_obs_i[sl, 2] = self.obs_lid[mask]
        self._arch_obs_f[sl, 0:2] = self.obs_uv[mask]
        self._arch_obs_f[sl, 2] = self.obs_sigma[mask]
        self._arch_obs_f[sl, 3] = self.obs_depth[mask]
        self._arch_obs_f[sl, 4] = self.obs_depth_sigma[mask]
        self._arch_obs_n = need

    def archive_observation(
        self, fid: int, cam: int, lid: int, uv, sigma: float = 1.0,
        depth: float = 0.0, depth_sigma: float = 0.0,
    ):
        """Append one row to the archived-observation store directly (map
        import / tests; the runtime path archives in bulk via
        `_archive_obs`)."""
        if self._arch_obs_n == len(self._arch_obs_i):
            cap = 2 * len(self._arch_obs_i)
            bi = np.zeros((cap, 3), np.int64)
            bf = np.zeros((cap, 5))
            bi[: self._arch_obs_n] = self._arch_obs_i[: self._arch_obs_n]
            bf[: self._arch_obs_n] = self._arch_obs_f[: self._arch_obs_n]
            self._arch_obs_i, self._arch_obs_f = bi, bf
        n = self._arch_obs_n
        self._arch_obs_i[n] = (fid, cam, lid)
        self._arch_obs_f[n, 0:2] = uv
        self._arch_obs_f[n, 2:5] = (sigma, depth, depth_sigma)
        self._arch_obs_n = n + 1

    def _arch_obs_compact(self, keep: np.ndarray):
        """Drop archived observation rows where ``keep`` is False."""
        n = self._arch_obs_n
        k = int(keep.sum())
        self._arch_obs_i[:k] = self._arch_obs_i[:n][keep]
        self._arch_obs_f[:k] = self._arch_obs_f[:n][keep]
        self._arch_obs_n = k

    # ----------------------------------------------------- loop closure
    def pose_graph(self):
        """All known keyframe poses (archived + windowed) and relative
        edges, time-ordered — the long-term pose graph."""
        nodes: List[FrameState] = sorted(
            list(self.archive_frames.values())
            + [f for f in self.frames if f.is_keyframe or f.pose_graph_frame],
            key=lambda f: f.timestamp,
        )
        edges = list(self.archive_edges) + list(self.rel_edges)
        return nodes, edges

    def add_loop_edge(
        self,
        fid_cur: int,
        fid_cand: int,
        T_cand_cur: np.ndarray,
        sqrt_info: np.ndarray,
    ) -> bool:
        """Persist an accepted loop-closure constraint as a long-term
        pose-graph edge (≙ ViSlamBackend::addLoopClosureFrame's pose-graph
        part, okvis_ceres/src/ViSlamBackend.cpp:1418)."""
        known = {f.fid for f in self.frames} | set(self.archive_frames)
        if fid_cur not in known or fid_cand not in known:
            return False
        self.archive_edges.append(
            dict(
                i=fid_cand, j=fid_cur,
                T_ij=np.asarray(T_cand_cur, np.float64),
                sqrt_info=np.asarray(sqrt_info, np.float64),
                loop=True,
            )
        )
        return True

    # ---------------- runtime re-expansion (≙ expandKeyframe/mergeLandmark)
    def _restore_landmark(self, lid: int) -> bool:
        """Bring an archived landmark back into the live store (refused at
        capacity — the caller simply restores fewer observations)."""
        if lid in self.lm_index:
            return True
        if len(self.lm_ids) >= self.cfg.cap_landmarks:
            return False
        hp = self.arch_lm.pop(lid, None)
        if hp is None:
            return False
        self.lm_index[lid] = len(self.lm_ids)
        self.lm_ids.append(lid)
        self.hp_W = np.vstack([self.hp_W, np.asarray(hp)[None]])
        self.lm_quality = np.append(self.lm_quality, 0.5)
        return True

    def expand_keyframe(self, fid: int, max_restore: int | None = None) -> int:
        """Convert a window pose-graph frame's summarised information back
        into live observations (≙ ViSlamBackend::expandKeyframe,
        ViSlamBackend.cpp:461 → ViGraphEstimator::convertToObservations,
        ViGraphEstimator.cpp:818): restore its archived observations and
        landmarks, drop the marginalisation two-pose edges that summarised
        them, and let the pose optimise again.  Returns #observations
        restored."""
        f = self._frame_by_id(fid)
        take = np.nonzero(self.arch_obs_fid == fid)[0]
        # never restore past the observation capacity (keep headroom for
        # the next frame's fresh associations)
        headroom = (self.cfg.cap_obs - len(self.obs_fid)
                    - min(1024, self.cfg.cap_obs // 4))
        max_restore = min(
            max_restore if max_restore is not None else len(take),
            max(headroom, 0),
        )
        if len(take) > max_restore:
            # capacity budget: prefer observations of landmarks that are
            # already live (they couple the expanded frame to the window)
            live_first = sorted(
                take.tolist(),
                key=lambda i: int(self.arch_obs_lid[i]) not in self.lm_index,
            )
            take = np.asarray(live_first[:max_restore])
        keep_idx = [
            int(i) for i in take
            if self._restore_landmark(int(self.arch_obs_lid[i]))
        ]
        if keep_idx:
            ki = np.asarray(keep_idx)
            self.obs_fid = np.append(self.obs_fid, self.arch_obs_fid[ki])
            self.obs_cam = np.append(self.obs_cam, self.arch_obs_cam[ki])
            self.obs_lid = np.append(self.obs_lid, self.arch_obs_lid[ki])
            self.obs_uv = np.vstack([self.obs_uv, self.arch_obs_uv[ki]])
            self.obs_sigma = np.append(
                self.obs_sigma, self.arch_obs_sigma[ki]
            )
            self.obs_depth = np.append(
                self.obs_depth, self.arch_obs_depth[ki]
            )
            self.obs_depth_sigma = np.append(
                self.obs_depth_sigma, self.arch_obs_depth_sigma[ki]
            )
            self.obs_uid = np.append(
                self.obs_uid,
                np.arange(self._obs_uid_next, self._obs_uid_next + len(ki)),
            )
            self._obs_uid_next += len(ki)
        if len(take):
            inv = np.ones(len(self.arch_obs_fid), bool)
            inv[take] = False
            self._arch_obs_compact(inv)
        # the summarising two-pose edges double-count now — drop them
        drop = lambda e: e.get("marg") and fid in (e["i"], e["j"])
        self.rel_edges = [e for e in self.rel_edges if not drop(e)]
        self.archive_edges = [e for e in self.archive_edges if not drop(e)]
        if f.pose_graph_frame:
            f.expanded = True
            f.pose_fixed = False
        return len(keep_idx)

    def add_loopclosure_frame(self, fid: int,
                              max_restore: int | None = None) -> bool:
        """Bring an archived keyframe back into the realtime window as an
        expanded pose-graph frame so its landmarks can be re-observed and
        merged (≙ ViSlamBackend::addLoopClosureFrame, ViSlamBackend.cpp:1418;
        window budget okvis2.yaml numLoopClosureFrames)."""
        if any(f.fid == fid for f in self.frames):
            self.expand_keyframe(fid, max_restore)
            return True
        f = self.archive_frames.pop(fid, None)
        if f is None:
            return False
        f.pre_hold_T = f.T_WS.copy()
        # capacity headroom: the frame joins a window that may already sit
        # at cap (marginalise only trims at frame boundaries) — archive
        # the oldest unprotected pose-graph frame first, refuse if none
        while len(self.frames) >= self.cfg.cap_frames - 1:
            pg = [
                fr for fr in self.frames
                if fr.pose_graph_frame and fr.fid not in self.lc_protected
            ]
            if not pg:
                self.archive_frames[fid] = f
                return False
            victim = pg[0]
            if victim.expanded:
                gone = self.obs_fid == victim.fid
                self._archive_obs(gone)
                victim.expanded = False
                victim.pose_fixed = True
            self.archive_frames[victim.fid] = victim
            self._drop_frame(victim.fid)
            keep_e = []
            for e in self.rel_edges:
                if victim.fid in (e["i"], e["j"]):
                    self.archive_edges.append(e)
                else:
                    keep_e.append(e)
            self.rel_edges = keep_e
        f.pose_graph_frame = True
        f.pose_fixed = False
        self.frames.append(f)
        self.frames.sort(key=lambda fr: fr.timestamp)
        self.lc_protected.add(fid)
        self.expand_keyframe(fid, max_restore)
        return True

    def remove_loopclosure_frame(self, fid: int) -> bool:
        """Re-archive a loop-closure frame: observations return to the
        archive and the frame leaves the window (the summarising edges were
        dropped at expansion; the long-term pose graph keeps its loop and
        covisibility edges)."""
        try:
            f = self._frame_by_id(fid)
        except StopIteration:
            return False
        gone = self.obs_fid == fid
        self._archive_obs(gone)
        keep = ~gone
        self.obs_fid = self.obs_fid[keep]
        self.obs_cam = self.obs_cam[keep]
        self.obs_lid = self.obs_lid[keep]
        self.obs_uv = self.obs_uv[keep]
        self.obs_sigma = self.obs_sigma[keep]
        self.obs_depth = self.obs_depth[keep]
        self.obs_depth_sigma = self.obs_depth_sigma[keep]
        self.obs_uid = self.obs_uid[keep]
        f.expanded = False
        f.pose_fixed = True
        if f.pre_hold_T is not None:
            moved = float(np.linalg.norm(f.T_WS[:3] - f.pre_hold_T[:3]))
            if moved > 8.0:
                # the held frame scattered inside the window (see the
                # damping-prior comment in the assembly): re-archiving the
                # garbage pose would poison every later pose-graph
                # snapshot through high-confidence odometry fill-ins —
                # restore the pre-hold estimate instead (legitimate
                # corrections are drift-budget-bounded, metres at most)
                logging.warning(
                    "loop-closure frame %d re-archived with pre-hold pose:"
                    " window moved it %.1f m", fid, moved)
                f.T_WS = f.pre_hold_T.copy()
            f.pre_hold_T = None
        self.frames.remove(f)
        self.archive_frames[fid] = f
        self.lc_protected.discard(fid)
        self._prune_landmarks()
        return True

    def merge_landmarks(self, lid_keep: int, lid_drop: int) -> bool:
        """Merge two landmarks recognised as the same physical point after
        a loop closure (≙ ViGraphEstimator::mergeLandmark driven by
        attemptLoopClosure, ViSlamBackend.cpp:2361-2556): all live and
        archived observations of `lid_drop` re-point to `lid_keep`."""
        if lid_keep == lid_drop:
            return False
        if lid_keep not in self.lm_index:
            if not self._restore_landmark(lid_keep):
                return False
        self.obs_lid = np.where(
            self.obs_lid == lid_drop, lid_keep, self.obs_lid
        )
        alid = self.arch_obs_lid  # writable view into the backing store
        alid[alid == lid_drop] = lid_keep
        if lid_drop in self.lm_index:
            row = self.lm_index.pop(lid_drop)
            self.lm_ids.pop(row)
            self.hp_W = np.delete(self.hp_W, row, 0)
            self.lm_quality = np.delete(self.lm_quality, row)
            self.lm_index = {lid: i for i, lid in enumerate(self.lm_ids)}
        self.arch_lm.pop(lid_drop, None)
        return True

    def snapshot_pose_graph(self) -> Optional[dict]:
        """Immutable snapshot of the long-term pose graph (all keyframe
        poses + relative/loop edges, with odometry fill-in between
        consecutive nodes lacking any edge).  This is the explicit-handoff
        equivalent of the reference's second `fullGraph_`
        (ViSlamBackend.hpp:724-743): the background optimiser works on the
        snapshot while the realtime window keeps evolving; states created
        after the snapshot form the backlog replayed by
        `apply_pose_graph_result`."""
        nodes, edges = self.pose_graph()
        if len(nodes) < 2:
            return None
        fids = [f.fid for f in nodes]
        idx = {fid: i for i, fid in enumerate(fids)}

        connected = {(min(e["i"], e["j"]), max(e["i"], e["j"])) for e in edges}
        all_edges = [
            e for e in edges if e["i"] in idx and e["j"] in idx
        ]
        for a, b in zip(nodes[:-1], nodes[1:]):
            if (a.fid < 0) != (b.fid < 0):
                continue  # never glue a loaded component to the session
            key = (min(a.fid, b.fid), max(a.fid, b.fid))
            if key not in connected:
                T_ij = se3np.se3_multiply(
                    se3np.se3_inverse(a.T_WS), b.T_WS
                )
                # implausibly long consecutive steps (a corrupted node
                # pose) must not become high-confidence odometry
                w = 50.0 if np.linalg.norm(T_ij[:3]) < 10.0 else 1.0
                all_edges.append(
                    dict(i=a.fid, j=b.fid, T_ij=T_ij, sqrt_info=np.eye(6) * w)
                )

        K = len(nodes)
        T = np.stack([f.T_WS for f in nodes])
        fixed = np.array([f.pose_fixed for f in nodes], bool)
        fixed[0] = True
        return dict(
            fids=fids,
            epoch=self.correction_epoch,
            T=T,
            fixed=fixed,
            ei=np.array([idx[e["i"]] for e in all_edges], np.int64),
            ej=np.array([idx[e["j"]] for e in all_edges], np.int64),
            eT=np.stack([e["T_ij"] for e in all_edges]),
            eS=np.stack([e["sqrt_info"] for e in all_edges]),
        )

    def apply_pose_graph_result(
        self, fids: List[int], T_opt: np.ndarray, backlog: bool = True
    ) -> bool:
        """Write an optimised pose-graph solution back and replay the
        backlog: snapshot nodes still known get their optimised poses;
        every state created (or kept active) since the snapshot is rigidly
        corrected by the anchor's pose change, velocities rotated and
        landmarks transformed along (≙ synchroniseRealtimeAndFullGraph,
        okvis_ceres/src/ViSlamBackend.cpp:1589-1870).

        `backlog=False` writes node poses only — REQUIRED for partial
        (segmented final-BA) snapshots that do not cover the newest
        history: a held loop-closure frame is a live window member with an
        OLD fid, so an early segment would otherwise anchor on it and
        rigidly drag the whole live window + landmark table by a
        mid-history correction (measured: final ATE 1.66 m vs 0.05 m
        run-to-run depending on whether LC frames were still held)."""
        T_opt = np.asarray(T_opt)
        if not np.all(np.isfinite(T_opt)):
            return False
        idx = {fid: i for i, fid in enumerate(fids)}

        # anchor = newest live window frame that was part of the snapshot;
        # its *current* realtime pose defines the correction for the backlog
        anchor = None
        if backlog:
            for f in reversed(self.frames):
                if f.fid in idx:
                    anchor = f
                    break
        dT = None
        if anchor is not None:
            dT = se3np.se3_multiply(
                T_opt[idx[anchor.fid]], se3np.se3_inverse(anchor.T_WS)
            )
            dt_mag = float(np.linalg.norm(dT[:3]))
            if dt_mag > 8.0:
                # drift-budget gate (≙ the reference gating loop-closure
                # corrections by expected drift, ViSlamBackend.cpp:2361):
                # a legitimate correction on a hundreds-of-metres session
                # is metres at most; a tens-of-metres rigid delta means
                # the anchor's epochs diverged (e.g. a stale background
                # result racing surgery) — applying it teleports the
                # whole estimate (observed: a 57 m z-jump on the 185 s
                # circuit).  Reject the application; the next background
                # solve re-dispatches from consistent state.
                logging.warning(
                    "pose-graph sync rejected: rigid backlog delta "
                    "%.1f m (anchor fid %d)", dt_mag, anchor.fid)
                return False
            if dt_mag > 1.0:
                logging.warning(
                    "pose-graph sync: large rigid backlog delta %.2f m "
                    "(anchor fid %d)", dt_mag, anchor.fid)

        # write back optimised poses to every snapshot node still known
        window = {f.fid: f for f in self.frames}
        T_old_nodes = np.zeros_like(np.asarray(T_opt))
        node_known = np.zeros(len(fids), bool)
        for k, fid in enumerate(fids):
            f = self.archive_frames.get(fid) or window.get(fid)
            if f is not None:
                T_old_nodes[k] = f.T_WS
                node_known[k] = True
        # max-node-movement gate (the anchor gate above only sees the
        # NEWEST node): a solve can keep the anchor put while scattering
        # distant history — a diverged/folded solution (measured: a
        # cost-accepted 533 m fold on the 185 s circuit before pose-graph
        # edges were robustified).  Legitimate corrections are bounded by
        # the drift budget (1.35 %/distance), metres at most.
        if node_known.any():
            node_move = np.linalg.norm(
                np.asarray(T_opt)[node_known, :3]
                - T_old_nodes[node_known, :3], axis=1
            ).max()
            if node_move > 8.0:
                logging.warning(
                    "pose-graph result rejected: max node movement %.1f m",
                    node_move)
                return False
        for k, (fid, Tn) in enumerate(zip(fids, T_opt)):
            f = self.archive_frames.get(fid) or window.get(fid)
            if f is not None:
                f.T_WS = np.asarray(Tn).copy()
                if f.pre_hold_T is not None:
                    f.pre_hold_T = np.asarray(Tn).copy()
        # archived landmark snapshots move WITH their host keyframes
        # (≙ synchroniseRealtimeAndFullGraph transforming each landmark by
        # its host frame's correction, ViSlamBackend.cpp:1589-1870).
        # Leaving them at pre-correction positions poisons everything that
        # reads arch_lm after a loop correction: expand_keyframe restores
        # metres-off points into the live window, and the segmented final
        # BA initialises every archived landmark metres from the corrected
        # geometry so the robust kernel downweights the very observations
        # that should refine it.
        self._correct_archived_landmarks(
            idx, node_known, T_old_nodes, np.asarray(T_opt), dT
        )
        # any in-flight background snapshot is now stale
        self.correction_epoch += 1

        if dT is None:
            return True
        dR = se3np.quat_to_matrix(dT[3:7])
        for f in self.frames:
            if f.fid in idx or f.pose_graph_frame:
                continue
            f.T_WS = se3np.se3_multiply(dT, f.T_WS)
            f.sb = np.concatenate([dR @ f.sb[0:3], f.sb[3:9]])
        if len(self.hp_W):
            self.hp_W = se3np.se3_apply_homogeneous(dT, self.hp_W)
        return True

    def _correct_archived_landmarks(self, idx, node_known, T_old, T_new,
                                    dT):
        """Transform each archived landmark by its HOST keyframe's pose
        change (host = newest archived observer; ≙ the reference moving
        landmarks with their host frames in synchroniseRealtimeAndFullGraph).
        Landmarks whose host is not a snapshot node fall back to the rigid
        backlog delta `dT` (they belong to the newest, yet-unsnapshotted
        history, which is exactly what dT re-anchors)."""
        n = self._arch_obs_n
        if not self.arch_lm or (n == 0 and dT is None):
            return
        host_of = {}
        if n:
            lid_rev = self._arch_obs_i[:n, 2][::-1]
            fid_rev = self._arch_obs_i[:n, 0][::-1]
            u, first = np.unique(lid_rev, return_index=True)
            host_of = dict(zip(u.tolist(), fid_rev[first].tolist()))
        items = list(self.arch_lm.items())
        hp = np.stack([p for _, p in items])
        deltas = np.zeros((len(items), 7))
        deltas[:, 6] = 1.0
        have = np.zeros(len(items), bool)
        node_dT = se3np.se3_multiply(T_new, se3np.se3_inverse(T_old))
        for k, (lid, _) in enumerate(items):
            g = idx.get(host_of.get(lid))
            if g is not None and node_known[g]:
                deltas[k] = node_dT[g]
                have[k] = True
            elif dT is not None:
                deltas[k] = dT
                have[k] = True
        if not have.any():
            return
        hp2 = se3np.se3_apply_homogeneous(deltas, hp)
        for k, (lid, _) in enumerate(items):
            if have[k]:
                self.arch_lm[lid] = hp2[k]

    def rigid_transform(self, dT: np.ndarray, session_only: bool = True):
        """Rigidly move the estimate by dT (left-multiplied world-frame
        correction): poses, velocities, landmarks.  With `session_only`,
        loaded-component frames (fid < 0) stay put — used to align the
        running session onto a loaded map at first relocalisation."""
        dT_n = np.asarray(dT, np.float64)
        dR = se3np.quat_to_matrix(dT_n[3:7])
        for f in list(self.frames) + list(self.archive_frames.values()):
            if session_only and f.fid < 0:
                continue
            f.T_WS = se3np.se3_multiply(dT_n, f.T_WS)
            if f.pre_hold_T is not None:
                f.pre_hold_T = se3np.se3_multiply(dT_n, f.pre_hold_T)
            f.sb = np.concatenate([dR @ f.sb[0:3], f.sb[3:9]])
        if len(self.hp_W):
            self.hp_W = se3np.se3_apply_homogeneous(dT_n, self.hp_W)
        for lid in list(self.arch_lm.keys()):
            self.arch_lm[lid] = se3np.se3_apply_homogeneous(
                dT_n, self.arch_lm[lid]
            )
        if self.prior_T is not None:
            self.prior_T = se3np.se3_multiply(dT_n, self.prior_T)
        # any in-flight background snapshot is now stale
        self.correction_epoch += 1

    def import_component_frames(
        self, frame_fids, frame_ts, frame_T_WS, edges, fixed: bool = True
    ) -> Dict[int, int]:
        """Add a loaded session's keyframes + pose-graph edges as (fixed)
        archive nodes with negative frame ids (≙ Frontend::loadComponent
        keeping components separate from the live graph,
        okvis_frontend/src/Frontend.cpp:163-201).  Returns the old→new fid
        map.  Component timestamps are shifted to strictly precede any
        session state so time-ordering stays consistent."""
        existing_neg = [f for f in self.archive_frames if f < 0]
        base = (min(existing_neg) if existing_neg else 0) - 1
        fid_map = {
            int(old): base - k for k, old in enumerate(frame_fids)
        }
        ts = np.asarray(frame_ts, np.float64)
        session_t0 = min(
            [f.timestamp for f in self.frames]
            + [f.timestamp for f in self.archive_frames.values()]
            + [0.0]
        )
        shift = session_t0 - float(ts.max()) - 1e6
        for old, t, T in zip(frame_fids, ts, frame_T_WS):
            self.archive_frames[fid_map[int(old)]] = FrameState(
                fid=fid_map[int(old)],
                timestamp=float(t) + shift,
                T_WS=np.asarray(T, np.float64).copy(),
                sb=np.zeros(9),
                is_keyframe=True,
                pose_fixed=fixed,
                pose_graph_frame=True,
            )
        for e in edges:
            self.archive_edges.append(
                dict(
                    i=fid_map[int(e["i"])], j=fid_map[int(e["j"])],
                    T_ij=np.asarray(e["T_ij"], np.float64),
                    sqrt_info=np.asarray(e["sqrt_info"], np.float64),
                )
            )
        return fid_map

    def close_loop(
        self,
        fid_cur: int,
        fid_cand: int,
        T_cand_cur: np.ndarray,
        sqrt_info: np.ndarray,
        iterations: int = 10,
    ) -> bool:
        """Accepted loop closure, synchronous path: persist the loop edge,
        optimise the full pose graph in-line, and write the result back
        (≙ ViSlamBackend::addLoopClosureFrame + optimiseFullGraph +
        synchroniseRealtimeAndFullGraph collapsed into one call; the
        background-thread equivalent is okvis2x_tpu.graph.fullgraph).
        """
        from okvis2x_tpu.graph import posegraph

        if not self.add_loop_edge(fid_cur, fid_cand, T_cand_cur, sqrt_info):
            return False
        snap = self.snapshot_pose_graph()
        if snap is None:
            self.archive_edges.pop()
            return False
        T_opt, cost = posegraph.optimize_pose_graph(
            snap["T"], snap["fixed"], snap["ei"], snap["ej"], snap["eT"],
            snap["eS"], iterations=iterations, dtype=self.cfg.dtype,
        )
        if not np.all(np.isfinite(np.asarray(T_opt))):
            self.archive_edges.pop()
            return False
        return self.apply_pose_graph_result(snap["fids"], T_opt)

    # --------------------------------------------------------------- final BA
    def _full_problem(self, use_imu: bool, node_slice=None,
                      fix_margin: int = 0, pin_caps=None):
        """Assemble the complete-history BA problem: archived + live
        observations re-expanded, marginalisation two-pose edges dropped
        (their information returns as the raw observations), loop/alignment
        edges kept, and — with `use_imu` — IMU links RE-PROPAGATED from the
        archived raw measurements at the frames' current bias estimates
        (≙ doFinalBa with ImuError::redoPropagationAlways=true,
        ViSlamBackend.cpp:2036; the previous odometry-glue approximation
        kept the online linearisation's errors exactly where the final BA
        should remove them).

        `node_slice=(i0, i1)` restricts the problem to that contiguous
        node range (the segmented final BA's unit of work), with the first
        and last `fix_margin` in-range nodes pose-fixed as boundary
        anchors.

        Returns (BAProblem, aux dict) or None; shared by `final_ba` and the
        background full-graph optimiser (graph/fullgraph.py).
        """
        nodes, edges = self.pose_graph()
        if node_slice is not None:
            nodes = nodes[node_slice[0]:node_slice[1]]
        if len(nodes) < 2:
            return None
        # marginalisation summaries out (observations below carry the info)
        edges = [e for e in edges if not e.get("marg")]
        fid2slot = {f.fid: i for i, f in enumerate(nodes)}
        nf = len(nodes)

        # observations: archived + live, restricted to pose-graph nodes
        obs_fid = np.append(self.arch_obs_fid, self.obs_fid)
        obs_cam = np.append(self.arch_obs_cam, self.obs_cam)
        obs_lid = np.append(self.arch_obs_lid, self.obs_lid)
        obs_uv = np.vstack([self.arch_obs_uv, self.obs_uv])
        obs_sigma = np.append(self.arch_obs_sigma, self.obs_sigma)
        live = np.array([f in fid2slot for f in obs_fid], bool)
        obs_fid, obs_cam, obs_lid = obs_fid[live], obs_cam[live], obs_lid[live]
        obs_uv, obs_sigma = obs_uv[live], obs_sigma[live]

        # landmarks: live + archived snapshots, keep those with >= 2 obs
        lids, counts = np.unique(obs_lid, return_counts=True)
        lids = lids[counts >= 2]
        lid2row = {}
        hps = []
        for lid in lids:
            if lid in self.lm_index:
                hp = self.hp_W[self.lm_index[lid]]
            elif lid in self.arch_lm:
                hp = self.arch_lm[lid]
            else:
                continue
            lid2row[lid] = len(hps)
            hps.append(hp)
        nl = len(hps)
        ok = np.array([l in lid2row for l in obs_lid], bool)
        obs_fid, obs_cam, obs_lid = obs_fid[ok], obs_cam[ok], obs_lid[ok]
        obs_uv, obs_sigma = obs_uv[ok], obs_sigma[ok]
        n_obs = len(obs_fid)
        if n_obs > 32768:
            # bound the compiled shape (the obs-row assembly is the
            # program's HBM high-water mark); uniform subsampling keeps
            # every frame represented
            logging.warning(
                "final BA: subsampling %d observations to 32768", n_obs)
            keep = np.linspace(0, n_obs - 1, 32768).astype(int)
            obs_fid, obs_cam, obs_lid = (
                obs_fid[keep], obs_cam[keep], obs_lid[keep])
            obs_uv, obs_sigma = obs_uv[keep], obs_sigma[keep]
            n_obs = len(obs_fid)
        if n_obs < 10 or nl < 5:
            return None

        # IMU links between consecutive session nodes where raw data covers
        # the span (re-propagated at current bias); odometry glue only for
        # the remainder (loaded components, gaps, over-long spans)
        imu_links = []  # (slot_a, slot_b, (t0, t1, bg, ba), n_samples)
        S_final = 0
        if use_imu:
            t_arr, gyr_arr, acc_arr = self._full_imu_arrays()
            for a, b in zip(nodes[:-1], nodes[1:]):
                if a.fid < 0 or b.fid < 0 or len(t_arr) == 0:
                    continue
                if t_arr[0] > a.timestamp or t_arr[-1] < b.timestamp:
                    continue  # span not covered by raw data
                i0 = max(int(np.searchsorted(t_arr, a.timestamp, "right")) - 1, 0)
                i1 = min(
                    int(np.searchsorted(t_arr, b.timestamp, "left")) + 1,
                    len(t_arr),
                )
                n_s = i1 - i0
                if n_s < 2 or n_s > 4096:
                    continue
                imu_links.append(
                    (
                        fid2slot[a.fid], fid2slot[b.fid],
                        (a.timestamp, b.timestamp, a.sb[3:6], a.sb[6:9]),
                        n_s,
                    )
                )
                S_final = max(S_final, n_s)

        imu_pairs = {(l[0], l[1]) for l in imu_links}
        # odometry glue between consecutive nodes lacking any edge/IMU link
        connected = {(min(e["i"], e["j"]), max(e["i"], e["j"])) for e in edges}
        all_edges = list(edges)
        for a, b in zip(nodes[:-1], nodes[1:]):
            if (a.fid < 0) != (b.fid < 0):
                continue  # never glue a loaded component to the session
            if (fid2slot[a.fid], fid2slot[b.fid]) in imu_pairs:
                continue
            key = (min(a.fid, b.fid), max(a.fid, b.fid))
            if key not in connected:
                T_ij = se3np.se3_multiply(
                    se3np.se3_inverse(a.T_WS), b.T_WS
                )
                all_edges.append(
                    dict(i=a.fid, j=b.fid, T_ij=T_ij, sqrt_info=np.eye(6) * 20.0)
                )
        all_edges = [
            e for e in all_edges if e["i"] in fid2slot and e["j"] in fid2slot
        ]

        def bucket(n, base=64):
            c = base
            while c < n:
                c *= 2
            return c

        # pin_caps=(K, L, N, R, M): ONE compiled program for every problem
        # whose content fits the pins (the background full-BA path pins at
        # its dispatch-threshold sizes, so a growing early-session history
        # does not recompile on every pow2 boundary mid-run); content
        # exceeding a pin falls back to the pow2 bucket for that dim.
        pK, pL, pN, pR, pM = pin_caps or (0, 0, 0, 0, 0)
        K = pK if nf <= pK else bucket(nf, 16)
        L = pL if nl <= pL else bucket(nl, 64)
        N = pN if n_obs <= pN else bucket(n_obs, 256)
        R = pR if len(all_edges) <= pR else bucket(len(all_edges), 16)
        M = (pM if imu_links and len(imu_links) <= pM else
             (bucket(len(imu_links), 8) if imu_links else 1))
        dtype = jax.dtypes.canonicalize_dtype(self.cfg.dtype)

        p = prb.empty_problem(K=K, L=L, C=self.C, N=N, M=M, R=R, dtype=dtype)
        T_WS = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        T_WS[:nf] = np.stack([f.T_WS for f in nodes])
        sb_full = np.zeros((K, 9))
        sb_full[:nf] = np.stack([f.sb for f in nodes])
        frame_valid = np.zeros(K, bool)
        frame_valid[:nf] = True
        pose_fixed = np.zeros(K, bool)
        pose_fixed[0] = True  # gauge
        if node_slice is not None and fix_margin:
            pose_fixed[:min(fix_margin, nf)] = True
            pose_fixed[max(nf - fix_margin, 0):nf] = True
        sb_fixed = np.ones(K, bool)
        # IMU-linked frames estimate speed/bias, softly anchored at the
        # current values (keeps unobserved bias directions bounded)
        sb_prior = np.zeros((K, 9))
        sb_prior_si = np.tile(np.eye(9), (K, 1, 1))
        sb_prior_valid = np.zeros(K, bool)
        for sa, sb_, _, _ in imu_links:
            for slot in (sa, sb_):
                sb_fixed[slot] = False
                sb_prior[slot] = sb_full[slot]
                sb_prior_si[slot] = np.diag(
                    np.concatenate(
                        [np.full(3, 1.0), np.full(3, 1.0 / 0.05),
                         np.full(3, 1.0 / 0.2)]
                    )
                )
                sb_prior_valid[slot] = True

        hp = np.tile(np.array([0, 0, 0, 1.0]), (L, 1))
        hp[:nl] = np.stack(hps)
        lm_valid = np.zeros(L, bool)
        lm_valid[:nl] = True

        o_frame = np.zeros(N, np.int32)
        o_cam = np.zeros(N, np.int32)
        o_lm = np.zeros(N, np.int32)
        o_uv = np.zeros((N, 2))
        o_si = np.ones(N)
        o_valid = np.zeros(N, bool)
        o_frame[:n_obs] = [fid2slot[f] for f in obs_fid]
        o_cam[:n_obs] = obs_cam
        o_lm[:n_obs] = [lid2row[l] for l in obs_lid]
        o_uv[:n_obs] = obs_uv
        o_si[:n_obs] = 1.0 / obs_sigma
        o_valid[:n_obs] = True

        r_i = np.zeros(R, np.int32)
        r_j = np.zeros(R, np.int32)
        r_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (R, 1))
        r_si = np.tile(np.eye(6), (R, 1, 1))
        r_valid = np.zeros(R, bool)
        for m, e in enumerate(all_edges):
            r_i[m] = fid2slot[e["i"]]
            r_j[m] = fid2slot[e["j"]]
            r_T[m] = e["T_ij"]
            r_si[m] = e["sqrt_info"]
            r_valid[m] = True

        # batched re-preintegration of every IMU link over archive + live
        imu_i = np.zeros(M, np.int32)
        imu_j = np.zeros(M, np.int32)
        imu_valid = np.zeros(M, bool)
        imu_pre = p.imu_pre
        imu_si = p.imu_sqrt_info
        if imu_links:
            spans = []
            for m, (sa, sb_, span, _) in enumerate(imu_links):
                imu_i[m] = sa
                imu_j[m] = sb_
                imu_valid[m] = True
                spans.append(span)
            # pinned runs jump straight to 1024 samples/span so the preint
            # program compiles once (keyframe gaps grow smoothly; an
            # unpinned S would recompile at every pow2 boundary)
            S_cap = 1024 if (pin_caps and S_final <= 1024) else 128
            while S_cap < S_final:
                S_cap *= 2
            imu_pre, imu_si = self._preintegrate_batch(
                spans, M, S=S_cap, imu_arrays=self._full_imu_arrays()
            )

        cvt = lambda x: jnp.asarray(x, dtype)
        p = p._replace(
            T_WS=cvt(T_WS), sb=cvt(sb_full),
            frame_valid=jnp.asarray(frame_valid),
            pose_fixed=jnp.asarray(pose_fixed), sb_fixed=jnp.asarray(sb_fixed),
            sb_prior=cvt(sb_prior), sb_prior_sqrt_info=cvt(sb_prior_si),
            sb_prior_valid=jnp.asarray(sb_prior_valid),
            imu_i=jnp.asarray(imu_i), imu_j=jnp.asarray(imu_j),
            imu_pre=imu_pre, imu_sqrt_info=imu_si,
            imu_valid=jnp.asarray(imu_valid),
            T_SC=cvt(self.T_SC),
            hp_W=cvt(hp), lm_valid=jnp.asarray(lm_valid),
            obs_frame=jnp.asarray(o_frame), obs_cam=jnp.asarray(o_cam),
            obs_lm=jnp.asarray(o_lm), obs_uv=cvt(o_uv),
            obs_sqrt_info=cvt(o_si), obs_valid=jnp.asarray(o_valid),
            rel_i=jnp.asarray(r_i), rel_j=jnp.asarray(r_j),
            rel_T=cvt(r_T), rel_sqrt_info=cvt(r_si),
            rel_valid=jnp.asarray(r_valid),
        )
        # optional extrinsics refinement in the final BA (≙ the reference's
        # do_extrinsics_final_ba with its own soft-constraint sigmas)
        do_ext = self.cfg.do_extrinsics_final_ba
        if do_ext:
            si_ext = np.diag(
                np.concatenate(
                    [
                        np.full(
                            3, 1.0 / max(self.cfg.extrinsics_sigma_r_final_ba, 1e-9)
                        ),
                        np.full(
                            3,
                            1.0 / max(self.cfg.extrinsics_sigma_alpha_final_ba, 1e-9),
                        ),
                    ]
                )
            )
            p = p._replace(
                ext_fixed=jnp.zeros((self.C,), bool),
                ext_prior_T=cvt(self.T_SC_prior),
                ext_prior_sqrt_info=cvt(np.tile(si_ext, (self.C, 1, 1))),
                ext_prior_valid=jnp.ones((self.C,), bool),
            )
        aux = dict(
            fid2slot=fid2slot, lid2row=lid2row, caps=(K, L, N, R, M),
            do_ext=do_ext, fids=[f.fid for f in nodes],
        )
        return p, aux

    def _full_ba_run_fn(self, aux, iterations: int):
        K, L, N, R, M = aux["caps"]
        do_ext = aux["do_ext"]
        key = ("final", K, L, N, R, M, iterations, do_ext)
        if key not in self._jit_cache:
            cfg_s = gn.SolverConfig(max_iterations=iterations,
                                    imu_params=self.cfg.imu,
                                    use_ext_priors=do_ext)
            self._jit_cache[key] = jax.jit(
                lambda pp, cams: gn.optimize(pp, cams, cfg_s)
            )
        return self._jit_cache[key]

    def apply_full_ba_result(self, aux, p_opt, backlog: bool = True) -> bool:
        """Write a full-BA solution back: optimised poses / speed-bias /
        landmarks for snapshot members; frames and landmarks created since
        the snapshot ride the rigid backlog correction (≙
        synchroniseRealtimeAndFullGraph, ViSlamBackend.cpp:1589-1870).
        Pass backlog=False for partial (segment) snapshots."""
        nf = len(aux["fids"])
        T_out = np.asarray(p_opt.T_WS)
        if not np.all(np.isfinite(T_out[:nf])):
            return False
        self.apply_pose_graph_result(aux["fids"], T_out[:nf],
                                     backlog=backlog)
        sb_out = np.asarray(p_opt.sb)
        window = {f.fid: f for f in self.frames}
        for fid, slot in aux["fid2slot"].items():
            fr = self.archive_frames.get(fid) or window.get(fid)
            if fr is not None and not np.asarray(
                p_opt.sb_fixed
            )[slot]:
                fr.sb = sb_out[slot].copy()
        hp_out = np.asarray(p_opt.hp_W)
        for lid, row in aux["lid2row"].items():
            if lid in self.lm_index:
                self.hp_W[self.lm_index[lid]] = hp_out[row]
            else:
                self.arch_lm[lid] = hp_out[row]
        if aux["do_ext"]:
            self.T_SC = np.asarray(p_opt.T_SC, np.float64)
        return True

    # pinned capacities for the BACKGROUND full BA (sized to the
    # dispatcher's full_ba_threshold of 64 nodes): one compiled program
    # serves the whole early-session growth instead of recompiling at
    # every pow2 content boundary mid-run
    FULL_BA_PIN = (64, 4096, 16384, 128, 64)

    def snapshot_full_ba(self, iterations: int = 15, pin: bool = True):
        """Snapshot the complete-history BA (observations + re-propagated
        IMU + kept edges) for the background full-graph optimiser: returns
        dict(problem, run, aux) — `run` is the jitted solver, safe to call
        from a worker thread (JAX dispatch is thread-safe), created here so
        the compile cache lives with the estimator."""
        out = self._full_problem(
            use_imu=True, pin_caps=self.FULL_BA_PIN if pin else None)
        if out is None:
            return None
        p, aux = out
        return dict(problem=p, run=self._full_ba_run_fn(aux, iterations),
                    aux=aux, cams=self.cams, epoch=self.correction_epoch)

    def final_ba(self, iterations: int = 15, redo_imu: bool = True,
                 max_nodes: int = 128, stage_cb=None) -> float:
        """Full-batch bundle adjustment over the whole history
        (≙ ViSlamBackend::doFinalBa, okvis_ceres/src/ViSlamBackend.cpp:2005):
        re-expand archived observations, unfreeze all keyframe poses and
        re-propagate IMU links from raw archived measurements
        (redoPropagationAlways=true, :2036), then jointly optimise every
        keyframe + speed/bias + landmark and write the result back.

        Beyond `max_nodes` keyframes the joint dense-Schur program outgrows
        a single device's memory (the reference leans on sparse Ceres
        here), so this path becomes GLOBAL pose graph + SEGMENTED exact BA:
        one full pose-graph optimisation distributes the loop-closure /
        odometry corrections over the whole trajectory, then overlapping
        `max_nodes`-node segments run the complete visual-inertial BA with
        pose-fixed boundary anchors, sweeping oldest to newest.  Every
        observation/IMU link is still optimised exactly once at full
        nonlinearity — only the long-range cross-segment coupling is
        carried by the pose graph instead of one joint factorisation."""
        nodes, _ = self.pose_graph()
        n_nodes = len(nodes)
        if n_nodes <= max_nodes:
            out = self._full_problem(use_imu=redo_imu)
            if out is None:
                return 0.0
            p, aux = out
            run = self._full_ba_run_fn(aux, iterations)
            p_opt, cost = run(p, self.cams)
            self.apply_full_ba_result(aux, p_opt)
            return float(cost)

        # Alternating sweeps: a global pose-graph solve distributes the
        # loop-closure corrections, then overlapping exact-BA segments
        # refine at full nonlinearity with boundary anchors.  One sweep
        # leaves whatever global shape error the pose graph had frozen
        # into the segment boundaries (measured: final ATE varies 0.03 ↔
        # 0.17 m run-to-run on the circuit); re-solving the pose graph
        # from the segment-refined odometry and re-anchoring converges the
        # boundary error out.  The alternation is run to a FIXPOINT (max
        # node movement of the pg stage < 1 cm, up to 3 sweeps) and ends
        # on a pose-graph polish: the segment stage refreshes the
        # odometry fill-in that the graph consumes, and the graph solve is
        # what distributes it globally (measured on the 185 s circuit:
        # stopping after the sweep-2 segments left final ATE at 0.183 m
        # while the pose-graph optimum of that very state was 0.102 m).
        cost = 0.0
        max_sweeps = 3

        def _pg_stage(tag: str) -> float:
            """Global pose-graph solve + writeback; returns the max node
            translation movement [m] (the sweep convergence signal).
            Above ~256 nodes the dense (6K)^2 normal equations blow past
            HBM (measured: 2500 nodes compiled to a 17 GB program) —
            switch to the edge-sharded matrix-free LM-PCG like the
            background optimiser does.  Dense only up to 256 nodes: the
            (6K)^2 f32 Cholesky is numerically unusable beyond that
            (measured: 547-node dense solve exploded the final ATE to
            1 km).  The PCG path closes long loops once cg_iterations
            scales with K (block-Jacobi propagates ~1 node/iteration)."""
            snap = self.snapshot_pose_graph()
            moved = 0.0
            if snap is not None:
                if snap["T"].shape[0] > 256:
                    from okvis2x_tpu.parallel import dist_posegraph

                    T_opt, _ = dist_posegraph.optimize_pose_graph_pcg(
                        snap["T"], snap["fixed"], snap["ei"], snap["ej"],
                        snap["eT"], snap["eS"], iterations=iterations,
                        dtype=self.cfg.dtype,
                    )
                else:
                    from okvis2x_tpu.graph import posegraph

                    T_opt, _ = posegraph.optimize_pose_graph(
                        snap["T"], snap["fixed"], snap["ei"], snap["ej"],
                        snap["eT"], snap["eS"], iterations=iterations,
                        dtype=self.cfg.dtype,
                    )
                T_opt = np.asarray(T_opt)
                if np.all(np.isfinite(T_opt)):
                    moved = float(np.max(np.linalg.norm(
                        T_opt[:, :3] - snap["T"][:, :3], axis=1
                    )))
                    self.apply_pose_graph_result(snap["fids"], T_opt)
            if stage_cb is not None:
                stage_cb(tag)
            return moved

        for sweep in range(max_sweeps):
            moved = _pg_stage(f"pg{sweep + 1}")
            if sweep > 0 and moved < 0.01:
                # fixpoint: the segment-refreshed odometry no longer moves
                # the graph — the final polish below already ran as this
                # sweep's pg stage
                return cost

            # 2. segmented exact BA, 25% overlap, margin-anchored
            step = max(max_nodes * 3 // 4, 1)
            margin = max(max_nodes // 16, 2)
            cost = 0.0
            i0 = 0
            while i0 < n_nodes:
                i1 = min(i0 + max_nodes, n_nodes)
                out = self._full_problem(
                    use_imu=redo_imu, node_slice=(i0, i1),
                    fix_margin=margin if i0 > 0 else 0,
                )
                if out is not None:
                    p, aux = out
                    run = self._full_ba_run_fn(aux, iterations)
                    p_opt, seg_cost = run(p, self.cams)
                    if np.isfinite(float(seg_cost)):
                        # only the FINAL segment (newest history, covering
                        # the live window) replays the backlog; earlier
                        # segments write node poses only — a mid-history
                        # segment rigidly re-anchoring the live window
                        # would corrupt it (see apply_pose_graph_result)
                        self.apply_full_ba_result(aux, p_opt,
                                                  backlog=i1 >= n_nodes)
                        cost += float(seg_cost)
                    else:
                        import logging

                        logging.warning(
                            "final BA: segment [%d,%d) sweep %d diverged "
                            "(cost %s); writeback skipped", i0, i1,
                            sweep + 1, seg_cost,
                        )
                    if stage_cb is not None:
                        stage_cb(f"seg{sweep + 1}[{i0}:{i1})")
                if i1 >= n_nodes:
                    break
                i0 += step
        # end on a pose-graph polish: the last segment sweep refreshed the
        # odometry fill-in; one more graph solve distributes it globally
        _pg_stage("pg_final")
        return cost

    # ------------------------------------------------------------- outputs
    def get_state(self, fid: Optional[int] = None) -> FrameState:
        return self.frames[-1] if fid is None else self._frame_by_id(fid)

    def trajectory(self):
        return {f.fid: (f.timestamp, f.T_WS.copy()) for f in self.frames}

    def full_trajectory(self):
        """Time-ordered (timestamp, T_WS) over archived + windowed frames."""
        frames = sorted(
            list(self.archive_frames.values()) + self.frames,
            key=lambda f: f.timestamp,
        )
        return (
            np.array([f.timestamp for f in frames]),
            np.stack([f.T_WS for f in frames]) if frames else np.zeros((0, 7)),
        )
