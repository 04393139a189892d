"""Asynchronous submapping runner (two worker threads + queues).

Orchestration parity with the reference's `SubmappingInterface` threading
(okvis_multisensor_processing/src/SubmappingInterface.cpp): sensor
callbacks push depth images / LiDAR sweeps into queues (`addDepthMeasurement`
:381 / `addLidarMeasurement` :351), the **assembly thread** replays the
estimator's optimised-graph callbacks into a client-side `Trajectory` and
waits until the trajectory covers a measurement's timestamp before
interpolating its pose (`integrationLoop` + `checkForAvailableData`
:489/:1028), and the **integration thread** consumes assembled work items:
submap lifecycle decisions, occupancy integration, re-anchoring on
loop-closure corrections (`processSupereightFrames` :710-963).

Redesign notes: the integration itself is the jitted ray/depth
batch program of `pipeline/submapping.py`; Python threads only overlap
host-side assembly and device dispatch, exactly like the reference's CPU
threads overlap data assembly with supereight integration.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from okvis2x_tpu import api
from okvis2x_tpu.pipeline.queues import Queue, ShutDown
from okvis2x_tpu.pipeline.submapping import SubmappingInterface


@dataclasses.dataclass
class _Measurement:
    t: float
    kind: str  # "depth" | "lidar"
    payload: dict


@dataclasses.dataclass
class _WorkItem:
    kf_fid: int
    T_WK: np.ndarray
    kind: str
    pose: np.ndarray  # T_WC (depth) or T_WS (lidar) at measurement time
    payload: dict


class AsyncSubmapping:
    """Queue-fed asynchronous wrapper around a SubmappingInterface."""

    def __init__(
        self,
        si: SubmappingInterface,
        cam=None,  # depth camera intrinsics
        T_SC: Optional[np.ndarray] = None,  # depth camera extrinsics (7,)
        T_SL: Optional[np.ndarray] = None,  # LiDAR extrinsics (7,)
        imu_params: api.ImuParams = api.ImuParams(),
        queue_size: int = 32,
    ):
        self.si = si
        self.cam = cam
        self.T_SC = np.asarray(
            T_SC if T_SC is not None else [0, 0, 0, 0, 0, 0, 1.0]
        )
        self.T_SL = np.asarray(
            T_SL if T_SL is not None else [0, 0, 0, 0, 0, 0, 1.0]
        )
        self.trajectory = api.Trajectory(imu_params)
        self._meas = Queue(maxsize=queue_size)
        self._work = Queue(maxsize=queue_size)
        self._state_event = threading.Event()
        self._kf: Optional[tuple] = None  # (fid, T_WK)
        self._lock = threading.Lock()
        self._done = False
        self.n_integrated = 0
        self.n_dropped = 0
        self._t_assembly = threading.Thread(
            target=self._assembly_loop, name="submap-assembly", daemon=True
        )
        self._t_integrate = threading.Thread(
            target=self._integration_loop, name="submap-integration",
            daemon=True,
        )
        self._t_assembly.start()
        self._t_integrate.start()

    # ----------------------------------------------------------- producers
    def add_depth_measurement(self, t: float, depth: np.ndarray, sigma=None):
        """(≙ SubmappingInterface::addDepthMeasurement)"""
        self._meas.push_blocking_if_full(
            _Measurement(t, "depth", dict(depth=depth, sigma=sigma))
        )

    def add_lidar_measurement(self, t: float, pts_L: np.ndarray):
        """(≙ SubmappingInterface::addLidarMeasurement) — points in the
        LiDAR frame, one (already deskewed) bundle per call."""
        self._meas.push_blocking_if_full(
            _Measurement(t, "lidar", dict(pts=pts_L))
        )

    def state_update_callback(
        self, state: api.State, updated_states: Optional[List[api.State]] = None
    ):
        """(≙ stateUpdateCallback -> stateUpdates_ queue): feed optimised
        states; loop-closure corrections arrive as `updated_states` and
        trigger submap re-anchoring."""
        with self._lock:
            self.trajectory.update(state)
            if state.is_keyframe:
                self._kf = (state.id, state.T_WS.copy())
            if updated_states:
                for s in updated_states:
                    self.trajectory.update(s)
                self.si.on_state_update(
                    {s.id: s.T_WS for s in updated_states}
                )
        self._state_event.set()

    # ------------------------------------------------------------- threads
    def _pose_at(self, t: float) -> Optional[np.ndarray]:
        with self._lock:
            st = self.trajectory.get_state(t)
            newest_ok = (
                self.trajectory.state_ids()
                and self.trajectory.get_state_by_id(
                    self.trajectory.state_ids()[-1]
                ).timestamp >= t
            )
        if st is None or not newest_ok:
            return None
        return st.T_WS

    def _assembly_loop(self):
        while True:
            try:
                m = self._meas.pop_blocking()
            except ShutDown:
                self._work.shutdown()
                return
            # wait until the trajectory reaches the measurement time
            # (≙ checkForAvailableData: newest state >= oldest measurement)
            while True:
                T_WS = self._pose_at(m.t)
                if T_WS is not None:
                    break
                if self._done:
                    T_WS = None
                    break
                self._state_event.clear()
                self._state_event.wait(timeout=0.5)
            with self._lock:
                kf = self._kf
            if T_WS is None or kf is None:
                self.n_dropped += 1
                continue
            from okvis2x_tpu.core import se3
            import jax.numpy as jnp

            ext = self.T_SC if m.kind == "depth" else self.T_SL
            pose = np.asarray(
                se3.se3_multiply(jnp.asarray(T_WS), jnp.asarray(ext))
            )
            self._work.push_blocking_if_full(
                _WorkItem(kf[0], kf[1], m.kind, pose, m.payload)
            )

    def _integration_loop(self):
        while True:
            try:
                w = self._work.pop_blocking()
            except ShutDown:
                return
            if w.kind == "depth":
                self.si.integrate_depth(
                    w.kf_fid, w.T_WK, w.pose, self.cam,
                    w.payload["depth"], w.payload.get("sigma"),
                )
            else:
                self.si.integrate_lidar(
                    w.kf_fid, w.T_WK, w.pose, w.payload["pts"]
                )
            self.n_integrated += 1

    # ------------------------------------------------------------ shutdown
    def finish(self, timeout: float = 30.0):
        """Drain both queues and stop the threads (≙ the app waiting for
        the integrator at dataset end)."""
        import time

        t0 = time.monotonic()
        while (len(self._meas) or len(self._work)) and (
            time.monotonic() - t0 < timeout
        ):
            self._state_event.set()
            time.sleep(0.01)
        self._done = True
        self._state_event.set()
        self._meas.shutdown()
        self._work.shutdown()
        self._t_assembly.join(timeout=5.0)
        self._t_integrate.join(timeout=5.0)
