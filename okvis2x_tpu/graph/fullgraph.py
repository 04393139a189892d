"""Background full-graph optimisation (dual-graph architecture).

JAX equivalent of the reference's dual-graph design: `ViSlamBackend`
owns a realtime sliding-window graph and a complete-history `fullGraph_`
optimised in a background thread, coordinated through the atomics
`needsFullGraphOptimisation_` / `isLoopClosing_` / `isLoopClosureAvailable_`
and mutation backlogs that replay realtime changes into the full graph
after it finishes (okvis_ceres/include/okvis/ViSlamBackend.hpp:724-743,
src/ViSlamBackend.cpp:1589 synchroniseRealtimeAndFullGraph, :1971
optimiseFullGraph; thread spawn at
okvis_multisensor_processing/src/ThreadedSlam.cpp:949-960).

Redesign for JAX instead of shared-memory ceres problems:

* the full graph is not a second mutable object but an immutable
  **snapshot** (`SlidingWindowEstimator.snapshot_pose_graph`) — plain numpy
  arrays handed to a worker thread;
* the worker runs the jitted pose-graph Gauss-Newton program
  (okvis2x_tpu.graph.posegraph) — JAX dispatch is thread-safe, and the
  device executes it concurrently with the realtime window's programs;
* the realtime side never blocks: it polls `is_loop_closure_available` and
  calls `synchronise()`, which writes optimised poses back and replays the
  backlog (states created since the snapshot) as a rigid re-anchoring —
  exactly the role of the reference's addStatesBacklog_/touchedStates_
  replay, but with explicit data handoff instead of locked shared state.
"""

from __future__ import annotations

import threading
from typing import Optional

import jax.numpy as jnp
import numpy as np


class FullGraphOptimizer:
    """One in-flight background pose-graph optimisation at a time."""

    def __init__(self, iterations: int = 15, dtype=jnp.float64,
                 pcg_threshold: int = 256, mesh=None,
                 full_ba_threshold: int = 64):
        """`pcg_threshold`: above this many keyframes the dense (6K)^2
        normal-equation solve is replaced by the matrix-free edge-sharded
        PCG solver (parallel/dist_posegraph), optionally distributed over
        `mesh` — the scalability story the reference's sparse-Ceres
        background thread cannot reach.

        Below `full_ba_threshold` keyframes the background optimisation is
        the COMPLETE factor graph — re-expanded reprojection observations +
        re-propagated IMU links + kept loop/alignment edges — matching the
        reference's `fullGraph_` (ViSlamBackend.hpp:724-743, optimiseFullGraph
        :1971) instead of a pose-graph-only approximation; above it, the
        pose-graph PCG keeps the latency bounded.  The threshold is sized
        to the dense-row Schur program's HBM high-water mark (the
        (N,2,K,15) row assembly pads its minor dim to 128 lanes: K=128 /
        N=32768 peaks ~4 GB of the 16 GB chip)."""
        self.iterations = iterations
        self.dtype = dtype
        self.pcg_threshold = pcg_threshold
        self.full_ba_threshold = full_ba_threshold
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._snap: Optional[dict] = None
        self._result: Optional[np.ndarray] = None
        self._full_snap: Optional[dict] = None
        self._full_result = None
        self._cost: float = float("nan")
        self._lock = threading.Lock()
        self.n_dispatched = 0
        self.n_synchronised = 0
        self.n_full_ba = 0
        self.n_stale_discarded = 0

    # -- status (≙ the reference's three atomics) ------------------------
    @property
    def is_loop_closing(self) -> bool:
        """An optimisation is in flight (≙ isLoopClosing_)."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def is_loop_closure_available(self) -> bool:
        """A finished result awaits synchronise() (≙ isLoopClosureAvailable_)."""
        with self._lock:
            return (
                self._result is not None or self._full_result is not None
            ) and not self.is_loop_closing

    # -- lifecycle --------------------------------------------------------
    def dispatch(self, est) -> bool:
        """Snapshot the estimator's long-term pose graph and optimise it on
        a worker thread.  Returns False if busy, a result is pending, or
        the graph is too small (≙ needsFullGraphOptimisation_ gating)."""
        if self.is_loop_closing:
            return False
        with self._lock:
            if self._result is not None:
                return False
        # small/medium graphs: the complete factor graph in the background
        n_nodes = len(est.pose_graph()[0])
        if n_nodes <= self.full_ba_threshold:
            full = est.snapshot_full_ba(self.iterations)
            if full is not None:
                self._full_snap = full

                def work_full():
                    try:
                        p_opt, cost = full["run"](
                            full["problem"], full["cams"]
                        )
                        import jax

                        jax.block_until_ready(p_opt.T_WS)
                    except Exception:  # noqa: BLE001 — degrade, don't die
                        import logging

                        logging.exception(
                            "background full-graph BA failed; realtime "
                            "window continues uncorrected until the next "
                            "dispatch"
                        )
                        return
                    with self._lock:
                        self._full_result = p_opt
                        self._cost = float(cost)

                self._thread = threading.Thread(
                    target=work_full, name="full-graph-ba", daemon=True
                )
                self._thread.start()
                self.n_dispatched += 1
                return True

        snap = est.snapshot_pose_graph()
        if snap is None:
            return False
        self._snap = snap

        def work():
            try:
                K0 = snap["T"].shape[0]
                if K0 > self.pcg_threshold:
                    from okvis2x_tpu.parallel import dist_posegraph

                    T_opt, cost = dist_posegraph.optimize_pose_graph_pcg(
                        snap["T"], snap["fixed"], snap["ei"], snap["ej"],
                        snap["eT"], snap["eS"], iterations=self.iterations,
                        mesh=self.mesh, dtype=self.dtype,
                    )
                else:
                    from okvis2x_tpu.graph import posegraph

                    T_opt, cost = posegraph.optimize_pose_graph(
                        snap["T"], snap["fixed"], snap["ei"], snap["ej"],
                        snap["eT"], snap["eS"], iterations=self.iterations,
                        dtype=self.dtype,
                    )
                T_opt = np.asarray(T_opt)
            except Exception:  # noqa: BLE001 — degrade, don't die
                import logging

                logging.exception("background pose-graph solve failed")
                return
            with self._lock:
                self._result = T_opt
                self._cost = float(cost)
            # PREDICTIVE program warming: when the growing graph nears the
            # next capacity bucket (the PCG switchover, or a PCG pow2
            # boundary), compile that program NOW — on this idle worker,
            # while the result above already waits for synchronise() — so
            # the bucket-crossing dispatch never compiles in front of the
            # realtime queue
            try:
                from okvis2x_tpu.parallel import dist_posegraph

                if K0 > self.pcg_threshold:
                    Kp = dist_posegraph._bucket_of(K0, 64)
                    if K0 > 0.75 * Kp:
                        dist_posegraph.precompile(
                            Kp + 1, iterations=self.iterations,
                            mesh=self.mesh, dtype=self.dtype)
                elif K0 > 0.75 * self.pcg_threshold:
                    dist_posegraph.precompile(
                        self.pcg_threshold + 1, iterations=self.iterations,
                        mesh=self.mesh, dtype=self.dtype)
            except Exception:  # noqa: BLE001 — warming is best-effort
                pass

        self._thread = threading.Thread(
            target=work, name="full-graph-optimisation", daemon=True
        )
        self._thread.start()
        self.n_dispatched += 1
        return True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the in-flight optimisation (if any) to finish."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        return not self.is_loop_closing

    def synchronise(self, est) -> bool:
        """Apply a finished result to the estimator: optimised poses write
        back, the backlog (states added since the snapshot) is rigidly
        re-anchored, landmarks transformed
        (≙ synchroniseRealtimeAndFullGraph).  No-op unless a result is
        available."""
        with self._lock:
            if self.is_loop_closing:
                return False
            if self._full_result is not None:
                p_opt, full = self._full_result, self._full_snap
                self._full_result, self._full_snap = None, None
                if full.get("epoch") != est.correction_epoch:
                    self._log_stale(est, full.get("epoch"))
                    return False
                ok = est.apply_full_ba_result(full["aux"], p_opt)
                if ok:
                    self.n_synchronised += 1
                    self.n_full_ba += 1
                return ok
            if self._result is None:
                return False
            T_opt, snap = self._result, self._snap
            self._result, self._snap = None, None
        if snap.get("epoch") != est.correction_epoch:
            self._log_stale(est, snap.get("epoch"))
            return False
        ok = est.apply_pose_graph_result(snap["fids"], T_opt)
        if ok:
            self.n_synchronised += 1
        return ok

    def _log_stale(self, est, snap_epoch):
        """A correction (loop surgery, sync, re-alignment) landed between
        dispatch and result: the snapshot's frame is no longer the live
        frame, so applying it would re-anchor the window into the
        PRE-correction world (measured: a 6.75 m teleport on the 185 s
        circuit that marginalisation then baked into unfixable two-pose
        edges).  Discard; the next dispatch re-snapshots consistent
        state within a few frames."""
        import logging

        self.n_stale_discarded += 1
        logging.info(
            "full-graph result discarded: snapshot epoch %s != current "
            "%d (corrections applied while solving)", snap_epoch,
            est.correction_epoch,
        )
