"""Pose-graph utilities: MST edge selection + pose-graph optimisation.

Host-side graph structure (cheap, dynamic) + device solve:
  * `max_spanning_tree` — Kruskal maximum-spanning-tree over the
    covisibility graph, used to pick which two-pose edges to create during
    marginalisation (reference: okvis_util/include/okvis/MstGraph.hpp:91-121
    used by ViGraphEstimator::buildMst, okvis_ceres/src/
    ViGraphEstimator.cpp:935);
  * `optimize_pose_graph` — batched GN over relative-pose edges only, i.e. a
    BAProblem with no observations/IMU; used after loop closures
    (reference: the pose-graph stage of the full-graph optimisation).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from okvis2x_tpu.solver import gauss_newton as gn
from okvis2x_tpu.solver import problem as prb


class DisjointSet:
    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, x: int) -> int:
        while self.parent.setdefault(x, x) != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def max_spanning_tree(
    edges: Sequence[Tuple[int, int, float]]
) -> List[Tuple[int, int, float]]:
    """Kruskal MST maximising total weight; edges (i, j, weight)."""
    ds = DisjointSet()
    out = []
    for i, j, w in sorted(edges, key=lambda e: -e[2]):
        if ds.union(i, j):
            out.append((i, j, w))
    return out


def optimize_pose_graph(
    T_WS: np.ndarray,  # (K, 7) initial poses
    fixed: np.ndarray,  # (K,) bool
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_T: np.ndarray,  # (R, 7)
    edges_sqrt_info: np.ndarray,  # (R, 6, 6)
    iterations: int = 10,
    dtype=jnp.float64,
):
    """Pure pose-graph GN/LM: returns optimised (K, 7) poses."""
    import jax

    # resolve f64-request → best available (f32 on the GPU) once, silently
    dtype = jax.dtypes.canonicalize_dtype(dtype)
    K0 = T_WS.shape[0]
    R0 = len(edges_i)

    # TWO pinned capacity buckets (K=64 and K=256) serve every graph this
    # dense path accepts (callers switch to the matrix-free PCG solver
    # above 256 nodes): a growing pose graph crosses at most ONE bucket
    # boundary over a whole session, so at most one background compile can
    # land mid-run — and precompile() covers both up front.  The (6K)^2
    # dense solve at K=256 is still tiny for the device, so padding 70 nodes
    # to 256 costs microseconds, not a recompile.
    K = 64 if K0 <= 64 else 256 * ((K0 + 255) // 256)
    R = 2 * K if R0 <= 2 * K else 256 * ((R0 + 255) // 256)
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    T_full = np.concatenate([np.asarray(T_WS), np.tile(id7, (K - K0, 1))])
    fix_full = np.concatenate([np.asarray(fixed, bool), np.ones(K - K0, bool)])
    valid_full = np.zeros(K, bool)
    valid_full[:K0] = True
    ei = np.zeros(R, np.int32)
    ej = np.zeros(R, np.int32)
    eT = np.tile(id7, (R, 1))
    eS = np.zeros((R, 6, 6))
    rv = np.zeros(R, bool)
    ei[:R0] = edges_i
    ej[:R0] = edges_j
    eT[:R0] = edges_T
    eS[:R0] = edges_sqrt_info
    rv[:R0] = True
    p = _empty_template(K, R, dtype)
    p = p._replace(
        T_WS=jnp.asarray(T_full, dtype),
        frame_valid=jnp.asarray(valid_full),
        pose_fixed=jnp.asarray(fix_full),
        sb_fixed=jnp.ones(K, bool),
        rel_i=jnp.asarray(ei),
        rel_j=jnp.asarray(ej),
        rel_T=jnp.asarray(eT, dtype),
        rel_sqrt_info=jnp.asarray(eS, dtype),
        rel_valid=jnp.asarray(rv),
    )
    cams = _dummy_cams(dtype)
    run = _solver_fn(iterations)
    p_opt, cost = run(p, cams)
    return np.asarray(p_opt.T_WS)[:K0], float(cost)


@functools.lru_cache(maxsize=16)
def _empty_template(K: int, R: int, dtype):
    """Immutable per-bucket problem template: empty_problem materialises
    ~50 device arrays eagerly, each a separate dispatch RPC on the remote
    runtime — recreating them on every background dispatch put dozens of
    tiny executions in front of the realtime queue for nothing."""
    return prb.empty_problem(K=K, L=1, C=1, N=1, M=1, R=R, dtype=dtype)


@functools.lru_cache(maxsize=4)
def _dummy_cams(dtype):
    # dummy camera (no observations are valid)
    from okvis2x_tpu.cameras import pinhole

    cam = pinhole.make_pinhole(
        1.0, 1.0, 0.0, 0.0, 2, 2, model="none", dtype=dtype
    )
    return gn.stack_cameras([cam])


@functools.lru_cache(maxsize=64)
def _solver_fn(iterations: int):
    """ONE jitted program per (iterations, shape-bucket) — the background
    optimiser dispatches this from a worker thread every few keyframes, so
    a per-call `jax.jit` wrapper (empty trace cache) would re-trace the
    whole LM loop on every dispatch and stall the realtime device queue
    behind the compile."""
    import jax

    from okvis2x_tpu.factors import robust

    # HUBER on the edges: the pose graph mixes marginalisation odometry,
    # RANSAC loop constraints and synthesized fill-ins — one inconsistent
    # high-information edge must not be able to fold the whole graph
    # through cost-decreasing LM steps (see SolverConfig.rel_loss)
    cfg = gn.SolverConfig(max_iterations=iterations, estimate_landmarks=False,
                          rel_loss=robust.HUBER, rel_loss_scale=10.0)
    return jax.jit(lambda p, cams: gn.optimize(p, cams, cfg))


def precompile(iterations: int = 15, dtype=jnp.float64,
               buckets: Sequence[int] = (64, 256)):
    """Force-compile (and execute once) the dense pose-graph program for
    each pinned K bucket, so the first mid-run background dispatch finds a
    warm trace + executable instead of stalling the realtime device queue
    behind a compile."""
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    for K in buckets:
        T = np.tile(id7, (K, 1))
        fixed = np.zeros(K, bool)
        fixed[0] = True
        optimize_pose_graph(
            T, fixed, np.array([0]), np.array([1]), id7[None],
            np.eye(6)[None], iterations=iterations, dtype=dtype,
        )
