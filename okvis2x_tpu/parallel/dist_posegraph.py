"""Distributed pose-graph optimisation: edge-sharded, matrix-free LM-PCG.

The full-graph counterpart of parallel/dist_schur.py.  The reference
optimises its complete-history pose graph with sparse Ceres on 3 CPU
threads in a background thread (okvis_ceres/src/ViSlamBackend.cpp:1971
optimiseFullGraph; config/euroc/okvis2.yaml full_graph_num_threads) —
minutes-scale for long trajectories.  Dense normal equations grow as
(6K)^2, which stops scaling around a few hundred keyframes; this solver
never materialises them:

  * relative-pose edges are sharded along the 1-D device mesh; each device
    linearises its shard with the closed-form minimal Jacobians shared
    with the window solver (gauss_newton.rel_residual_jacobians);
  * Gauss-Newton steps solve (J^T J + lam I) dx = -J^T r by preconditioned
    conjugate gradients with matrix-free Hessian-vector products:
    edge gather -> 6x6 block multiplies -> segment-sum scatter, `psum`'d
    across the mesh — per-iteration cost O(E/D * 36) flops and one
    (K,6)-vector all-reduce;
  * block-Jacobi preconditioner: per-pose 6x6 Hessian diagonal blocks
    (psum'd once per outer iteration, batch-inverted);
  * Levenberg-Marquardt accept/reject on the exact quadratic edge cost
    (pose-graph edges carry their robustification already, baked in at
    marginalisation time — TwoPoseGraphError's Cauchy corrector).

Fixed poses (≙ ceres SetParameterBlockConstant / freezePosesUntil) are
handled by zeroing their Jacobian columns; with b = 0 on those coordinates
PCG never moves them.

Everything is fixed-iteration and static-shape: one compiled program per
(K, E, mesh) capacity bucket, no host round-trips inside the solve.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from okvis2x_tpu.core import se3
from okvis2x_tpu.parallel.mesh import OBS_AXIS
from okvis2x_tpu.solver.gauss_newton import rel_residual_jacobians


def _linearize(T, ei, ej, eT, eS, free):
    """Per-edge whitened residuals + Jacobians, columns of fixed poses
    zeroed.  Returns r (E,6), Ji, Jj (E,6,6)."""

    def one(i, j, Trel, si):
        r, Ji, Jj = rel_residual_jacobians(T[i], T[j], Trel, si)
        return r, Ji * free[i], Jj * free[j]

    return jax.vmap(one)(ei, ej, eT, eS)


def _residual_only(T, ei, ej, eT, eS):
    def one(i, j, Trel, si):
        r, _, _ = rel_residual_jacobians(T[i], T[j], Trel, si)
        return r

    return jax.vmap(one)(ei, ej, eT, eS)


def _pcg(hvp, b, Minv, n_iter: int):
    """Fixed-iteration preconditioned CG on H x = b, x0 = 0.

    b, x are (K, 6); Minv is the (K, 6, 6) block-Jacobi inverse.  Division
    guards make exhausted search directions a no-op instead of NaN (the
    fixed iteration count may exceed the Krylov dimension on tiny graphs).
    """
    dtype = b.dtype
    tiny = jnp.asarray(1e-30 if dtype == jnp.float64 else 1e-18, dtype)

    def precond(r):
        return jnp.einsum("kij,kj->ki", Minv, r)

    def body(_, carry):
        x, r, p, rz = carry
        Hp = hvp(p)
        pHp = jnp.sum(p * Hp)
        alpha = jnp.where(jnp.abs(pHp) > tiny, rz / jnp.where(jnp.abs(pHp) > tiny, pHp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(jnp.abs(rz) > tiny, rz_new / jnp.where(jnp.abs(rz) > tiny, rz, 1.0), 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x0 = jnp.zeros_like(b)
    z0 = precond(b)
    carry = (x0, b, z0, jnp.sum(b * z0))
    x, _, _, _ = jax.lax.fori_loop(0, n_iter, body, carry)
    return x


def _core(T, fixed, ei, ej, eT, eS, evalid, *, iterations, cg_iterations,
          init_lambda, lambda_up, lambda_down, loss_scale,
          axis: Optional[str]):
    """One LM pose-graph solve; edge arrays may be a local shard (axis set)
    or the full edge set (axis None).

    Edges are HUBER-robustified (IRLS, scale `loss_scale` in whitened
    units; ≙ the reference robustifying TwoPoseGraphError,
    okvis_ceres/src/TwoPoseGraphError.cpp:282-340): with an unbounded
    quadratic, one inconsistent high-information edge can make a folded
    configuration cheaper than the true shape — measured as a 408-node
    final pose graph walking to 533 m ATE through monotone cost-DEcreasing
    LM steps on the 185 s circuit."""
    from okvis2x_tpu.factors import robust

    dtype = T.dtype
    K = T.shape[0]
    allred = (lambda x: jax.lax.psum(x, axis)) if axis else (lambda x: x)
    free = (~fixed).astype(dtype)
    ev = evalid.astype(dtype)[:, None]
    eye6 = jnp.eye(6, dtype=dtype)

    def cost_of(Tc):
        r = _residual_only(Tc, ei, ej, eT, eS) * ev
        s = jnp.sum(r * r, axis=-1)
        return allred(0.5 * jnp.sum(robust.rho(robust.HUBER, s, loss_scale)))

    def step(Tc, lam, cost):
        r, Ji, Jj = _linearize(Tc, ei, ej, eT, eS, free)
        r = r * ev
        Ji = Ji * ev[..., None]
        Jj = Jj * ev[..., None]
        sw = jnp.sqrt(robust.weight(
            robust.HUBER, jnp.sum(r * r, axis=-1), loss_scale
        ))
        r = r * sw[:, None]
        Ji = Ji * sw[:, None, None]
        Jj = Jj * sw[:, None, None]
        # gradient: b = -J^T r scattered onto poses
        bi = jnp.einsum("eri,er->ei", Ji, r)
        bj = jnp.einsum("eri,er->ei", Jj, r)
        b = -(
            jax.ops.segment_sum(bi, ei, num_segments=K)
            + jax.ops.segment_sum(bj, ej, num_segments=K)
        )
        b = allred(b)
        # block-Jacobi diag: B_k = sum_e J^T J + lam I (fixed poses -> I)
        Bi = jnp.einsum("eri,erj->eij", Ji, Ji)
        Bj = jnp.einsum("eri,erj->eij", Jj, Jj)
        B = jax.ops.segment_sum(Bi, ei, num_segments=K) + jax.ops.segment_sum(
            Bj, ej, num_segments=K
        )
        B = allred(B)
        B = B + (lam + 1e-12) * eye6[None]
        B = jnp.where(fixed[:, None, None], eye6[None], B)
        Minv = jnp.linalg.inv(B)

        def hvp(v):
            u = jnp.einsum("eij,ej->ei", Ji, v[ei]) + jnp.einsum(
                "eij,ej->ei", Jj, v[ej]
            )
            y = jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Ji, u), ei, num_segments=K
            ) + jax.ops.segment_sum(
                jnp.einsum("eri,er->ei", Jj, u), ej, num_segments=K
            )
            return allred(y) + lam * v

        dx = _pcg(hvp, b, Minv, cg_iterations)
        T_cand = jax.vmap(se3.retract)(Tc, dx * free[:, None])
        new_cost = cost_of(T_cand)
        accept = new_cost < cost
        T_new = jnp.where(accept, T_cand, Tc)
        lam = jnp.where(accept, lam * lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-10, 1e8)
        return T_new, lam, jnp.minimum(new_cost, cost)

    lam = jnp.asarray(init_lambda, dtype)
    cost = cost_of(T)
    # unrolled outer loop: a handful of LM steps, each already a big program
    for _ in range(iterations):
        T, lam, cost = step(T, lam, cost)
    return T, cost


def optimize_pose_graph_pcg(
    T_WS: np.ndarray,  # (K, 7)
    fixed: np.ndarray,  # (K,) bool
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_T: np.ndarray,  # (E, 7)
    edges_sqrt_info: np.ndarray,  # (E, 6, 6)
    edges_valid: Optional[np.ndarray] = None,
    iterations: int = 10,
    cg_iterations: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    dtype=jnp.float64,
    init_lambda: float = 1e-6,
    lambda_up: float = 10.0,
    lambda_down: float = 0.3,
    loss_scale: float = 10.0,
) -> Tuple[np.ndarray, float]:
    """Scalable pose-graph GN/LM: returns optimised (K, 7) poses + cost.

    With `mesh` (1-D, axis "obs") the edge set is sharded across devices and
    the per-iteration reductions are all-reduces; without, the same
    matrix-free program runs on one device (still O(E) memory instead of O((6K)^2))."""
    dtype = jax.dtypes.canonicalize_dtype(dtype)
    E = len(edges_i)
    if edges_valid is None:
        edges_valid = np.ones(E, bool)
    ei = np.asarray(edges_i, np.int32)
    ej = np.asarray(edges_j, np.int32)
    eT = np.asarray(edges_T)
    eS = np.asarray(edges_sqrt_info)
    ev = np.asarray(edges_valid, bool)

    # pow2 capacity buckets so the background optimiser compiles ONE
    # program per bucket instead of one per keyframe count — on a
    # remote-compile backend an unbucketed K means a multi-second compile
    # on EVERY dispatch of a growing pose graph
    K0 = T_WS.shape[0]
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])

    def _bucket(n, base):
        c = base
        while c < n:
            c *= 2
        return c

    Kp = _bucket(K0, 64)
    if cg_iterations is None:
        # block-Jacobi PCG propagates a correction ~1 node per iteration
        # along a chain: long-range loop-closure corrections need O(K)
        # iterations or they underconverge (measured: 17x the dense
        # solver's residual error at K=154 with 64 iterations).  Tied to
        # the K bucket so the compiled-program count stays bounded.
        cg_iterations = max(128, Kp)
    if Kp > K0:
        T_WS = np.concatenate([np.asarray(T_WS), np.tile(id7, (Kp - K0, 1))])
        fixed = np.concatenate([np.asarray(fixed, bool),
                                np.ones(Kp - K0, bool)])
    Ep = _bucket(E, 256)
    if Ep > E:
        pe = Ep - E
        ei = np.concatenate([ei, np.zeros(pe, np.int32)])
        ej = np.concatenate([ej, np.zeros(pe, np.int32)])
        eT = np.concatenate([eT, np.tile(id7, (pe, 1))])
        eS = np.concatenate([eS, np.zeros((pe, 6, 6))])
        ev = np.concatenate([ev, np.zeros(pe, bool)])
        E = Ep

    if mesh is not None:
        D = mesh.devices.size
        pad = (-E) % D
        if pad:
            ei = np.concatenate([ei, np.zeros(pad, np.int32)])
            ej = np.concatenate([ej, np.zeros(pad, np.int32)])
            id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
            eT = np.concatenate([eT, np.tile(id7, (pad, 1))])
            eS = np.concatenate([eS, np.zeros((pad, 6, 6))])
            ev = np.concatenate([ev, np.zeros(pad, bool)])

    kw = dict(
        iterations=iterations,
        cg_iterations=cg_iterations,
        init_lambda=init_lambda,
        lambda_up=lambda_up,
        lambda_down=lambda_down,
        loss_scale=loss_scale,
    )
    args = (
        jnp.asarray(T_WS, dtype),
        jnp.asarray(fixed, bool),
        jnp.asarray(ei),
        jnp.asarray(ej),
        jnp.asarray(eT, dtype),
        jnp.asarray(eS, dtype),
        jnp.asarray(ev),
    )

    if mesh is None:
        run = _solver_fn(None, **kw)
        T_opt, cost = run(*args)
    else:
        espec = P(OBS_AXIS)
        in_specs = (P(), P(), espec, espec, espec, espec, espec)
        shardings = tuple(NamedSharding(mesh, s) for s in in_specs)
        args = tuple(jax.device_put(a, s) for a, s in zip(args, shardings))
        T_opt, cost = _solver_fn(mesh, **kw)(*args)
    return np.asarray(T_opt)[:K0], float(cost)


def _bucket_of(n: int, base: int) -> int:
    c = base
    while c < n:
        c *= 2
    return c


def precompile(n_nodes: int, n_edges: Optional[int] = None,
               iterations: int = 10, mesh: Optional[Mesh] = None,
               dtype=jnp.float64):
    """Force-compile (and execute once) the PCG pose-graph program for the
    capacity bucket that `n_nodes` keyframes will hit.  The background
    optimiser calls this AHEAD of need (when the live graph approaches a
    bucket boundary) so the bucket-crossing dispatch finds a warm program
    instead of compiling in front of the realtime queue."""
    K = _bucket_of(max(n_nodes, 2), 64)
    # default edge count ~ node count (odometry chain + a few loops): this
    # reproduces the Ep bucket a real dispatch of `n_nodes` keyframes hits
    E = n_edges if n_edges is not None else max(n_nodes, 2)
    id7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    T = np.tile(id7, (K, 1))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    ei = np.arange(E, dtype=np.int32) % max(K - 1, 1)
    ej = ei + 1
    optimize_pose_graph_pcg(
        T, fixed, ei, ej, np.tile(id7, (E, 1)),
        np.tile(np.eye(6), (E, 1, 1)), iterations=iterations, mesh=mesh,
        dtype=dtype,
    )


@functools.lru_cache(maxsize=64)
def _solver_fn(mesh, **kw):
    """Module-level program cache: ONE jitted function per
    (mesh, iterations, cg_iterations, lambda schedule) — argument shapes
    (the Kp/Ep capacity buckets) key jit's own cache underneath.  The
    background full-graph thread dispatches this on every loop closure; a
    fresh `jax.jit` wrapper per call would re-trace the unrolled
    LM-over-PCG loop (seconds of host work on 2 vCPUs) and push a
    recompile into the device queue mid-run, stalling the realtime path
    behind it."""
    if mesh is None:
        return jax.jit(functools.partial(_core, axis=None, **kw))
    espec = P(OBS_AXIS)
    in_specs = (P(), P(), espec, espec, espec, espec, espec)
    core = shard_map(
        functools.partial(_core, axis=OBS_AXIS, **kw),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(core)
