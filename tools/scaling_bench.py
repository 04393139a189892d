#!/usr/bin/env python
"""Multi-device scaling harness at realistic problem shapes.

BASELINE.md asks for "scaling efficiency at 1 chip, 1 host, N hosts ...
for distributed BA".  Real multi-chip hardware is not reachable from this
container, so the harness measures the three distributed programs
(observation-sharded window BA, edge-sharded pose-graph PCG, ray-sharded
submap integration) on an N-virtual-device CPU mesh
(``--xla_force_host_platform_device_count``) at the shapes the realtime
system actually runs:

  * window BA:     K=8 frames, L=704 landmarks, N=8192 observations
                   (the slam_bench estimator capacity, EuRoC operating point)
  * pose graph:    512 keyframe nodes, odometry + 25% loop edges
                   (the backend's PCG regime, >256 kf)
  * submap rays:   4096 rays x 48 samples into a 2.5 cm brick pool

Weak scaling doubles the observation/ray load with the device count;
strong scaling holds it fixed.  On a CPU host the virtual devices share
physical cores, so *absolute* time is meaningless once n_devices exceeds
the core count — the value of the table is (a) the collective layout
compiles and executes at every device count, and (b) per-device work (the
sharded linearisation) shrinks proportionally, visible in the weak-scaling
column staying ~flat while total problem size grows.

Usage: python tools/scaling_bench.py [--devices 1 2 4 8] [--out SCALING.md]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_window_ba(mesh, n_obs, reps=3):
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.parallel.dist_schur import optimize_distributed
    from okvis2x_tpu.solver import gauss_newton as gn
    from okvis2x_tpu.testing import synthetic_window_problem

    p, cams = synthetic_window_problem(K=8, L=704, N=n_obs, dtype=jnp.float32)
    cfg = gn.SolverConfig(max_iterations=3)
    out, cost = optimize_distributed(p, cams, cfg, mesh)
    jax.block_until_ready(cost)
    t0 = time.perf_counter()
    for _ in range(reps):
        out, cost = optimize_distributed(p, cams, cfg, mesh)
    jax.block_until_ready(cost)
    dt = (time.perf_counter() - t0) / reps
    assert bool(jnp.isfinite(cost))
    return dt * 1e3  # ms per 3-iteration solve


def bench_pose_graph(mesh, n_nodes, reps=3):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.core import se3
    from okvis2x_tpu.parallel.dist_posegraph import optimize_pose_graph_pcg

    rng = np.random.default_rng(0)
    K = n_nodes
    T = np.tile(np.asarray(se3.se3_identity(jnp.float32)), (K, 1))
    T[:, 0] = np.arange(K) * 0.5
    # odometry chain + 25% random loop edges
    ei = np.arange(K - 1)
    ej = ei + 1
    nl = K // 4
    li = rng.integers(0, K - 10, nl)
    lj = li + rng.integers(5, 10, nl)
    ei = np.concatenate([ei, li])
    ej = np.concatenate([ej, lj])
    E = len(ei)
    eT = np.tile(np.asarray(se3.se3_identity(jnp.float32)), (E, 1))
    eT[: K - 1, 0] = 0.5
    eT[K - 1:, 0] = 0.5 * (lj - li)
    eS = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    _, cost = optimize_pose_graph_pcg(
        T, fixed, ei, ej, eT, eS, iterations=2, cg_iterations=24,
        mesh=mesh, dtype=jnp.float32,
    )
    t0 = time.perf_counter()
    for _ in range(reps):
        _, cost = optimize_pose_graph_pcg(
            T, fixed, ei, ej, eT, eS, iterations=2, cg_iterations=24,
            mesh=mesh, dtype=jnp.float32,
        )
    jax.block_until_ready(cost)
    dt = (time.perf_counter() - t0) / reps
    assert np.isfinite(float(cost))
    return dt * 1e3


def bench_submap(mesh, n_rays, reps=3):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.core import se3
    from okvis2x_tpu.mapping import brick
    from okvis2x_tpu.parallel.dist_submap import integrate_rays_sharded

    cfg = brick.BrickConfig(
        table_dim=32, brick=8, res=0.025, pool_bricks=4096,
        samples_per_ray=48, band_samples=8,
    )
    sm = brick.new_submap(jnp.asarray(se3.se3_identity(jnp.float32)), cfg)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ends = jnp.asarray(d * rng.uniform(1.0, 3.0, (n_rays, 1)))
    valid = jnp.ones((n_rays,), bool)
    origin = jnp.zeros(3, jnp.float32)
    out = integrate_rays_sharded(sm, cfg, origin, ends, valid, mesh)
    jax.block_until_ready(out.pool_lo)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = integrate_rays_sharded(sm, cfg, origin, ends, valid, mesh)
    jax.block_until_ready(out.pool_lo)
    dt = (time.perf_counter() - t0) / reps
    assert int(out.n_alloc) > 0
    return dt * 1e3


def comm_models(n_dev, n_obs_weak, n_rays_weak):
    """Analytic per-device work + collective payload bytes for each
    distributed program (the quantity that actually predicts ICI behaviour
    — wall clock on an oversubscribed virtual CPU mesh cannot separate
    compute contention from communication).  A psum moves ~2x the payload
    around a ring (reduce-scatter + all-gather); payload bytes are listed,
    ring factor noted in the JSON.
    """
    f = 4  # float32 bytes
    # ---- window BA: K=8 frames, L=704 lm, pose dim P = 15K + 6C + 7
    K, L, C = 8, 704, 1
    P = 15 * K + 6 * C + 7
    ba_payload = f * (P * P + P + 1 + L * 9 + L * 3 + L * P * 3)
    # per-obs-row linearise ~ (2 residual rows) x (P + 3) jacobian cols,
    # plus the one-hot matmul contractions for the landmark blocks
    ba_flops_row = 2 * (P + 3) * 8
    # ---- pose graph PCG: K=512 nodes, E = K-1 + K/4 edges
    Kp, it, cg = 512, 2, 24
    Ep = Kp - 1 + Kp // 4
    pg_payload = it * f * (Kp * 6 + Kp * 36 + 1) + it * cg * f * (
        Kp * 6 + 2
    )
    pg_flops_edge = 36 * 6 * 4 * (1 + cg)
    # ---- submap: touched-mask psum + 2 compact accumulators
    # (cap x brick^3; the pre-fix path all-reduced the full pool:
    # 2 x 4096 x 512 floats = 16.8 MB, ray-count-independent)
    T3, cap, b3, pool = 32 ** 3, 256, 512, 4096
    sm_payload = f * (T3 + 2 * (cap * b3 + 1))
    sm_payload_old = f * (T3 + 2 * pool * b3)
    sm_flops_ray = 48 * 20  # samples x per-sample update cost
    return dict(
        window_ba=dict(
            payload_bytes_per_iter=ba_payload,
            rows_per_device_strong=8192 // n_dev,
            rows_per_device_weak=n_obs_weak // n_dev,
            flops_per_row=ba_flops_row,
        ),
        pose_graph=dict(
            payload_bytes_per_solve=pg_payload,
            edges_per_device=Ep // n_dev,
            flops_per_edge=pg_flops_edge,
        ),
        submap=dict(
            payload_bytes_per_integration=sm_payload,
            payload_bytes_pre_compact_fix=sm_payload_old,
            rays_per_device_strong=4096 // n_dev,
            rays_per_device_weak=n_rays_weak // n_dev,
            flops_per_ray=sm_flops_ray,
        ),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=None, help="write a markdown table")
    ap.add_argument("--json", default=None, help="write structured results")
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform

    max_dev = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max_dev}"
        ).strip()

    from okvis2x_tpu.utils import jaxconfig

    jaxconfig.setup()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from okvis2x_tpu.parallel.mesh import make_mesh

    rows = []
    for n in args.devices:
        mesh = make_mesh(n)
        ba_strong = bench_window_ba(mesh, 8192)
        ba_weak = bench_window_ba(mesh, 1024 * n)
        pg = bench_pose_graph(mesh, 512)
        sm_strong = bench_submap(mesh, 4096)
        sm_weak = bench_submap(mesh, 512 * n)
        rows.append((n, ba_strong, ba_weak, pg, sm_strong, sm_weak))
        print(
            f"devices={n}: BA strong {ba_strong:.1f} ms / weak {ba_weak:.1f} ms"
            f" | posegraph512 {pg:.1f} ms | submap strong {sm_strong:.1f} ms"
            f" / weak {sm_weak:.1f} ms",
            flush=True,
        )

    if args.json:
        import json

        t1 = {r[0]: r for r in rows}.get(1, rows[0])
        out = dict(
            platform=jax.devices()[0].platform,
            physical_cores=os.cpu_count(),
            note=(
                "virtual CPU mesh: devices share physical cores, so "
                "absolute strong-scaling time is compute-bound by the "
                "core count; weak-scaling flatness and per-device-work "
                "shrinkage are the meaningful columns"
            ),
            shapes=dict(
                window_ba="K=8 L=704 N=8192 (strong) / 1024*dev (weak)",
                pose_graph="512 nodes, odometry + 25% loop edges",
                submap="4096 rays (strong) / 512*dev (weak)",
            ),
            collective_note=(
                "payload bytes listed once; a psum moves ~2x payload "
                "around a ring (reduce-scatter + all-gather); per-device "
                "work columns are the sharded quantities that shrink "
                "with the mesh"
            ),
            rows=[
                dict(
                    devices=n,
                    ba_strong_ms=round(a, 1),
                    ba_weak_ms=round(b, 1),
                    posegraph_ms=round(c, 1),
                    submap_strong_ms=round(d, 1),
                    submap_weak_ms=round(e, 1),
                    ba_weak_efficiency=round(t1[2] / b, 3),
                    submap_weak_efficiency=round(t1[5] / e, 3),
                    ba_strong_speedup=round(t1[1] / a, 3),
                    work_comm=comm_models(n, 1024 * n, 512 * n),
                )
                for n, a, b, c, d, e in rows
            ],
        )
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")

    if args.out:
        plat = jax.devices()[0].platform
        lines = [
            "# Multi-device scaling (generated by tools/scaling_bench.py)",
            "",
            f"Platform: {plat}, {os.cpu_count()} physical cores, "
            f"virtual devices via xla_force_host_platform_device_count.",
            "",
            "Shapes: window BA K=8/L=704/N=8192 obs (strong) or 1024/dev "
            "(weak); pose graph 512 nodes; submap 4096 rays (strong) or "
            "512/dev (weak).  ms per solve (3 LM iters / 2 LM x 24 CG / "
            "one integration).",
            "",
            "| devices | BA strong | BA weak | posegraph 512 | submap strong | submap weak |",
            "|---|---|---|---|---|---|",
        ]
        for n, a, b, c, d, e in rows:
            lines.append(
                f"| {n} | {a:.1f} ms | {b:.1f} ms | {c:.1f} ms | "
                f"{d:.1f} ms | {e:.1f} ms |"
            )
        lines.append("")
        with open(args.out, "w") as f:
            f.write("\n".join(lines))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
