"""Benchmark: end-to-end SLAM + kernel metrics on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

Headline metric: steady-state frames/s of the full SLAM pipeline (detector →
descriptor → association → sliding-window BA → marginalisation → loop
closure) on the reference-scale circuit benchmark (752x480 stereo @ 20 Hz,
200 Hz IMU, 704 keypoints — the EuRoC operating point of
config/euroc/okvis2.yaml:74-99).  Baseline: the reference runs real time at
20 fps on 3 CPU threads, so vs_baseline = fps / 20.  Fails without a GPU.

MEASUREMENT PROTOCOL (warm): VioPipeline.precompile() force-compiles (or
persistent-cache-loads) every program the frame loop, loop-closure and
background full-graph paths can dispatch BEFORE the first frame; the fps
window additionally excludes `warmup_frames`.  The measured number
therefore reflects the framework, not XLA's compiler — `cold_compile_s`
in `extra` reports the one-off compile/load cost separately.

`extra` carries the rest of the evidence the driver archives:
  * ate_online_m / ate_final_m, loop closures, landmark merges
  * cold_compile_s: init-time precompile wall (≈0 on a warm cache)
  * ba_iterations_per_s on the realtime window shape (vs the reference's
    10-iterations-in-35 ms Ceres budget)
  * hamming_gbs: packed XOR-popcount descriptor matching at database scale
  * detect_ms: detection+description per 752x480 stereo frame
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_FPS = 20.0  # reference realtime operating point
BASELINE_ITERS_PER_S = 10 / 0.035  # reference realtime BA budget


def bench_ba():
    from okvis2x_tpu.solver import gauss_newton as gn
    from okvis2x_tpu.testing import synthetic_window_problem

    iters = 10
    p, cams = synthetic_window_problem(K=8, L=512, N=4096, dtype=jnp.float32)
    cfg = gn.SolverConfig(max_iterations=iters)
    run = jax.jit(lambda prob: gn.optimize(prob, cams, cfg))
    out, cost = run(p)
    jax.block_until_ready(cost)
    n_rep = 20
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out, cost = run(p)
    jax.block_until_ready(cost)
    dt = (time.perf_counter() - t0) / n_rep
    return iters / dt


def bench_hamming():
    """Packed Hamming distance matrix at loop-closure database scale: 768
    query descriptors (704 keypoints, padded) vs 16384 database
    descriptors, 384 bits each."""
    from okvis2x_tpu.frontend import matcher

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 2**32, (768, 12), dtype=np.uint32))
    db = jnp.asarray(rng.integers(0, 2**32, (16384, 12), dtype=np.uint32))
    run = jax.jit(matcher.hamming_matrix_packed)
    out = run(q, db)
    jax.block_until_ready(out)
    n_rep = 20
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = run(q, db)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n_rep
    # effective bytes = query*db pairs x 48 B of descriptor reads
    gbs = (int(q.shape[0]) * int(db.shape[0]) * 48) / dt / 1e9
    return gbs, dt * 1e3


def bench_detect():
    """Detection + description, 752x480 stereo pair, 704 keypoints."""
    from okvis2x_tpu.frontend import descriptor, detector

    rng = np.random.default_rng(1)
    imgs = jnp.asarray(
        rng.integers(0, 255, (2, 480, 768), dtype=np.uint8)
    )

    @jax.jit
    def run(ims):
        ims = ims.astype(jnp.float32) / 255.0

        def one(img):
            kp = detector.detect(
                img, max_keypoints=704, octaves=2, cell=32, per_cell=8,
                threshold=1e-7,
            )
            packed, _ = descriptor.extract(
                img, kp.uv, jnp.zeros((704,)), kp.level, kp.valid
            )
            return kp.uv, kp.valid, packed

        return jax.vmap(one)(ims)

    out = run(imgs)
    jax.block_until_ready(out)
    n_rep = 20
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = run(imgs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_rep * 1e3


def bench_slam():
    """Bounded reference-scale SLAM run (cached circuit dataset).

    The window covers 60 s of the 46 s-lap circuit so the measured
    throughput includes the first revisit: loop-closure verification,
    landmark merging, the background full-graph solve and re-anchoring
    all run INSIDE the timed region (the reference pays these costs in
    its realtime loop too, ViSlamBackend.cpp:2361-2556)."""
    from tools import slam_bench

    frames = int(os.environ.get("BENCH_SLAM_FRAMES", "1200"))
    res = slam_bench.run(
        duration=65.0, warmup_frames=40, verbose=False, max_frames=frames
    )
    return res


def main():
    from okvis2x_tpu.utils import jaxconfig

    jaxconfig.setup()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX runs on {dev.platform}")

    slam = bench_slam()
    ba_its = bench_ba()
    gbs, ham_ms = bench_hamming()
    det_ms = bench_detect()

    fps = slam["fps_steady"]
    print(
        json.dumps(
            {
                "metric": "slam_fps_steady",
                "value": fps,
                "unit": "frames/s end-to-end (752x480 stereo, 704 kps, "
                        "window BA + loop closure)",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "extra": {
                    "device": {"platform": dev.platform,
                               "kind": dev.device_kind,
                               "count": len(jax.devices())},
                    "render_s": slam["render_s"],
                    "ms_per_frame_p50": slam["ms_per_frame_p50"],
                    "ms_per_frame_p90": slam["ms_per_frame_p90"],
                    # compile/cache-load cost paid ONCE at init by
                    # VioPipeline.precompile() — everything the frame loop
                    # and loop-closure paths dispatch is compiled before
                    # the measured window, so the fps above reflects the
                    # framework, not XLA's compiler
                    "cold_compile_s": slam.get("precompile_s"),
                    "ate_online_m": slam["ate_online_m"],
                    "ate_final_m": slam["ate_final_m"],
                    "loop_closures": slam["loop_closures"],
                    "landmarks_merged": slam["landmarks_merged"],
                    "frames": slam["frames"],
                    "keyframes": slam.get("keyframes"),
                    "finish_s": slam.get("wall_split_s", {}).get("finish"),
                    "final_ba_s": slam.get("final_ba_s"),
                    "wall_split_s": slam.get("wall_split_s"),
                    "ba_iterations_per_s": round(ba_its, 2),
                    "ba_vs_ref_budget": round(ba_its / BASELINE_ITERS_PER_S, 3),
                    "hamming_gbs": round(gbs, 2),
                    "hamming_ms_704x16384": round(ham_ms, 3),
                    "detect_ms_stereo_752x480": round(det_ms, 2),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
