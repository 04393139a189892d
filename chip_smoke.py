#!/usr/bin/env python
"""Smoke test of the SLAM system on one GPU.

Run from the root of a checkout:  python chip_smoke.py

Phases, in one process that holds the card throughout:

  device   the card's name and power limit (nvidia-smi), JAX's devices.
           Fails unless JAX's default backend is the GPU.
  kernels  each device program of the main path compiled for the card at
           real widths and compared with its plain reference
           (okvis2x_tpu/device_checks.py): packed Hamming against numpy bit
           counts, the window LM solve against the float64 CPU solve, and
           detection + description of a 752x480 stereo pair against the CPU.
  slam     the EuRoC-rate stereo-inertial SLAM run of bench.py (752x480
           stereo at 20 Hz, 200 Hz IMU, 704 keypoints, loop closure, final
           BA) over 60 s of the seed-3 circuit, which includes the first
           revisit of its 46 s lap.  Fails on a non-finite pose, no loop
           closure, or ATE above its bound.

Any failed phase raises, so the script exits non-zero without printing the
result line.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import json
import subprocess
import sys
import time

# ATE bounds [m] of the slam phase, with headroom over the first H100 run
# of this configuration (online 0.04 m, final 0.012 m)
ATE_ONLINE_MAX_M = 0.4
ATE_FINAL_MAX_M = 0.2
SLAM_FRAMES = 1200  # 60 s at 20 Hz


class PhaseFailed(RuntimeError):
    pass


def _phase(name, fn):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    out = fn()
    print(f"== {name} passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def device_phase():
    import jax

    devs = jax.devices()
    print(f"jax devices: {devs}", flush=True)
    if jax.default_backend() != "gpu":
        raise PhaseFailed(f"no GPU: JAX runs on {jax.default_backend()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"device_kind: {devs[0].device_kind}", flush=True)
    return devs


def kernels_phase():
    from okvis2x_tpu import device_checks

    failed = []
    for name, check in (
        ("packed Hamming", device_checks.hamming_check),
        ("window LM solve", device_checks.window_solve_check),
        ("detection + description", device_checks.frontend_check),
    ):
        res = check()
        memory = res.pop("memory", None)
        if memory is not None:
            print(f"{name} memory_analysis: {memory}", flush=True)
        print(f"{name}: {json.dumps(res)}", flush=True)
        if not res["ok"]:
            failed.append(name)
    if failed:
        raise PhaseFailed(f"outside tolerance: {', '.join(failed)}")


def slam_phase():
    from tools import slam_bench

    res = slam_bench.run(duration=65.0, warmup_frames=40, verbose=False,
                         max_frames=SLAM_FRAMES)
    for key in ("render_s", "precompile_s", "fps_steady",
                "ms_per_frame_p50", "ms_per_frame_p90", "ate_online_m",
                "ate_final_m", "loop_closures", "final_ba_s", "frames"):
        print(f"slam {key}: {res[key]}", flush=True)
    problems = []
    if not res["poses_finite"]:
        problems.append("non-finite pose")
    if res["loop_closures"] < 1:
        problems.append("no loop closure")
    if not res["ate_online_m"] <= ATE_ONLINE_MAX_M:
        problems.append(f"online ATE {res['ate_online_m']} m > "
                        f"{ATE_ONLINE_MAX_M} m")
    if not res["ate_final_m"] <= ATE_FINAL_MAX_M:
        problems.append(f"final ATE {res['ate_final_m']} m > "
                        f"{ATE_FINAL_MAX_M} m")
    if problems:
        raise PhaseFailed("; ".join(problems))


def main():
    from okvis2x_tpu.utils import jaxconfig

    jaxconfig.setup()
    devs = _phase("device", device_phase)
    _phase("kernels", kernels_phase)
    _phase("slam", slam_phase)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr)
        sys.exit(1)
