"""Reference-scale system proof: the full 185 s circuit benchmark.

These tests drive ``tools/slam_bench.py`` — the reference-scale benchmark at
the EuRoC operating point (752x480 stereo @ 20 Hz, 200 Hz IMU, 704
keypoints; ≙ config/euroc/okvis2.yaml:74-99) — in a SUBPROCESS so it runs on
the default platform (the GPU when there is one; conftest's CPU forcing
applies only in-process).  This is the production f32 path, so a
passing run also validates f32-on-device numerics over the full circuit
(SURVEY §7.3 hard-part 5).

Asserted behaviour (≙ the reference's signature end-to-end properties):
  * the run COMPLETES all ~3700 frames — no capacity assert kills it
    (chained IMU preintegration ≙ ImuError::append,
    okvis_ceres/include/okvis/ceres/ImuError.hpp:296)
  * loop closures fire on revisit and landmarks merge
    (≙ attemptLoopClosure, okvis_ceres/src/ViSlamBackend.cpp:2361-2556)
  * final-BA ATE improves on (or matches) online ATE; bounds at the
    measured multi-lap operating point — see
    test_circuit_ate_operating_point for the numbers and their
    provenance (the 65 s single-revisit window asserted by bench.py
    still holds 0.05 m after final BA).

The circuit dataset is cached in the temporary directory keyed by its
parameters — the first run pays a one-off render; subsequent runs (and
bench.py, which uses the same parameters) reuse it.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def circuit_result():
    env = dict(os.environ)
    # drop the suite's CPU/x64 forcing: the subprocess should exercise the
    # production platform (the GPU if there is one, else CPU f32)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "slam_bench.py"),
         "--duration", "185"],
        capture_output=True, text=True, timeout=7200, cwd=REPO, env=env,
    )
    assert out.returncode == 0, (
        f"slam_bench crashed:\n{out.stderr[-4000:]}"
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_circuit_completes(circuit_result):
    # 185 s @ 20 Hz minus the 0.3 s lead-in: every frame processed, no
    # capacity assert (the round-2 failure mode died at frame ~110)
    assert circuit_result["frames"] >= 3600, circuit_result


@pytest.mark.slow
def test_circuit_loop_closures(circuit_result):
    # ~4 laps -> every lap after the first revisits every viewpoint
    assert circuit_result["loop_closures"] >= 2, circuit_result
    assert circuit_result["landmarks_merged"] > 0, circuit_result


@pytest.mark.slow
def test_circuit_ate_operating_point(circuit_result):
    # drift bounds over the ~370 m / 185 s / 4-lap circuit, f32 on-device.
    # Earlier runs of this circuit held online ATE near 0.3 m (the online
    # log keeps each frame's as-estimated pose — historical drift before a
    # closure is never rewritten) and final ATE near 0.17 m after the
    # fixpoint pose-graph/segment final BA.  The bounds leave ~3x headroom
    # for host contention: async correction timing degrades online ATE
    # when the frame loop is starved.
    ate_online = circuit_result["ate_online_m"]
    ate_final = circuit_result["ate_final_m"]
    assert ate_online <= 1.0, circuit_result
    assert ate_final <= 0.30, circuit_result
    # final BA + loop closures must improve on the online trajectory
    assert ate_final <= ate_online, circuit_result
