"""Device programs against their plain references, at real widths.

Each check runs one program on JAX's default device and compares it with a
reference computed independently of that device: numpy, or a child process
pinned to the CPU (`python -m okvis2x_tpu.device_checks <kind> <out.npz>`).
The child keeps float64 out of the calling process, whose pipeline dtype
resolution must stay float32 (`jax_enable_x64` switches it), and never
opens the card.  Each check returns a dict of numbers, the tolerance each
is held to, and `ok`.  Used by chip_smoke.py and the tests marked `gpu`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

F32_EPS = float(np.finfo(np.float32).eps)
# packed Hamming at loop-closure database scale: 704 query keypoints padded
# to 768 rows, against 16384 stored descriptors
HAMMING_SHAPE = (768, 16384)
# the window solve at the bench shape (bench.py bench_ba)
SOLVE_SHAPE = dict(K=8, L=512, N=4096)
SOLVE_ITERS = 10
# the EuRoC frontend operating point (tools/slam_bench.py)
FRONTEND_KEYPOINTS = 704
FRONTEND_SEED = 3


def _cpu_child(kind: str, inputs: dict | None = None) -> dict:
    """Run `kind`'s reference in a CPU-only child process, handing it
    `inputs` (arrays); returns its arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ref.npz")
        args = [kind, out]
        if inputs is not None:
            args.append(os.path.join(tmp, "in.npz"))
            np.savez(args[-1], **inputs)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_CHECKOUT, env.get("PYTHONPATH")) if p
        )
        subprocess.run(
            [sys.executable, "-m", "okvis2x_tpu.device_checks", *args],
            env=env, check=True, cwd=_CHECKOUT,
        )
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


# --------------------------------------------------------------- Hamming


def _popcount_rows(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    """numpy reference: (NQ, ND) bit counts of q XOR d, 64 rows at a time."""
    out = np.empty((len(q), len(d)), np.int32)
    for i in range(0, len(q), 64):
        x = (q[i:i + 64, None, :] ^ d[None, :, :]).view(np.uint8)
        out[i:i + 64] = np.unpackbits(x, axis=-1).sum(-1, dtype=np.int32)
    return out


def hamming_check(seed: int = 0) -> dict:
    """matcher.hamming_matrix_packed at 768 x 16384 against numpy bit
    counts.  Integer arithmetic, so the tolerance is exact equality."""
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.frontend import matcher

    rng = np.random.default_rng(seed)
    nq, nd = HAMMING_SHAPE
    q = rng.integers(0, 2**32, (nq, 12), dtype=np.uint32)
    d = rng.integers(0, 2**32, (nd, 12), dtype=np.uint32)
    got = np.asarray(
        jax.jit(matcher.hamming_matrix_packed)(jnp.asarray(q), jnp.asarray(d))
    )
    mismatches = int((got != _popcount_rows(q, d)).sum())
    return dict(shape=[nq, nd], mismatches=mismatches, tolerance=0,
                ok=mismatches == 0)


# ------------------------------------------------------------ window solve


def _window_problem(dtype, leaves=None):
    """The bench-shape window problem; `leaves` (arrays named leaf<i>)
    replace its state, cast to `dtype`'s precision."""
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.testing import synthetic_window_problem

    p, cams = synthetic_window_problem(**SOLVE_SHAPE, dtype=dtype)
    if leaves is not None:
        old, treedef = jax.tree.flatten(p)
        p = jax.tree.unflatten(treedef, [
            jnp.asarray(leaves[f"leaf{i}"]).astype(x.dtype)
            for i, x in enumerate(old)
        ])
    return p, cams


def _leaves(p) -> dict:
    import jax

    return {f"leaf{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(p))}


def _solve(p, cams):
    """Compile and run the LM window solve; returns (solution, cost, cfg,
    compiled program)."""
    import jax

    from okvis2x_tpu.solver import gauss_newton as gn

    cfg = gn.SolverConfig(max_iterations=SOLVE_ITERS)
    compiled = jax.jit(lambda q: gn.optimize(q, cams, cfg)).lower(p).compile()
    out, cost = compiled(p)
    return out, cost, cfg, compiled


def _solve_reference() -> dict:
    """float64 CPU: the problem's leaves, the solution, and the condition
    number of the Jacobi-scaled reduced camera system at the solution."""
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.solver import gauss_newton as gn

    jax.config.update("jax_enable_x64", True)
    p, cams = _window_problem(jnp.float64)
    out, cost, cfg, _ = _solve(p, cams)
    lin = gn.linearize(out, cams, cfg)
    H, W = np.asarray(lin.H_ff), np.asarray(lin.W)
    H_ll_inv = np.linalg.inv(np.asarray(lin.H_ll) + 1e-10 * np.eye(3))
    Hr = H - np.einsum("lpi,lij,lqj->pq", W, H_ll_inv, W)
    free = np.diag(Hr) > 1e-9  # gauge-fixed and absent blocks drop out
    Hr = Hr[free][:, free]
    s = 1.0 / np.sqrt(np.diag(Hr))
    cond = np.linalg.cond(Hr * s[:, None] * s[None, :])
    return dict(_leaves(p), cost=np.asarray(cost), T_WS=np.asarray(out.T_WS),
                cond=np.asarray(cond))


def _cost_reference(inputs: str) -> dict:
    """float64 CPU robust cost of the problem state in `inputs`."""
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.solver import gauss_newton as gn

    jax.config.update("jax_enable_x64", True)
    with np.load(inputs) as z:
        p, cams = _window_problem(jnp.float64, z)
    cfg = gn.SolverConfig(max_iterations=SOLVE_ITERS)
    return dict(cost=np.asarray(gn.compute_cost(p, cams, cfg)))


def window_solve_check() -> dict:
    """The f32 window LM solve (default matmul precision `highest`) against
    the float64 CPU solve of the same problem.

    Solution bound: a solve in precision eps perturbs the solution by about
    cond * eps relative to its scale, where cond is the condition number of
    the Jacobi-scaled reduced camera system the solver inverts.  The check
    allows ten times that (other summation orders and the 10-iteration
    path) on translations, against max(1 m, the largest translation), and
    on quaternion components; and it requires the card's solution to cost,
    evaluated in float64, no more than the reference's by that factor.  The
    robust cost is non-convex, so rounding may steer the two LM paths to
    slightly different minima: the card may end lower, not higher.

    Evaluation bound: the card's f32 cost of its own solution against the
    float64 cost of the same state, within N * eps for a sum over N
    observations (TF32 products would miss it by about 1e-3)."""
    import jax.numpy as jnp

    ref = _cpu_child("solve")
    p, cams = _window_problem(jnp.float32, ref)
    out, cost, _, compiled = _solve(p, cams)
    own = float(_cpu_child("cost", _leaves(out))["cost"])
    T = np.asarray(out.T_WS, np.float64)
    T_ref = ref["T_WS"]
    bound = 10.0 * float(ref["cond"]) * F32_EPS
    eval_bound = SOLVE_SHAPE["N"] * F32_EPS
    cost_ref = float(ref["cost"])
    eval_rel = abs(float(cost) - own) / own
    trans = float(np.abs(T[:, :3] - T_ref[:, :3]).max())
    trans_tol = bound * max(1.0, float(np.abs(T_ref[:, :3]).max()))
    quat = float(np.abs(T[:, 3:] - T_ref[:, 3:]).max())
    finite = bool(np.isfinite(T).all() and np.isfinite(float(cost)))
    return dict(
        shape=SOLVE_SHAPE, memory=str(compiled.memory_analysis()),
        cond=float(ref["cond"]), rel_bound=bound,
        cost_card=float(cost), cost_card_f64=own, cost_ref=cost_ref,
        eval_rel=eval_rel, eval_bound=eval_bound,
        trans_m=trans, trans_tol_m=trans_tol, quat=quat, quat_tol=bound,
        ok=finite and eval_rel <= eval_bound
        and own <= cost_ref * (1.0 + bound)
        and trans <= trans_tol and quat <= bound,
    )


# ------------------------------------------------- detection + description


def circuit_stereo_pair(seed: int = FRONTEND_SEED) -> np.ndarray:
    """(2, 480, 752) uint8: the first stereo frame of the EuRoC-rate
    circuit dataset (io/synthetic.py, same scene and rig)."""
    from okvis2x_tpu.cameras import pinhole_np
    from okvis2x_tpu.core import se3np
    from okvis2x_tpu.io import synthetic

    cam = pinhole_np.NpCamera(
        fxfycxcy=np.array([460.0, 460.0, 376.0, 240.0]),
        dist_params=np.array([-0.25, 0.06, 1e-4, -1e-4]),
        width=752, height=480, model="radtan",
    )
    pts, bright, radius = synthetic.make_circuit_scene(seed=seed, sectors=6)
    p, q, _, _, _ = synthetic.circuit_trajectory(np.array([0.3]))
    T_WS = np.concatenate([p[0], q[0]])
    imgs = []
    for c, x in enumerate((-0.055, 0.055)):
        T_WC = se3np.se3_multiply(T_WS, np.array([x, 0, 0, 0, 0, 0, 1.0]))
        img = synthetic.render_image(cam, T_WC, pts, bright, radius, seed=c)
        imgs.append((img * 255).astype(np.uint8))
    return np.stack(imgs)


def frontend_fn():
    """The pipeline's detection + description program for a stereo pair at
    the EuRoC operating point: uint8 (2, H, W) -> (uv, valid, packed)."""
    import jax
    import jax.numpy as jnp

    from okvis2x_tpu.frontend import descriptor, detector
    from okvis2x_tpu.pipeline.vio import PipelineConfig

    cfg = PipelineConfig(max_keypoints=FRONTEND_KEYPOINTS)
    n = cfg.max_keypoints

    def one(img):
        kp = detector.detect(
            img, max_keypoints=n, octaves=cfg.octaves,
            cell=cfg.detection_cell, per_cell=cfg.detection_per_cell,
            threshold=cfg.harris_threshold,
        )
        packed, _ = descriptor.extract(
            img, kp.uv, jnp.zeros((n,), jnp.float32), kp.level, kp.valid
        )
        return kp.uv, kp.valid, packed

    @jax.jit
    def run(imgs):
        return jax.vmap(one)(imgs.astype(jnp.float32) / 255.0)

    return run


def _frontend_reference() -> dict:
    uv, valid, packed = frontend_fn()(circuit_stereo_pair())
    return dict(uv=np.asarray(uv), valid=np.asarray(valid),
                packed=np.asarray(packed))


# keypoints whose positions differ by less than this are the same corner
KP_SAME_PX = 1e-2
# the selection differs only where Harris responses tie at a cell's
# cut-off, so nearly every keypoint must agree
KP_SHARE_MIN = 0.98
# descriptor bits compare blurred intensities; GPU summation order moves
# them by f32 round-off, flipping only comparisons that were near-equal
BIT_SHARE_MIN = 0.995


def frontend_check() -> dict:
    """Detection + description of a 752x480 stereo pair on the default
    device against the same f32 program on the CPU.  Keypoints are paired
    by position; paired keypoints' descriptor bits are compared."""
    ref = _cpu_child("frontend")
    uv, valid, packed = (np.asarray(a) for a in frontend_fn()(
        circuit_stereo_pair()))
    n_kp, n_same, bits_same, bits_all = 0, 0, 0, 0
    for c in range(uv.shape[0]):
        a = np.nonzero(valid[c])[0]
        b = np.nonzero(ref["valid"][c])[0]
        n_kp += max(len(a), len(b))
        if len(a) == 0 or len(b) == 0:
            continue
        dist = np.linalg.norm(
            uv[c][a][:, None] - ref["uv"][c][b][None], axis=-1
        )
        j = dist.argmin(1)
        same = dist[np.arange(len(a)), j] < KP_SAME_PX
        n_same += int(same.sum())
        x = packed[c][a[same]] ^ ref["packed"][c][b[j[same]]]
        bits_same += int(x.size * 32 - np.unpackbits(x.view(np.uint8)).sum())
        bits_all += x.size * 32
    kp_share = n_same / max(n_kp, 1)
    bit_share = bits_same / max(bits_all, 1)
    return dict(
        keypoints=int(valid.sum()), keypoints_ref=int(ref["valid"].sum()),
        kp_share=kp_share, kp_share_min=KP_SHARE_MIN,
        bit_share=bit_share, bit_share_min=BIT_SHARE_MIN,
        ok=n_kp > 0 and kp_share >= KP_SHARE_MIN
        and bit_share >= BIT_SHARE_MIN,
    )


_REFERENCES = {"solve": _solve_reference, "cost": _cost_reference,
               "frontend": _frontend_reference}

if __name__ == "__main__":
    kind, out_path = sys.argv[1], sys.argv[2]
    np.savez(out_path, **_REFERENCES[kind](*sys.argv[3:]))
