"""IMU preintegration: propagation, covariance, and bias Jacobians.

JAX replacement for the reference's `ceres::ImuError` machinery
(okvis_ceres/src/ImuError.cpp:258 `redoPreintegration`, :537 static
`propagation`).  Same mathematical model — midpoint integration of the
standard IMU kinematics with additive Gaussian noise on gyro/accel and
random-walk biases — but expressed as a `lax.scan` over a fixed-capacity,
mask-padded measurement buffer so one compiled program serves every frame.

Frames/notation (matching the reference):
    W  world (gravity -g e_z), S  sensor/IMU frame
    state x = (T_WS [7], v_W [3], b_g [3], b_a [3])
    preintegration from t0 to t1 in the S0 frame:
        Delta_q   : rotation S0 <- S1
        Delta_p, Delta_v : position / velocity increments in S0
    bias Jacobians dDelta{p,q,v}/db{g,a} accumulated alongside.

The preintegrated quantities are linear in the (small) bias deviation around
the linearisation point, so the factor re-linearises cheaply without
re-scanning — mirroring ImuError's `redoPreintegration` policy where a full
redo happens only when the bias moved too far.

Measurement buffer layout: arrays of shape (N, .) with a validity mask;
timestamps in seconds (float64 on host, cast down on device).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


class ImuParams(NamedTuple):
    """Noise densities (continuous-time), matching okvis2.yaml `imu_params`
    (reference: okvis_common/include/okvis/Parameters.hpp ImuParameters)."""

    sigma_g: float = 12.0e-4  # gyro noise density [rad/s/sqrt(Hz)]
    sigma_a: float = 8.0e-3  # accel noise density [m/s^2/sqrt(Hz)]
    sigma_gw: float = 4.0e-6  # gyro random walk
    sigma_aw: float = 4.0e-5  # accel random walk
    g: float = 9.81007  # gravity magnitude
    rate: float = 200.0  # nominal rate [Hz]
    g_max: float = 7.8  # max gyro reading [rad/s]
    a_max: float = 176.0  # max accel reading [m/s^2]
    sigma_bg: float = 0.03  # prior stdev gyro bias (init)
    sigma_ba: float = 0.1  # prior stdev accel bias (init)


class ImuBatch(NamedTuple):
    """Fixed-capacity measurement window. Invalid rows masked out."""

    t: jax.Array  # (N,) timestamps [s]
    gyr: jax.Array  # (N, 3)
    acc: jax.Array  # (N, 3)
    mask: jax.Array  # (N,) bool


class Preintegrated(NamedTuple):
    """Result of preintegrating an ImuBatch between t0 and t1."""

    dq: jax.Array  # (4,) Delta rotation quaternion (S0 <- S1)
    dp: jax.Array  # (3,) position increment in S0 (bias-corrected at lin point)
    dv: jax.Array  # (3,) velocity increment in S0
    # bias Jacobians at the linearisation point
    dp_dbg: jax.Array  # (3,3)
    dp_dba: jax.Array  # (3,3)
    dv_dbg: jax.Array  # (3,3)
    dv_dba: jax.Array  # (3,3)
    dq_dbg: jax.Array  # (3,3)   d(log dq)/db_g
    P: jax.Array  # (15,15) covariance of [dalpha, dv, dp, dbg, dba]... see order below
    dt: jax.Array  # () total integration time
    lin_bg: jax.Array  # (3,) gyro bias linearisation point
    lin_ba: jax.Array  # (3,) accel bias linearisation point


# Error-state ordering used for P throughout this module:
#   [ dp (0:3), dalpha (3:6), dv (6:9), dbg (9:12), dba (12:15) ]
# (matches the reference residual ordering in ImuError::Evaluate)


def preintegrate(
    params: ImuParams,
    batch: ImuBatch,
    t0: jax.Array,
    t1: jax.Array,
    bg: jax.Array,
    ba: jax.Array,
) -> Preintegrated:
    """Midpoint preintegration over measurements in [t0, t1].

    Mirrors the numerics of ImuError::redoPreintegration (okvis_ceres/src/
    ImuError.cpp:258): trapezoidal accel/gyro averaging between consecutive
    samples, covariance propagated in the 15-dim error state, bias Jacobians
    chained per step.  Boundary samples are clipped to [t0, t1] by shrinking
    dt of the first/last intervals.
    """
    dtype = batch.acc.dtype
    n = batch.t.shape[0]

    # interval endpoints clipped to [t0, t1]
    ta = jnp.clip(batch.t[:-1], t0, t1)
    tb = jnp.clip(batch.t[1:], t0, t1)
    dts = jnp.maximum(tb - ta, 0.0) * batch.mask[:-1] * batch.mask[1:]

    g0 = batch.gyr[:-1] - bg
    g1 = batch.gyr[1:] - bg
    a0 = batch.acc[:-1] - ba
    a1 = batch.acc[1:] - ba

    sg2 = params.sigma_g**2
    sa2 = params.sigma_a**2
    sgw2 = params.sigma_gw**2
    saw2 = params.sigma_aw**2

    class Carry(NamedTuple):
        dq: jax.Array
        dp: jax.Array
        dv: jax.Array
        dp_dbg: jax.Array
        dp_dba: jax.Array
        dv_dbg: jax.Array
        dv_dba: jax.Array
        dq_dbg: jax.Array
        P: jax.Array

    def step(c: Carry, inp):
        dt, w0, w1, f0, f1 = inp
        has = dt > 0.0
        dt = jnp.where(has, dt, 0.0)

        omega = 0.5 * (w0 + w1)
        dq_step = se3.delta_q(omega * dt)
        dq_new = se3.quat_normalize(se3.quat_multiply(c.dq, dq_step))

        C0 = se3.quat_to_matrix(c.dq)
        C1 = se3.quat_to_matrix(dq_new)
        # trapezoidal specific force in S0
        acc_S0 = 0.5 * (C0 @ f0 + C1 @ f1)

        dv_new = c.dv + acc_S0 * dt
        dp_new = c.dp + c.dv * dt + 0.5 * acc_S0 * dt * dt

        # --- bias Jacobians (chained, first-order) ---
        # dC/dbg: rotation error accumulates as dq_dbg' = dq_dbg - C_step^T... use
        # right-Jacobian ≈ I for small steps (reference uses the same first-order
        # chaining):  dtheta_{k+1} = C_step^T dtheta_k - I dt dbg
        C_step = se3.quat_to_matrix(dq_step)
        dq_dbg_new = C_step.T @ c.dq_dbg - jnp.eye(3, dtype=dtype) * dt

        acc_avg = 0.5 * (f0 + f1)
        # d acc_S0 / dtheta(so far) = -C0 [f]x dtheta ; wrt bg via dq_dbg
        dacc_dbg = -C0 @ se3.cross_matrix(acc_avg) @ c.dq_dbg
        dacc_dba = -0.5 * (C0 + C1)

        dv_dbg_new = c.dv_dbg + dacc_dbg * dt
        dv_dba_new = c.dv_dba + dacc_dba * dt
        dp_dbg_new = c.dp_dbg + c.dv_dbg * dt + 0.5 * dacc_dbg * dt * dt
        dp_dba_new = c.dp_dba + c.dv_dba * dt + 0.5 * dacc_dba * dt * dt

        # --- covariance propagation (error state [dp, dalpha, dv, dbg, dba]) ---
        F = jnp.eye(15, dtype=dtype)
        F = F.at[0:3, 6:9].set(jnp.eye(3, dtype=dtype) * dt)
        F = F.at[0:3, 3:6].set(-0.5 * C0 @ se3.cross_matrix(acc_avg) * dt * dt)
        F = F.at[0:3, 12:15].set(0.5 * dacc_dba * dt * dt)
        F = F.at[3:6, 3:6].set(C_step.T)
        F = F.at[3:6, 9:12].set(-jnp.eye(3, dtype=dtype) * dt)
        F = F.at[6:9, 3:6].set(-C0 @ se3.cross_matrix(acc_avg) * dt)
        F = F.at[6:9, 12:15].set(dacc_dba * dt)

        P_new = F @ c.P @ F.T
        # additive noise (continuous -> discrete: sigma^2 * dt)
        dt_safe = jnp.maximum(dt, 1e-12)
        P_new = P_new.at[0:3, 0:3].add(
            jnp.eye(3, dtype=dtype) * (0.25 * sa2 * dt * dt * dt)
        )
        P_new = P_new.at[3:6, 3:6].add(jnp.eye(3, dtype=dtype) * (sg2 * dt))
        P_new = P_new.at[6:9, 6:9].add(jnp.eye(3, dtype=dtype) * (sa2 * dt))
        P_new = P_new.at[9:12, 9:12].add(jnp.eye(3, dtype=dtype) * (sgw2 * dt))
        P_new = P_new.at[12:15, 12:15].add(jnp.eye(3, dtype=dtype) * (saw2 * dt))
        del dt_safe

        new = Carry(
            dq=dq_new, dp=dp_new, dv=dv_new,
            dp_dbg=dp_dbg_new, dp_dba=dp_dba_new,
            dv_dbg=dv_dbg_new, dv_dba=dv_dba_new,
            dq_dbg=dq_dbg_new, P=P_new,
        )
        # no-op where the interval is masked out
        out = jax.tree.map(lambda a, b: jnp.where(has, a, b), new, c)
        return out, None

    init = Carry(
        dq=se3.quat_identity(dtype),
        dp=jnp.zeros(3, dtype),
        dv=jnp.zeros(3, dtype),
        dp_dbg=jnp.zeros((3, 3), dtype),
        dp_dba=jnp.zeros((3, 3), dtype),
        dv_dbg=jnp.zeros((3, 3), dtype),
        dv_dba=jnp.zeros((3, 3), dtype),
        dq_dbg=jnp.zeros((3, 3), dtype),
        P=jnp.zeros((15, 15), dtype),
    )
    carry, _ = jax.lax.scan(step, init, (dts, g0, g1, a0, a1))
    return Preintegrated(
        dq=carry.dq, dp=carry.dp, dv=carry.dv,
        dp_dbg=carry.dp_dbg, dp_dba=carry.dp_dba,
        dv_dbg=carry.dv_dbg, dv_dba=carry.dv_dba,
        dq_dbg=carry.dq_dbg, P=carry.P,
        dt=jnp.sum(dts), lin_bg=bg, lin_ba=ba,
    )


def propagate_state(
    params: ImuParams,
    pre: Preintegrated,
    T_WS0: jax.Array,
    v_W0: jax.Array,
    bg: jax.Array,
    ba: jax.Array,
):
    """Predict (T_WS1, v_W1) from preintegrated quantities, with first-order
    bias correction around the linearisation point.

    (reference: ImuError::propagation, okvis_ceres/src/ImuError.cpp:537.)
    """
    dbg = bg - pre.lin_bg
    dba = ba - pre.lin_ba
    dp = pre.dp + pre.dp_dbg @ dbg + pre.dp_dba @ dba
    dv = pre.dv + pre.dv_dbg @ dbg + pre.dv_dba @ dba
    dq = se3.quat_multiply(pre.dq, se3.delta_q(pre.dq_dbg @ dbg))

    g_W = jnp.array([0.0, 0.0, -params.g], dtype=pre.dp.dtype)
    C_WS0 = se3.quat_to_matrix(se3.se3_q(T_WS0))
    t0 = se3.se3_t(T_WS0)
    dt = pre.dt

    t1 = t0 + v_W0 * dt + 0.5 * g_W * dt * dt + C_WS0 @ dp
    v1 = v_W0 + g_W * dt + C_WS0 @ dv
    q1 = se3.quat_normalize(se3.quat_multiply(se3.se3_q(T_WS0), dq))
    return jnp.concatenate([t1, q1]), v1


def init_pose_from_accel(acc_mean: jax.Array, gyr_mean: jax.Array) -> jax.Array:
    """Gravity-aligned initial pose, yaw = 0 (reference: ImuError::initPose,
    okvis_ceres ImuError.hpp:180): find q such that C(q)^T (-g e_z) matches
    the measured specific force direction."""
    del gyr_mean
    ez_W = jnp.array([0.0, 0.0, 1.0], dtype=acc_mean.dtype)
    ez_S = acc_mean / jnp.maximum(jnp.linalg.norm(acc_mean), 1e-9)
    # rotation taking ez_S (gravity direction in S) to ez_W
    v = jnp.cross(ez_S, ez_W)
    s = jnp.linalg.norm(v)
    c = jnp.dot(ez_S, ez_W)
    angle = jnp.arctan2(s, c)
    axis = jnp.where(s > 1e-9, v / jnp.maximum(s, 1e-12), jnp.array([1.0, 0, 0], acc_mean.dtype))
    q = se3.delta_q(axis * angle)
    return jnp.concatenate([jnp.zeros(3, acc_mean.dtype), q])
