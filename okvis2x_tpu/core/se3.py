"""SE(3) / quaternion math for the estimator.

Functional replacement for the reference's `okvis::kinematics::Transformation`
(reference: okvis_kinematics/include/okvis/kinematics/Transformation.hpp:208-231,
operators.hpp:97).  Behavioural contract kept:

  * quaternions stored ``[x, y, z, w]`` (Eigen layout), Hamilton product;
  * a transformation is a length-7 array ``[t(3), q(4)]`` mapping points from
    the "child" frame into the "parent" frame: ``p_parent = C(q) p_child + t``;
  * the minimal 6-dof increment is ``delta = [dt(3), dalpha(3)]`` applied as
    ``t <- t + dt``, ``q <- deltaQ(dalpha) * q``  (translation additive,
    rotation perturbed on the left, i.e. in the parent frame) — this mirrors
    `Transformation::oplus` so that Jacobian conventions match the reference's
    factor formulations.

Everything is shape-polymorphic over leading batch dimensions and written for
`jax.vmap`/`jax.jit`; Jacobians of factors are obtained by autodiff through
`retract`, so only the retraction itself (plus a few closed forms used in
preintegration) is hand-written.  All formulas are standard Lie-group /
quaternion identities implemented from scratch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# quaternion primitives  (layout [x, y, z, w], Hamilton convention)
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_multiply(p: jax.Array, q: jax.Array) -> jax.Array:
    """Hamilton product p ⊗ q, both [x,y,z,w]."""
    px, py, pz, pw = jnp.moveaxis(p, -1, 0)
    qx, qy, qz, qw = jnp.moveaxis(q, -1, 0)
    return jnp.stack(
        [
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
            pw * qw - px * qx - py * qy - pz * qz,
        ],
        axis=-1,
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v by quaternion q: C(q) v.

    Uses the expanded Rodrigues form (2 cross products) — cheaper than building
    the rotation matrix for single vectors; for large batches against one q,
    prefer ``quat_to_matrix(q) @ v``.
    """
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Rotation matrix C(q), shape (..., 3, 3)."""
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion [x,y,z,w], branch-free (Shepperd's method
    expressed with jnp.where so it jits without branches)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate solutions, each numerically good in its own region
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    sw = safe_sqrt(1.0 + tr)            # 2*sqrt term for w-dominant
    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    sz = safe_sqrt(1.0 - m00 - m11 + m22)

    qw_w = jnp.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw),
                      (m10 - m01) / (2 * sw), sw / 2], axis=-1)
    qx_w = jnp.stack([sx / 2, (m01 + m10) / (2 * sx),
                      (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], axis=-1)
    qy_w = jnp.stack([(m01 + m10) / (2 * sy), sy / 2,
                      (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], axis=-1)
    qz_w = jnp.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz),
                      sz / 2, (m10 - m01) / (2 * sz)], axis=-1)

    cond_w = tr > 0.0
    cond_x = (m00 > m11) & (m00 > m22)
    cond_y = m11 > m22
    q = jnp.where(
        cond_w[..., None], qw_w,
        jnp.where(cond_x[..., None], qx_w, jnp.where(cond_y[..., None], qy_w, qz_w)),
    )
    return quat_normalize(q)


def delta_q(dalpha: jax.Array) -> jax.Array:
    """Exact exponential of a small rotation vector as a quaternion.

    Matches the reference's `deltaQ` (Transformation.hpp:39): half-angle with a
    Taylor-safe sinc.  q = [sinc(|a|/2) * a/2, cos(|a|/2)].
    """
    half = 0.5 * dalpha
    theta2 = jnp.sum(half * half, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    sinc = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    cos = jnp.where(small[..., 0], 1.0 - theta2[..., 0] / 2.0, jnp.cos(theta[..., 0]))
    return jnp.concatenate([sinc * half, cos[..., None]], axis=-1)


def quat_log(q: jax.Array) -> jax.Array:
    """Rotation vector of a unit quaternion (inverse of delta_q)."""
    qv = q[..., :3]
    qw = q[..., 3]
    # enforce positive real part (shortest arc)
    sign = jnp.where(qw < 0, -1.0, 1.0)
    qv = qv * sign[..., None]
    qw = qw * sign
    n = jnp.linalg.norm(qv, axis=-1)
    angle = 2.0 * jnp.arctan2(n, qw)
    small = n < 1e-8
    scale = jnp.where(small, 2.0 / jnp.maximum(qw, 1e-12), angle / jnp.maximum(n, 1e-24))
    return qv * scale[..., None]


def cross_matrix(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [v]_x (reference: operators.hpp crossMx)."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3) as a 7-vector [t, q]
# ---------------------------------------------------------------------------

TANGENT_DIM = 6
PARAM_DIM = 7


def se3_identity(dtype=jnp.float32) -> jax.Array:
    # precision is a PARAMETER: a float64 request on an x64-disabled
    # backend resolves to the best available dtype once and silently,
    # instead of warning at every call site
    return jnp.array(
        [0, 0, 0, 0, 0, 0, 1], dtype=jax.dtypes.canonicalize_dtype(dtype)
    )


def se3_from_tq(t: jax.Array, q: jax.Array) -> jax.Array:
    return jnp.concatenate([t, quat_normalize(q)], axis=-1)


def se3_t(T: jax.Array) -> jax.Array:
    return T[..., :3]


def se3_q(T: jax.Array) -> jax.Array:
    return T[..., 3:7]


def se3_rotation(T: jax.Array) -> jax.Array:
    return quat_to_matrix(se3_q(T))


def se3_matrix(T: jax.Array) -> jax.Array:
    """Homogeneous 4x4 matrix."""
    C = se3_rotation(T)
    t = se3_t(T)[..., None]
    top = jnp.concatenate([C, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0, 0, 0, 1], dtype=T.dtype), T.shape[:-1] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_multiply(Ta: jax.Array, Tb: jax.Array) -> jax.Array:
    """Composition: (Ta * Tb) p = Ta (Tb p)."""
    t = se3_t(Ta) + quat_rotate(se3_q(Ta), se3_t(Tb))
    q = quat_normalize(quat_multiply(se3_q(Ta), se3_q(Tb)))
    return jnp.concatenate([t, q], axis=-1)


def se3_inverse(T: jax.Array) -> jax.Array:
    qinv = quat_conjugate(se3_q(T))
    t = -quat_rotate(qinv, se3_t(T))
    return jnp.concatenate([t, qinv], axis=-1)


def se3_apply(T: jax.Array, p: jax.Array) -> jax.Array:
    """Transform 3D point(s): C(q) p + t."""
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_apply_homogeneous(T: jax.Array, hp: jax.Array) -> jax.Array:
    """Transform homogeneous 4-vector(s): [C p3 + w t, w]."""
    p3 = hp[..., :3]
    w = hp[..., 3:4]
    return jnp.concatenate([quat_rotate(se3_q(T), p3) + w * se3_t(T), w], axis=-1)


def retract(T: jax.Array, delta: jax.Array) -> jax.Array:
    """OKVIS-style boxplus: t += dt; q <- deltaQ(dalpha) * q.

    (reference semantics: Transformation.hpp:208 `oplus`).  This is the single
    point factors differentiate through, so its autodiff Jacobian *is* the
    minimal Jacobian of the reference's `oplusJacobian` chain.
    """
    t = se3_t(T) + delta[..., :3]
    q = quat_normalize(quat_multiply(delta_q(delta[..., 3:6]), se3_q(T)))
    return jnp.concatenate([t, q], axis=-1)


def local_delta(T_ref: jax.Array, T: jax.Array) -> jax.Array:
    """Inverse of `retract`: minimal 6-vector delta with retract(T_ref, delta) ≈ T.

    dt = t - t_ref;  dalpha = log(q * q_ref^-1).
    """
    dt = se3_t(T) - se3_t(T_ref)
    dq = quat_multiply(se3_q(T), quat_conjugate(se3_q(T_ref)))
    return jnp.concatenate([dt, quat_log(dq)], axis=-1)


def se3_interpolate(Ta: jax.Array, Tb: jax.Array, alpha) -> jax.Array:
    """Geodesic interpolation between two poses (t lerp, q slerp via log)."""
    d = local_delta(Ta, Tb)
    return retract(Ta, alpha * d)


# ---------------------------------------------------------------------------
# Batch helpers (struct-of-arrays pose tables)
# ---------------------------------------------------------------------------


def normalize(T: jax.Array) -> jax.Array:
    """Re-normalise the quaternion part (periodic numerical hygiene)."""
    return jnp.concatenate([se3_t(T), quat_normalize(se3_q(T))], axis=-1)


def random_se3(key: jax.Array, batch_shape=(), dtype=jnp.float32) -> jax.Array:
    """Uniformly random rotation + N(0,1) translation (for tests)."""
    k1, k2 = jax.random.split(key)
    q = quat_normalize(jax.random.normal(k1, batch_shape + (4,), dtype))
    t = jax.random.normal(k2, batch_shape + (3,), dtype)
    return jnp.concatenate([t, q], axis=-1)
