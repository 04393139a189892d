"""Plane-sweep multi-view-stereo depth with uncertainty.

Fills the role of the reference's MVS fusion network (SimpleRecon-style
TorchScript model, okvis_deep_learning/src/DepthFusionProcessor.cpp:78-497):
given the current (reference) frame, N source frames with known relative
poses and intrinsics, produce depth + sigma for the reference frame, to be
inverse-variance-fused with the stereo prediction (models/stereo.fuse_depths).

Engine: classical plane-sweep — warp each source image to the reference view
at D fronto-parallel depth hypotheses via the homography
    H(d) = K (R - t n^T / d) K^-1,
score photometric cost (box-aggregated absolute difference on normalised
images), average over sources, soft-argmin depth + curvature sigma.  All
static-shape: one (D, H, W) volume per source, gathers for the warps —
training-free.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


class MvsDepth(NamedTuple):
    depth: jax.Array  # (H, W)
    sigma: jax.Array  # (H, W)
    valid: jax.Array  # (H, W)


def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array):
    H, W = img.shape
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    return v, inb


def _box(img, r=2):
    k = jnp.ones((2 * r + 1, 2 * r + 1), img.dtype) / (2 * r + 1) ** 2
    return jax.lax.conv_general_dilated(
        img[None, None], k[None, None], (1, 1), "SAME"
    )[0, 0]


def _normalise(img):
    m = _box(img, 3)
    v = _box(img * img, 3) - m * m
    return (img - m) / jnp.sqrt(jnp.maximum(v, 1e-6))


def plane_sweep(
    ref: jax.Array,  # (H, W) reference image
    srcs: jax.Array,  # (S, H, W) source images
    K: jax.Array,  # (3, 3) intrinsics (shared)
    T_ref_src: jax.Array,  # (S, 7) pose of each source in the ref camera frame
    min_depth: float = 0.5,
    max_depth: float = 20.0,
    num_depths: int = 48,
) -> MvsDepth:
    H, W = ref.shape
    S = srcs.shape[0]
    dtype = ref.dtype

    refn = _normalise(ref)
    srcn = jax.vmap(_normalise)(srcs)

    # inverse-depth spaced hypotheses
    inv_d = jnp.linspace(1.0 / max_depth, 1.0 / min_depth, num_depths, dtype=dtype)
    depths = 1.0 / inv_d

    Kinv = jnp.linalg.inv(K)
    ys = jax.lax.broadcasted_iota(dtype, (H, W), 0)
    xs = jax.lax.broadcasted_iota(dtype, (H, W), 1)
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=-1)  # (H, W, 3)
    rays = pix @ Kinv.T  # (H, W, 3) rays in ref camera

    # T_src_ref: ref-cam point -> src-cam point
    T_src_ref = jax.vmap(se3.se3_inverse)(T_ref_src)
    R_sr = jax.vmap(lambda T: se3.quat_to_matrix(se3.se3_q(T)))(T_src_ref)
    t_sr = T_src_ref[:, :3]

    def cost_for_depth(d):
        p_ref = rays * d  # (H, W, 3)
        acc = jnp.zeros((H, W), dtype)
        cnt = jnp.zeros((H, W), dtype)
        for s in range(S):
            p_src = p_ref @ R_sr[s].T + t_sr[s]
            z = p_src[..., 2]
            uvw = p_src @ K.T
            u = uvw[..., 0] / jnp.maximum(uvw[..., 2], 1e-6)
            v = uvw[..., 1] / jnp.maximum(uvw[..., 2], 1e-6)
            val, inb = _bilinear(srcn[s], u, v)
            ok = inb & (z > 1e-3)
            c = jnp.abs(val - refn)
            acc = acc + jnp.where(ok, c, 0.0)
            cnt = cnt + ok.astype(dtype)
        return jnp.where(cnt > 0, acc / jnp.maximum(cnt, 1.0), 10.0), cnt > 0

    costs = []
    covs = []
    for i in range(num_depths):
        c, cov = cost_for_depth(depths[i])
        costs.append(_box(c, 2))
        covs.append(cov)
    vol = jnp.stack(costs)  # (D, H, W)
    any_cov = jnp.stack(covs).any(axis=0)

    best = jnp.argmin(vol, axis=0)
    d0 = jnp.clip(best, 1, num_depths - 2)
    take = lambda dd: jnp.take_along_axis(vol, dd[None], axis=0)[0]
    cm, cc, cp = take(d0 - 1), take(d0), take(d0 + 1)
    denom = cm - 2 * cc + cp
    offs = jnp.where(
        jnp.abs(denom) > 1e-6,
        0.5 * (cm - cp) / jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0),
        0.0,
    )
    idx = best.astype(dtype) + jnp.clip(offs, -0.5, 0.5)
    # interpolate in inverse depth
    i0 = jnp.clip(jnp.floor(idx).astype(jnp.int32), 0, num_depths - 2)
    fi = idx - i0
    inv = inv_d[i0] * (1 - fi) + inv_d[i0 + 1] * fi
    depth = 1.0 / jnp.maximum(inv, 1e-6)

    # sigma from curvature in inverse-depth units, propagated to depth
    step = (inv_d[1] - inv_d[0])
    sigma_inv = jnp.clip(0.7 / jnp.sqrt(jnp.maximum(denom, 1e-4)), 0.3, 4.0) * step
    sigma = sigma_inv * depth * depth

    valid = (
        any_cov & (cc < 0.8) & (best > 0) & (best < num_depths - 1)
    )
    return MvsDepth(
        depth=jnp.where(valid, depth, 0.0),
        sigma=jnp.where(valid, sigma, jnp.inf),
        valid=valid,
    )


_NET = None  # (net, params, meta) | False after an artifact miss


def _trained_net(n_sources: int):
    """Lazy-load the trained MvsNet artifact shipped under resources/
    (tools/train_mvs.py); None when absent or source-count mismatched."""
    global _NET
    if _NET is None:
        from okvis2x_tpu.models import mvs_net

        params, meta = mvs_net.load_params()
        if params is None:
            _NET = False
        else:
            _NET = (
                mvs_net.MvsNet(n_depths=int(meta.get("n_depths", 32))),
                params, meta,
            )
    if not _NET:
        return None
    _, _, meta = _NET
    if int(meta.get("n_src", n_sources)) != n_sources:
        return None
    return _NET


def mvs_depth(
    ref: jax.Array,  # (H, W)
    srcs: jax.Array,  # (S, H, W)
    K: jax.Array,  # (3, 3)
    T_ref_src: jax.Array,  # (S, 7) pose of each source in the ref cam frame
    engine: str = "auto",
    min_depth: float = 0.5,
    max_depth: float = 20.0,
    num_depths: int = 48,
) -> MvsDepth:
    """Multi-view depth + sigma with engine dispatch (≙ the reference
    defaulting to its TorchScript SimpleRecon model,
    okvis_deep_learning/src/DepthFusionProcessor.cpp:78-497): 'auto' uses
    the trained MvsNet when the shipped artifact's held-out RMSE beats the
    classical plane sweep; 'net' demands the artifact; 'classical' never
    loads it."""
    net = _trained_net(int(srcs.shape[0])) if engine in ("auto", "net") \
        else None
    if engine == "net" and net is None:
        raise FileNotFoundError(
            "engine='net' requested but no trained MVS artifact exists "
            "(run tools/train_mvs.py to produce resources/mvs_net.npz)"
        )
    if net is not None and engine == "auto":
        _, _, meta = net
        if meta.get("rmse_net", jnp.inf) >= meta.get("rmse_plane_sweep",
                                                     0.0):
            net = None
    if net is not None:
        mod, params, _ = net
        fxfycxcy = jnp.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        # net contract: T_sr = homogeneous ref-cam -> src-cam transforms
        T_sr7 = jax.vmap(se3.se3_inverse)(T_ref_src)
        R = jax.vmap(lambda T: se3.quat_to_matrix(se3.se3_q(T)))(T_sr7)
        M = (
            jnp.tile(jnp.eye(4, dtype=ref.dtype), (srcs.shape[0], 1, 1))
            .at[:, :3, :3].set(R)
            .at[:, :3, 3].set(T_sr7[:, :3])
        )
        depth, sigma = mod.apply(params, ref, srcs, fxfycxcy, M)
        valid = (depth > mod.d_min + 1e-3) & (depth < mod.d_max - 1e-3)
        return MvsDepth(
            depth=jnp.where(valid, depth, 0.0),
            sigma=jnp.where(valid, sigma, jnp.inf),
            valid=valid,
        )
    return plane_sweep(ref, srcs, K, T_ref_src, min_depth=min_depth,
                       max_depth=max_depth, num_depths=num_depths)
