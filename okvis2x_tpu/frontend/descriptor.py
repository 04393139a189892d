"""BRISK-style binary descriptor, gravity-alignable.

Replaces the reference's brisk `BriskDescriptorExtractor` (48-byte / 384-bit
FBrisk descriptors, see okvis_frontend/include/DBoW2/FBrisk.hpp and
`setExtractionDirection` usage at okvis_frontend/src/Frontend.cpp:233-238).

Design:
  * a fixed sampling pattern of 60 points on concentric rings (generated
    deterministically at import, BRISK-like geometry) is rotated per keypoint
    by the *extraction direction* — supplied from projected gravity like the
    reference, not estimated from the patch;
  * intensities are sampled with bilinear gathers from a per-level smoothed
    pyramid (one vectorised gather per frame, no per-keypoint loops);
  * 384 fixed comparison pairs produce the bits; descriptors are kept both
    bit-packed (N, 12) uint32 for storage and as ±1 bfloat16 (N, 384) for
    matmul Hamming matching (matcher.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

DESC_BITS = 384
DESC_WORDS = DESC_BITS // 32

# ---------------------------------------------------------------------------
# pattern generation (deterministic, BRISK-like ring geometry)
# ---------------------------------------------------------------------------


def _make_pattern():
    rng = np.random.default_rng(42)
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    counts = [1, 10, 14, 15, 20]
    pts = []
    for r, c in zip(radii, counts):
        ang = np.arange(c) / c * 2 * np.pi + (r * 1.7)
        pts.append(np.stack([r * np.cos(ang), r * np.sin(ang)], -1))
    pts = np.concatenate(pts)  # (60, 2)

    # short-distance pairs, BRISK-style (dist < 9.75 at base scale)
    n = len(pts)
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=-1)
    short = np.nonzero(d < 9.75)[0]
    sel = rng.permutation(short)[:DESC_BITS]
    assert len(sel) == DESC_BITS, f"only {len(short)} short pairs"
    return (
        jnp.asarray(pts, jnp.float32),
        jnp.asarray(ii[sel], jnp.int32),
        jnp.asarray(jj[sel], jnp.int32),
    )


PATTERN_PTS, PAIR_A, PAIR_B = _make_pattern()

# constant one-hot pair-selection matrices: instead of selecting columns by
# constant index arrays (vals[:, PAIR_A]), the whole "compare all pairs"
# step is one (60, 384) ±one-hot matmul, vals @ (A - B), followed by a
# sign test (chosen where gathers were slow; untimed against the gather on
# the H100).
_PAIR_DIFF = np.zeros((60, DESC_BITS), np.float32)
_PAIR_DIFF[np.asarray(PAIR_A), np.arange(DESC_BITS)] += 1.0
_PAIR_DIFF[np.asarray(PAIR_B), np.arange(DESC_BITS)] -= 1.0
PAIR_DIFF = jnp.asarray(_PAIR_DIFF)  # (60, 384) float32

# packed-word weights: bits -> uint32 via two exact f32 matmuls (low/high
# 16-bit halves; f32 integers are exact below 2^24)
_W_LO = np.zeros((DESC_BITS, DESC_WORDS), np.float32)
_W_HI = np.zeros((DESC_BITS, DESC_WORDS), np.float32)
for _b in range(DESC_BITS):
    _w, _s = divmod(_b, 32)
    if _s < 16:
        _W_LO[_b, _w] = float(1 << _s)
    else:
        _W_HI[_b, _w] = float(1 << (_s - 16))
PACK_W_LO = jnp.asarray(_W_LO)
PACK_W_HI = jnp.asarray(_W_HI)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def _bilinear(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Bilinear sample img (H, W) at xy (..., 2) in (x, y) pixel coords.

    Flattened 1-D gathers with mode='clip' in place of a 2-D fancy-index
    gather."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    base = y0 * W + x0
    v00 = jnp.take(flat, base, mode="clip")
    v01 = jnp.take(flat, base + 1, mode="clip")
    v10 = jnp.take(flat, base + W, mode="clip")
    v11 = jnp.take(flat, base + W + 1, mode="clip")
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _bilinear_mxu(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Bilinear sampling as two matmul contractions (one-hot
    interpolation weights), for large static sample sets.

    Expresses the bilinear form as ``sum((Y_w @ img) * X_w, -1)`` with
    sparse-as-dense one-hot weight matrices instead of random-position
    gathers, which serialised on the backend this was written for (untimed
    against the gather form on the H100).  xy is (..., 2); returns
    (...)."""
    H, W = img.shape
    shape = xy.shape[:-1]
    xy2 = xy.reshape(-1, 2)
    x = jnp.clip(xy2[:, 0], 0.0, W - 1.001)
    y = jnp.clip(xy2[:, 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0).astype(jnp.float32)
    fy = (y - y0).astype(jnp.float32)
    iy = jax.lax.broadcasted_iota(jnp.int32, (xy2.shape[0], H), 1)
    Yw = jnp.where(iy == y0[:, None], 1.0 - fy[:, None], 0.0) + jnp.where(
        iy == y0[:, None] + 1, fy[:, None], 0.0
    )
    rows = jax.lax.dot_general(
        Yw.astype(jnp.bfloat16), img.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
    )  # (M, W)
    ix = jax.lax.broadcasted_iota(jnp.int32, (xy2.shape[0], W), 1)
    Xw = jnp.where(ix == x0[:, None], 1.0 - fx[:, None], 0.0) + jnp.where(
        ix == x0[:, None] + 1, fx[:, None], 0.0
    )
    vals = (rows * Xw).sum(-1)
    return vals.reshape(shape)


def _smooth(img: jax.Array) -> jax.Array:
    # separable shift-and-add gaussian (see frontend/detector.py::_conv2)
    from okvis2x_tpu.frontend.detector import _gauss5

    return _gauss5(img)


def extract(
    img: jax.Array,
    uv: jax.Array,  # (N, 2) full-res pixel coords
    angle: jax.Array,  # (N,) extraction direction [rad]
    level: jax.Array,  # (N,) int32 pyramid level (scales the pattern)
    valid: jax.Array,  # (N,) bool
):
    """Compute descriptors. Returns (packed (N, 12) uint32, pm1 (N, 384) bf16).

    Invalid keypoints get all-zero packed bits and pm1 rows of 0 (which can
    never be close to a real descriptor under the matmul Hamming metric).
    """
    img = _smooth(img.astype(jnp.float32))

    ca = jnp.cos(angle)
    sa = jnp.sin(angle)
    R = jnp.stack(
        [jnp.stack([ca, -sa], -1), jnp.stack([sa, ca], -1)], -2
    )  # (N, 2, 2)
    scale = (1.0 + level.astype(jnp.float32)) * 1.0  # pattern scale per level
    offsets = jnp.einsum("nij,pj->npi", R, PATTERN_PTS) * scale[:, None, None]
    sample_xy = uv[:, None, :] + offsets  # (N, 60, 2)
    vals = _bilinear_mxu(img, sample_xy)  # (N, 60)

    # all 384 comparisons as one matmul against the constant ±one-hot
    # pair-difference matrix
    diff = jax.lax.dot_general(
        vals, PAIR_DIFF, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, 384) = vals[PAIR_A] - vals[PAIR_B]
    bitsf = (diff > 0).astype(jnp.float32) * valid[:, None].astype(jnp.float32)

    # pack to uint32 words: two exact f32 matmuls (low/high 16-bit halves)
    lo = jax.lax.dot_general(
        bitsf, PACK_W_LO, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    hi = jax.lax.dot_general(
        bitsf, PACK_W_HI, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    packed = lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)

    pm1 = 2.0 * bitsf - valid[:, None].astype(jnp.float32)
    return packed, pm1.astype(jnp.bfloat16)


def unpack_pm1(packed: jax.Array, valid: jax.Array) -> jax.Array:
    """(N, 12) uint32 -> ±1 bf16 (N, 384), zeroed where invalid."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(packed.shape[0], DESC_BITS).astype(jnp.float32)
    pm1 = (2.0 * bits - 1.0) * valid[:, None].astype(jnp.float32)
    return pm1.astype(jnp.bfloat16)


def gravity_angles(
    g_dir_C: jax.Array, n: int
) -> jax.Array:
    """Extraction direction from the gravity direction expressed in the
    camera frame (reference: Frontend.cpp:233-238 projects e_z into the
    image).  Uses the image-plane projection of g; falls back to 0 when g is
    along the optical axis."""
    gx, gy = g_dir_C[0], g_dir_C[1]
    norm = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.where(norm > 1e-6, jnp.arctan2(gy, gx), 0.0)
    return jnp.full((n,), ang, jnp.float32)
