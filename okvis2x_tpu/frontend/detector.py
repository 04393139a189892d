"""Multi-scale Harris keypoint detection.

JAX replacement for the reference's BRISK/AGAST detector with
Harris-scored uniformity suppression (reference: okvis_frontend/src/
Frontend.cpp:2637 `initialiseBriskFeatureDetectors`, brisk submodule).

Design: everything is dense, static-shape tensor work that XLA fuses:
  * image pyramid by 2x average pooling (`octaves` levels);
  * Harris corner response per level from Sobel structure tensors —
    small static convolutions;
  * 3x3 non-max suppression via max-pooling comparison;
  * spatial uniformity via per-cell top-k (grid cells approximate the
    reference's uniformity-radius suppression) followed by global top-N —
    output is a fixed-capacity keypoint table with validity mask, the
    static-shape contract the rest of the pipeline relies on;
  * quadratic subpixel refinement on the response surface.

Output coordinates are always in level-0 (full-res) pixels; `scale` gives
the pyramid level.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    uv: jax.Array  # (N, 2) float — full-res pixel coords (x, y)
    score: jax.Array  # (N,) Harris response
    level: jax.Array  # (N,) int32 pyramid level
    valid: jax.Array  # (N,) bool


import numpy as _np


def _conv2(img: jax.Array, kernel) -> jax.Array:
    """Same-padding 2D convolution of a (H, W) image by a SMALL STATIC
    kernel, as shift-and-add: statically-weighted shifted adds are pure
    elementwise work that fuses, where a single-channel `lax.conv` lowered
    poorly on the backend this was written for (untimed against `lax.conv`
    on the H100)."""
    k = _np.asarray(kernel, _np.float64)
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    H, W = img.shape
    p = jnp.pad(img, ((ph, ph), (pw, pw)))
    out = None
    for dy in range(kh):
        for dx in range(kw):
            w = float(k[dy, dx])  # lax.conv semantics = cross-correlation
            if w == 0.0:
                continue
            term = p[dy:dy + H, dx:dx + W] * w
            out = term if out is None else out + term
    return out


def _sep_conv(img: jax.Array, taps) -> jax.Array:
    """Separable same-padding convolution (symmetric 1D taps)."""
    taps = [float(t) for t in taps]
    r = len(taps) // 2
    H, W = img.shape
    p = jnp.pad(img, ((0, 0), (r, r)))
    out = None
    for d, w in enumerate(taps):
        term = p[:, d:d + W] * w
        out = term if out is None else out + term
    p = jnp.pad(out, ((r, r), (0, 0)))
    out = None
    for d, w in enumerate(taps):
        term = p[d:d + H, :] * w
        out = term if out is None else out + term
    return out


def _box3(img: jax.Array) -> jax.Array:
    return _sep_conv(img, [1 / 3] * 3)


_G5 = (_np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0).tolist()


def _gauss5(img: jax.Array) -> jax.Array:
    return _sep_conv(img, _G5)


def harris_response(img: jax.Array, k: float = 0.04) -> jax.Array:
    """Harris corner response (img float in [0,1], shape (H, W))."""
    sx = _np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8.0
    ix = _conv2(img, sx)
    iy = _conv2(img, sx.T)
    ixx = _gauss5(ix * ix)
    iyy = _gauss5(iy * iy)
    ixy = _gauss5(ix * iy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _nms3(resp: jax.Array) -> jax.Array:
    """Zero out non-maxima in each 3x3 neighbourhood (shifted maxes —
    same rationale as _conv2: elementwise beats windowed ops here)."""
    H, W = resp.shape
    p = jnp.pad(resp, 1, constant_values=-jnp.inf)
    mx = resp
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            mx = jnp.maximum(mx, p[dy:dy + H, dx:dx + W])
    return jnp.where(resp >= mx, resp, jnp.zeros_like(resp))


def _downsample2(img: jax.Array) -> jax.Array:
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def _subpixel_offsets(resp: jax.Array, ys: jax.Array, xs: jax.Array):
    """Quadratic 1D fits in x and y around integer maxima."""

    flat = resp.reshape(-1)
    W = resp.shape[1]

    def grab(dy, dx):
        idx = (
            jnp.clip(ys + dy, 0, resp.shape[0] - 1) * W
            + jnp.clip(xs + dx, 0, resp.shape[1] - 1)
        )
        return jnp.take(flat, idx, mode="clip")

    c = grab(0, 0)
    denom_x = grab(0, -1) - 2 * c + grab(0, 1)
    denom_y = grab(-1, 0) - 2 * c + grab(1, 0)
    dx = jnp.where(
        jnp.abs(denom_x) > 1e-12, 0.5 * (grab(0, -1) - grab(0, 1)) / jnp.where(jnp.abs(denom_x) > 1e-12, denom_x, 1.0), 0.0
    )
    dy = jnp.where(
        jnp.abs(denom_y) > 1e-12, 0.5 * (grab(-1, 0) - grab(1, 0)) / jnp.where(jnp.abs(denom_y) > 1e-12, denom_y, 1.0), 0.0
    )
    return jnp.clip(dx, -0.5, 0.5), jnp.clip(dy, -0.5, 0.5)


def detect(
    img: jax.Array,
    max_keypoints: int = 768,
    octaves: int = 3,
    cell: int = 32,
    per_cell: int = 8,
    threshold: float = 1e-7,
    border: int = 20,
) -> Keypoints:
    """Detect up to `max_keypoints` multi-scale Harris corners.

    `threshold` is the absolute Harris response floor (the analogue of the
    reference's absoluteThreshold, okvis2.yaml `detection_threshold`).
    """
    img = img.astype(jnp.float32)
    H, W = img.shape

    all_uv = []
    all_score = []
    all_level = []
    level_img = img
    for lvl in range(octaves):
        resp = _nms3(harris_response(level_img))
        h, w = resp.shape
        # mask borders
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        b = max(border // (1 << lvl), 3)
        inb = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
        resp = jnp.where(inb, resp, 0.0)

        # spatial uniformity: top-1 per fine cell (a reduce, not a sort
        # over all cell windows).  Fine cells of cell/ceil(sqrt(per_cell))
        # keep roughly the
        # same per-area keypoint budget as the old per-cell top-k.
        cf = max(int(cell / max(np_ceil_sqrt(per_cell), 1)), 4)
        ch, cw = h // cf, w // cf
        cells = resp[: ch * cf, : cw * cf].reshape(ch, cf, cw, cf)
        cells = cells.transpose(0, 2, 1, 3).reshape(ch * cw, cf * cf)
        best = jnp.argmax(cells, axis=1)  # (ncells,)
        scores = cells.max(axis=1)
        cy = best // cf
        cx = best % cf
        base_y = jnp.arange(ch * cw, dtype=jnp.int32) // cw * cf
        base_x = jnp.arange(ch * cw, dtype=jnp.int32) % cw * cf
        pys = base_y + cy
        pxs = base_x + cx

        dx, dy = _subpixel_offsets(resp, pys, pxs)
        scale = jnp.float32(1 << lvl)
        uv = jnp.stack(
            [(pxs.astype(jnp.float32) + dx) * scale + (scale - 1) * 0.5,
             (pys.astype(jnp.float32) + dy) * scale + (scale - 1) * 0.5],
            axis=-1,
        )
        all_uv.append(uv)
        all_score.append(scores)
        all_level.append(jnp.full(scores.shape, lvl, jnp.int32))
        if lvl + 1 < octaves:
            level_img = _downsample2(level_img)

    uv = jnp.concatenate(all_uv)
    score = jnp.concatenate(all_score)
    level = jnp.concatenate(all_level)

    n = min(max_keypoints, score.shape[0])
    top_scores, top_idx = jax.lax.top_k(score, n)
    uv = jnp.stack(
        [jnp.take(uv[:, 0], top_idx), jnp.take(uv[:, 1], top_idx)], -1
    )
    level = jnp.take(level, top_idx)
    valid = top_scores > threshold
    if n < max_keypoints:
        pad = max_keypoints - n
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), uv.dtype)])
        top_scores = jnp.concatenate([top_scores, jnp.zeros((pad,), score.dtype)])
        level = jnp.concatenate([level, jnp.zeros((pad,), jnp.int32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return Keypoints(uv=uv, score=top_scores, level=level, valid=valid)


def np_ceil_sqrt(x: int) -> int:
    import math

    return int(math.ceil(math.sqrt(max(x, 1))))
