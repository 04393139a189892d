"""Learned correlation-volume stereo network (Unimatch-style, compact).

Structure-parity counterpart of the reference's TorchScript stereo models
(`stereo-indoor-sigma.pt` / `stereo-mix-sigma.pt`, okvis_deep_learning/
CMakeLists.txt:90-150, consumed at Stereo2DepthProcessor.cpp:155-202):
a feature CNN, a correlation cost volume over disparities, 2-D aggregation,
soft-argmin disparity regression and a log-variance head.

Written in flax with bf16-friendly convolutions (channels sized for
matrix units).  Weights are randomly initialised here — the environment has no
network access to fetch pretrained checkpoints — so accuracy-path runs use
models/stereo.census_stereo; this module provides the trainable family and
the exact I/O contract (left, right) -> (disparity, sigma) for when weights
can be loaded via `load_params`.
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


class FeatureNet(nn.Module):
    channels: int = 64

    @nn.compact
    def __call__(self, x):  # (H, W, 1)
        c = self.channels
        x = nn.Conv(c // 2, (3, 3), strides=2)(x)  # /2
        x = nn.relu(x)
        x = nn.Conv(c // 2, (3, 3))(x)
        x = nn.relu(x)
        x = nn.Conv(c, (3, 3), strides=2)(x)  # /4
        x = nn.relu(x)
        x = nn.Conv(c, (3, 3))(x)
        return x  # (H/4, W/4, c)


class AggregationNet(nn.Module):
    channels: int = 32

    @nn.compact
    def __call__(self, vol):  # (H, W, D)
        c = self.channels
        x = nn.Conv(c, (3, 3))(vol)
        x = nn.relu(x)
        x = nn.Conv(c, (3, 3))(x)
        x = nn.relu(x)
        x = nn.Conv(vol.shape[-1], (3, 3))(x)
        return vol + x  # residual refinement of the cost volume


class SigmaHead(nn.Module):
    @nn.compact
    def __call__(self, feats):  # concat of volume stats
        x = nn.Conv(32, (3, 3))(feats)
        x = nn.relu(x)
        x = nn.Conv(1, (3, 3))(x)
        return x[..., 0]  # log sigma_d


class StereoNet(nn.Module):
    """(left, right) grayscale -> (disparity, sigma_d) at full resolution."""

    max_disp: int = 64  # full-resolution disparity range (multiple of 4)
    channels: int = 64

    @nn.compact
    def __call__(self, left: jax.Array, right: jax.Array):
        H, W = left.shape
        fl = FeatureNet(self.channels)(left[..., None])
        fr = FeatureNet(self.channels)(right[..., None])
        d4 = self.max_disp // 4

        # correlation volume at 1/4 res: (H/4, W/4, D/4)
        def corr(d):
            frs = jnp.roll(fr, d, axis=1)
            xs = jax.lax.broadcasted_iota(jnp.int32, frs.shape[:2], 1)
            c = jnp.mean(fl * frs, axis=-1)
            return jnp.where(xs >= d, c, -30.0)

        vol = jnp.stack([corr(d) for d in range(d4)], axis=-1)
        vol = AggregationNet()(vol)

        # soft-argmin disparity
        att = jax.nn.softmax(vol, axis=-1)
        ds = jnp.arange(d4, dtype=left.dtype)
        disp4 = jnp.sum(att * ds, axis=-1)  # (H/4, W/4)
        ent = -jnp.sum(att * jnp.log(jnp.maximum(att, 1e-9)), axis=-1)

        log_sigma4 = SigmaHead()(
            jnp.stack([disp4, ent, jnp.max(vol, axis=-1)], axis=-1)
        )

        # upsample to full res (x4 disparity scaling); log-sigma clipped
        # so a cold random head cannot overflow exp()
        disp = 4.0 * jax.image.resize(disp4, (H, W), "bilinear")
        sigma = jnp.exp(jnp.clip(
            jax.image.resize(log_sigma4, (H, W), "bilinear"), -4.0, 4.0
        )) + 0.1
        return disp, sigma


def init_stereo_net(
    key: jax.Array, height: int, width: int, max_disp: int = 64
) -> Tuple[StereoNet, Any]:
    net = StereoNet(max_disp=max_disp)
    params = net.init(
        key, jnp.zeros((height, width), jnp.float32),
        jnp.zeros((height, width), jnp.float32),
    )
    return net, params


DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(__file__), "..", "resources", "stereo_net.npz"
)


def load_params(path: str = None):
    """Load trained parameters from the flat npz written by
    tools/train_stereo.py (keys are '/'-joined tree paths; __meta_* keys
    carry held-out eval metrics).  Returns (params, meta) or (None, {})
    when no artifact exists (callers fall back to census)."""
    import numpy as np

    path = path or DEFAULT_WEIGHTS
    if not os.path.exists(path):
        return None, {}
    raw = np.load(path)
    params: dict = {}
    meta = {}
    for k in raw.files:
        if k.startswith("__meta_"):
            meta[k[7:]] = float(raw[k])
            continue
        parts = [p for p in k.split("/") if p]
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(raw[k])
    return params, meta
