"""Synthetic EuRoC-format dataset generator.

The environment has no network access and no real datasets, so end-to-end
validation renders its own: a 3-D "dot field" scene splatted into images
along an analytic trajectory with analytic IMU, written in EuRoC ASL layout
(mav0/cam{0,1}/data.csv + PNGs, imu0/data.csv, ground-truth csv) so the
EurocDataset reader and the full pipeline are exercised exactly as they
would be on MH_01.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from okvis2x_tpu.core import se3, se3np
import jax.numpy as jnp


def analytic_trajectory(t, g=9.81007):
    """Sinusoidal position + yaw; returns (p_W, q_WS[xyzw], v_W, omega_S,
    f_S) at times t."""
    t = np.asarray(t)
    w1 = 2 * np.pi * 0.12
    amp = np.array([1.2, 0.8, 0.3])
    p = np.stack(
        [amp[0] * np.sin(w1 * t), amp[1] * (1 - np.cos(w1 * t)), amp[2] * np.sin(2 * w1 * t)],
        -1,
    )
    v = np.stack(
        [amp[0] * w1 * np.cos(w1 * t), amp[1] * w1 * np.sin(w1 * t),
         amp[2] * 2 * w1 * np.cos(2 * w1 * t)], -1
    )
    a = np.stack(
        [-amp[0] * w1**2 * np.sin(w1 * t), amp[1] * w1**2 * np.cos(w1 * t),
         -amp[2] * (2 * w1) ** 2 * np.sin(2 * w1 * t)], -1
    )
    yaw_rate = 0.15
    yaw = yaw_rate * t
    n = len(t)
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    C_WS = se3np.quat_to_matrix(q)
    g_W = np.array([0, 0, -g])
    f_S = np.einsum("nji,nj->ni", C_WS, a - g_W)
    omega_S = np.einsum("nji,j->ni", C_WS, np.array([0, 0, yaw_rate]))
    return p, q, v, omega_S, f_S


def circuit_trajectory(t, g=9.81007, radius=8.0, speed=1.1,
                       speed_mod=0.22, z_amp=0.25):
    """Laps of a circle with tangent-following yaw — the reference-scale
    loopy benchmark trajectory (every lap revisits every position and
    heading, forcing loop closures).  Speed modulation + z bob keep
    accelerometer biases observable.  Same contract as
    ``analytic_trajectory``: (p_W, q_WS[xyzw], v_W, omega_S, f_S)."""
    t = np.asarray(t)
    w = speed / radius
    wm = 2 * np.pi * 0.07
    wz = 2 * np.pi * 0.11
    th = w * t + speed_mod * np.sin(wm * t)
    dth = w + speed_mod * wm * np.cos(wm * t)
    ddth = -speed_mod * wm * wm * np.sin(wm * t)
    c, s = np.cos(th), np.sin(th)
    p = np.stack([radius * c, radius * s, z_amp * np.sin(wz * t)], -1)
    v = np.stack(
        [-radius * s * dth, radius * c * dth, z_amp * wz * np.cos(wz * t)], -1
    )
    a = np.stack(
        [-radius * c * dth**2 - radius * s * ddth,
         -radius * s * dth**2 + radius * c * ddth,
         -z_amp * wz**2 * np.sin(wz * t)], -1,
    )
    yaw = th + np.pi / 2
    n = len(t)
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    C_WS = se3np.quat_to_matrix(q)
    g_W = np.array([0, 0, -g])
    f_S = np.einsum("nji,nj->ni", C_WS, a - g_W)
    omega_S = np.stack([np.zeros(n), np.zeros(n), dth], -1)
    return p, q, v, omega_S, f_S


def make_scene(n_points=600, seed=3):
    """Random bright dots in a box around/ahead of the trajectory."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -3, 1.5], [5, 4, 7.0], (n_points, 3))
    # camera optical axis is S-frame +z (identity-rotation extrinsics):
    # keep points in front (z in 1.5..7)
    brightness = rng.uniform(0.35, 1.0, n_points)
    radius = rng.uniform(1.0, 2.2, n_points)
    return pts, brightness, radius


def make_circuit_scene(radius=8.0, density=22.0, seed=3, z_lo=3.5, z_hi=6.5,
                       half_width=4.5, satellites=True, sectors=6):
    """Dot 'ceiling' above the circuit annulus.  Each primary dot carries
    0-2 dimmer satellite dots at fixed 3-D offsets, breaking the rotational
    symmetry of isolated blobs so binary descriptors are distinctive and
    repeat exactly on revisit.

    With `sectors` > 0 the ceiling's appearance STATISTICS vary around the
    circuit (density, brightness and satellite richness modulated by
    angular harmonics) — a statistically uniform dot field is globally
    ambiguous to ANY bag-of-words place recogniser (every view shares the
    same word histogram), which tests nothing; real benchmark scenes have
    sector-distinct appearance."""
    rng = np.random.default_rng(seed)
    area = np.pi * ((radius + half_width) ** 2
                    - max(radius - half_width, 0.0) ** 2)
    n = int(area * density * (1.5 if sectors else 1.0))
    # rejection-free annulus sampling in polar coordinates (area-uniform)
    r_lo2 = max(radius - half_width, 0.0) ** 2
    r_hi2 = (radius + half_width) ** 2
    rr = np.sqrt(rng.uniform(r_lo2, r_hi2, n))
    th = rng.uniform(0, 2 * np.pi, n)
    if sectors:
        # angular appearance modulation: density thinning by harmonics
        w = (0.55 + 0.45 * np.cos(sectors * th / 2.0 + 1.0)
             * np.sin(th + 0.7))
        keep = rng.uniform(0, 1, n) < np.clip(0.35 + 0.65 * w, 0.25, 1.0)
        rr, th = rr[keep], th[keep]
        n = len(rr)
    pts = np.stack(
        [rr * np.cos(th), rr * np.sin(th), rng.uniform(z_lo, z_hi, n)], -1
    )
    brightness = rng.uniform(0.4, 1.0, n)
    rad = rng.uniform(1.0, 2.0, n)
    if sectors:
        # sector-dependent brightness + size profiles
        brightness = np.clip(
            brightness * (0.75 + 0.35 * np.sin(th * 2 + 0.3)), 0.25, 1.0)
        rad = rad * (0.85 + 0.3 * (0.5 + 0.5 * np.cos(th * 3 - 0.5)))
    if satellites:
        if sectors:
            # satellite richness varies around the circuit
            p_sat = np.clip(
                1.0 + 1.8 * (0.5 + 0.5 * np.sin(th * sectors / 3.0)), 0, 3)
            n_sat = rng.poisson(p_sat)
            n_sat = np.minimum(n_sat, 3)
        else:
            n_sat = rng.integers(0, 3, n)
        reps = np.repeat(np.arange(n), n_sat)
        if len(reps):
            off = rng.uniform(-0.16, 0.16, (len(reps), 3))
            off[:, 2] *= 0.3
            spts = pts[reps] + off
            sb = brightness[reps] * rng.uniform(0.35, 0.7, len(reps))
            sr = rng.uniform(0.8, 1.3, len(reps))
            pts = np.concatenate([pts, spts])
            brightness = np.concatenate([brightness, sb])
            rad = np.concatenate([rad, sr])
    return pts, brightness, rad


# ---------------------------------------------------------------------------
# Textured validation world (scene_version 3)
#
# The dot-field renderer above provides ideal, isolated corners — the best
# case for any frontend.  Real benchmark imagery (EuRoC / Hilti / VBR, which
# this container cannot fetch) is hard for the OPPOSITE reasons: texture
# lives on continuous surfaces, geometry occludes, lighting drifts across a
# run, and dynamic objects (people, clouds) offer well-textured but
# geometrically WRONG correspondences.  `make_textured_world` +
# `render_textured` reproduce those failure modes: procedurally textured
# panels with z-buffer occlusion, a bright drifting cloud sky, moving
# textured distractor clusters, and global illumination drift — plus a
# per-pixel class map (static / sky / distractor) that supervises the
# fast-scnn keypoint classifier (≙ the robustness machinery the reference
# carries at okvis_frontend/src/Frontend.cpp:204-256 and the keypoint
# classification at okvis_cv/src/Frame.cpp:33-128).
# ---------------------------------------------------------------------------

CLASS_STATIC = 0
CLASS_SKY = 1
CLASS_DISTRACTOR = 2


def _hash01(i, j, seed):
    """Deterministic [0,1) lattice hash (vectorised)."""
    x = np.sin(i * 127.1 + j * 311.7 + seed * 74.7) * 43758.5453
    return x - np.floor(x)


def _value_noise(u, v, seed, octaves=3, base_scale=1.6):
    """Multi-octave bilinear value noise at plane-local coords (u, v)."""
    out = np.zeros_like(u)
    amp = 1.0
    tot = 0.0
    s = base_scale
    for o in range(octaves):
        uu, vv = u * s, v * s
        i0, j0 = np.floor(uu), np.floor(vv)
        fu, fv = uu - i0, vv - j0
        fu = fu * fu * (3 - 2 * fu)
        fv = fv * fv * (3 - 2 * fv)
        n00 = _hash01(i0, j0, seed + o)
        n10 = _hash01(i0 + 1, j0, seed + o)
        n01 = _hash01(i0, j0 + 1, seed + o)
        n11 = _hash01(i0 + 1, j0 + 1, seed + o)
        out = out + amp * (
            n00 * (1 - fu) * (1 - fv) + n10 * fu * (1 - fv)
            + n01 * (1 - fu) * fv + n11 * fu * fv
        )
        tot += amp
        amp *= 0.55
        s *= 2.1
    return out / tot


def make_textured_world(radius=8.0, seed=3, density=14.0, n_panels=16,
                        n_distractors=5, n_clouds=7, half_width=4.5,
                        z_lo=3.5, z_hi=6.5):
    """World for the circuit trajectory: dot ceiling (sparser than v2) +
    textured ceiling panels + moving distractor clusters + drifting clouds.
    Returns a dict consumed by `render_textured`."""
    rng = np.random.default_rng(seed)
    pts, bright, rad = make_circuit_scene(
        radius=radius, density=density, seed=seed, z_lo=z_lo, z_hi=z_hi,
        half_width=half_width, sectors=6)

    panels = []
    for k in range(n_panels):
        th = 2 * np.pi * k / n_panels + rng.uniform(-0.15, 0.15)
        rr = rng.uniform(radius - 2.5, radius + 2.5)
        origin = np.array([
            rr * np.cos(th), rr * np.sin(th), rng.uniform(z_lo - 0.6, z_hi)
        ])
        # ceiling-facing panels, tilted a little
        n_vec = np.array([rng.uniform(-0.25, 0.25),
                          rng.uniform(-0.25, 0.25), -1.0])
        n_vec /= np.linalg.norm(n_vec)
        eu = np.cross(n_vec, [0.0, 0.0, 1.0])
        if np.linalg.norm(eu) < 1e-6:
            eu = np.array([1.0, 0.0, 0.0])
        eu /= np.linalg.norm(eu)
        ev = np.cross(n_vec, eu)
        panels.append(dict(
            origin=origin, normal=n_vec, eu=eu, ev=ev,
            half_u=rng.uniform(1.2, 2.6), half_v=rng.uniform(1.0, 2.2),
            tex_seed=float(k * 13 + seed), albedo=rng.uniform(0.45, 0.85),
        ))

    distractors = []
    for k in range(n_distractors):
        th = rng.uniform(0, 2 * np.pi)
        rr = rng.uniform(radius - 2.0, radius + 2.0)
        m = rng.integers(6, 14)
        local = rng.uniform(-0.5, 0.5, (m, 3)) * np.array([1.0, 1.0, 0.3])
        distractors.append(dict(
            center0=np.array([rr * np.cos(th), rr * np.sin(th),
                              rng.uniform(z_lo - 1.0, z_lo + 0.5)]),
            # slow smooth wander: amplitude ~1-2 m over tens of seconds —
            # consistent enough to match frame-to-frame, wrong geometrically
            amp=rng.uniform(0.8, 2.0, 3) * np.array([1, 1, 0.3]),
            omega=rng.uniform(0.05, 0.16, 3) * 2 * np.pi,
            phase=rng.uniform(0, 2 * np.pi, 3),
            pts_local=local,
            bright=rng.uniform(0.5, 1.0, m),
            rad=rng.uniform(1.0, 2.0, m),
        ))

    clouds = []
    for k in range(n_clouds):
        d = rng.normal(0, 1, 3)
        d[2] = abs(d[2]) + 1.0  # up
        clouds.append(dict(
            dir0=d / np.linalg.norm(d),
            drift=rng.uniform(-0.012, 0.012, 3),  # direction drift [1/s]
            width=rng.uniform(0.08, 0.2),
            gain=rng.uniform(0.12, 0.3),
        ))
    return dict(pts=pts, bright=bright, rad=rad, panels=panels,
                distractors=distractors, clouds=clouds, seed=seed)


_RAY_CACHE = {}


def _pixel_rays(cam_np):
    """Cached (H, W, 3) unit ray grid in the camera frame (undistorted)."""
    from okvis2x_tpu.cameras import pinhole_np

    key = (cam_np.width, cam_np.height, cam_np.model,
           tuple(np.asarray(cam_np.fxfycxcy).tolist()),
           tuple(np.asarray(cam_np.dist_params).tolist()))
    if key not in _RAY_CACHE:
        H, W = cam_np.height, cam_np.width
        ys, xs = np.mgrid[0:H, 0:W]
        uv = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float64)
        ray, _ = pinhole_np.back_project(cam_np, uv)
        ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
        _RAY_CACHE[key] = ray.reshape(H, W, 3)
    return _RAY_CACHE[key]


def distractor_positions(world, t):
    """World-frame positions of every distractor dot at time t; returns
    (pts (n,3), bright (n,), rad (n,))."""
    ps, bs, rs = [], [], []
    for d in world["distractors"]:
        c = d["center0"] + d["amp"] * np.sin(d["omega"] * t + d["phase"])
        ps.append(c[None] + d["pts_local"])
        bs.append(d["bright"])
        rs.append(d["rad"])
    if not ps:
        return np.zeros((0, 3)), np.zeros(0), np.zeros(0)
    return np.concatenate(ps), np.concatenate(bs), np.concatenate(rs)


def _splat(img, depth_z, cls, cam_np, T_WC, pts, bright, rad, cls_id,
           zbuf=None):
    """Splat dots with z-buffer occlusion against `zbuf` (panel depths)."""
    from okvis2x_tpu.cameras import pinhole_np
    from okvis2x_tpu.core import se3np

    H, W = cam_np.height, cam_np.width
    if len(pts) == 0:
        return
    T_CW = se3np.se3_inverse(np.asarray(T_WC, np.float64))
    p_C = se3np.se3_apply(T_CW, np.asarray(pts, np.float64))
    uv, valid = pinhole_np.project(cam_np, p_C)
    valid = valid & (p_C[:, 2] > 0.3)
    r = 4
    cx = np.round(uv[:, 0]).astype(np.int64)
    cy = np.round(uv[:, 1]).astype(np.int64)
    sel = np.nonzero(
        valid & (cx >= r) & (cx < W - r) & (cy >= r) & (cy < H - r)
    )[0]
    if zbuf is not None and len(sel):
        # occlusion: dot hidden where a panel is nearer at its centre pixel
        vis = p_C[sel, 2] < zbuf[cy[sel], cx[sel]] + 0.05
        sel = sel[vis]
    if len(sel) == 0:
        return
    d = np.arange(-r, r + 1)
    sig = (np.asarray(rad)[sel] * 0.8)[:, None]
    ys = cy[sel, None] + d
    xs = cx[sel, None] + d
    gy = np.exp(-0.5 * ((ys - uv[sel, 1:2]) / sig) ** 2)
    gx = np.exp(-0.5 * ((xs - uv[sel, 0:1]) / sig) ** 2)
    patch = (np.asarray(bright)[sel, None, None]
             * gy[:, :, None] * gx[:, None, :]).astype(np.float32)
    flat = (ys[:, :, None] * W + xs[:, None, :]).ravel()
    np.add.at(img.reshape(-1), flat, patch.ravel())
    if cls is not None:
        strong = patch.ravel() > 0.15
        cls.reshape(-1)[flat[strong]] = cls_id


def render_textured(cam, T_WC, world, t, noise=0.01, seed=0,
                    with_classes=False):
    """Render the textured world at time t; returns img (H, W) float32 in
    [0, 1], or (img, classmap) when with_classes (classmap: CLASS_*)."""
    from okvis2x_tpu.cameras import pinhole_np
    from okvis2x_tpu.core import se3np

    cam_np = cam if isinstance(cam, pinhole_np.NpCamera) else \
        pinhole_np.to_numpy(cam)
    rng = np.random.default_rng(seed)
    H, W = cam_np.height, cam_np.width
    rays_C = _pixel_rays(cam_np)
    T_WC = np.asarray(T_WC, np.float64)
    R_WC = se3np.quat_to_matrix(T_WC[3:7])
    o_W = T_WC[:3]
    dir_W = rays_C @ R_WC.T  # (H, W, 3)

    # --- sky background: smooth gradient + drifting clouds (bright, low
    # frequency — their edges ARE detectable and move; sky weighting is
    # what rejects them)
    img = (0.55 + 0.18 * dir_W[..., 2]).astype(np.float32)
    for c in world["clouds"]:
        d0 = c["dir0"] + c["drift"] * t
        d0 = d0 / np.linalg.norm(d0)
        ang2 = np.sum((dir_W - d0) ** 2, axis=-1)
        img += (c["gain"] * np.exp(-0.5 * ang2 / c["width"] ** 2)
                ).astype(np.float32)
    cls = np.full((H, W), CLASS_SKY, np.uint8) if with_classes else None
    zbuf = np.full((H, W), np.inf, np.float32)

    # --- textured panels with z-buffer
    for p in world["panels"]:
        denom = dir_W @ p["normal"]
        tt = ((p["origin"] - o_W) @ p["normal"]) / np.where(
            np.abs(denom) > 1e-6, denom, 1e-6)
        hit = (np.abs(denom) > 1e-6) & (tt > 0.3) & (tt < 60.0)
        P = o_W + dir_W * tt[..., None]
        rel = P - p["origin"]
        u = rel @ p["eu"]
        v = rel @ p["ev"]
        inside = hit & (np.abs(u) < p["half_u"]) & (np.abs(v) < p["half_v"])
        nearer = inside & (tt < zbuf)
        if not nearer.any():
            continue
        uu, vv = u[nearer], v[nearer]
        tex = _value_noise(uu, vv, p["tex_seed"])
        shade = p["albedo"] * (0.35 + 0.85 * tex)
        # soft edge vignette keeps panel borders from being perfect lines
        edge = (1.0 - 0.5 * np.maximum(
            np.abs(uu) / p["half_u"], np.abs(vv) / p["half_v"]) ** 6)
        img[nearer] = (shade * edge).astype(np.float32)
        zbuf[nearer] = tt[nearer].astype(np.float32)
        if cls is not None:
            cls[nearer] = CLASS_STATIC

    # --- static dots (occluded by panels)
    _splat(img, None, cls, cam_np, T_WC, world["pts"], world["bright"],
           world["rad"], CLASS_STATIC, zbuf=zbuf)
    # --- moving distractor clusters
    dp, db, dr = distractor_positions(world, t)
    _splat(img, None, cls, cam_np, T_WC, dp, db, dr, CLASS_DISTRACTOR,
           zbuf=zbuf)

    # --- illumination drift + sensor noise: slow global gain/bias wander
    gain = 1.0 + 0.14 * np.sin(2 * np.pi * 0.013 * t + 0.8)
    bias = 0.03 * np.sin(2 * np.pi * 0.021 * t)
    img = img * gain + bias
    img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    if with_classes:
        return img, cls
    return img


def render_image(cam, T_WC, pts, brightness, radius, noise=0.01, seed=0):
    """Splat scene dots into an image (vectorised numpy; gaussian blobs +
    noise).  Uses the numpy camera twin — no device round-trips, so long
    reference-scale datasets render in minutes."""
    from okvis2x_tpu.cameras import pinhole_np
    from okvis2x_tpu.core import se3np

    cam_np = cam if isinstance(cam, pinhole_np.NpCamera) else \
        pinhole_np.to_numpy(cam)
    rng = np.random.default_rng(seed)
    H, W = cam_np.height, cam_np.width
    T_CW = se3np.se3_inverse(np.asarray(T_WC, np.float64))
    p_C = se3np.se3_apply(T_CW, np.asarray(pts, np.float64))
    uv, valid = pinhole_np.project(cam_np, p_C)
    valid = valid & (p_C[:, 2] > 0.3)

    img = rng.normal(0.12, noise, (H, W)).astype(np.float32)
    r = 4  # splat half-window
    cx = np.round(uv[:, 0]).astype(np.int64)
    cy = np.round(uv[:, 1]).astype(np.int64)
    sel = np.nonzero(
        valid & (cx >= r) & (cx < W - r) & (cy >= r) & (cy < H - r)
    )[0]
    if len(sel):
        d = np.arange(-r, r + 1)
        sig = (np.asarray(radius)[sel] * 0.8)[:, None]
        ys = cy[sel, None] + d  # (n, 9)
        xs = cx[sel, None] + d
        gy = np.exp(-0.5 * ((ys - uv[sel, 1:2]) / sig) ** 2)
        gx = np.exp(-0.5 * ((xs - uv[sel, 0:1]) / sig) ** 2)
        patch = (np.asarray(brightness)[sel, None, None]
                 * gy[:, :, None] * gx[:, None, :]).astype(np.float32)
        flat = (ys[:, :, None] * W + xs[:, None, :]).ravel()
        np.add.at(img.reshape(-1), flat, patch.ravel())
    return np.clip(img, 0.0, 1.0)


def render_depth(cam, T_WC, pts, r: int = 4):
    """Depth image matching `render_image`'s splats: each dot's splat window
    is filled with its camera-frame z; elsewhere 0 (invalid)."""
    from okvis2x_tpu.cameras import pinhole

    H, W = cam.height, cam.width
    T_CW = se3.se3_inverse(jnp.asarray(T_WC))
    p_C = np.asarray(se3.se3_apply(T_CW, jnp.asarray(pts)))
    uv, valid = pinhole.project(cam, jnp.asarray(p_C))
    uv = np.asarray(uv)
    valid = np.asarray(valid) & (p_C[:, 2] > 0.3)
    depth = np.zeros((H, W), np.float32)
    order = np.argsort(-p_C[:, 2])  # near dots overwrite far ones
    for i in order:
        if not valid[i]:
            continue
        cx, cy = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if not (r <= cx < W - r and r <= cy < H - r):
            continue
        depth[cy - r : cy + r + 1, cx - r : cx + r + 1] = p_C[i, 2]
    return depth


def generate(
    out_dir: str,
    duration: float = 5.0,
    frame_rate: float = 10.0,
    imu_rate: float = 200.0,
    width: int = 320,
    height: int = 240,
    baseline: float = 0.11,
    imu_noise: bool = True,
    n_points: int = 600,
    seed: int = 3,
    with_gps: bool = False,
    with_lidar: bool = False,
    with_depth: bool = False,
    gps_rate: float = 5.0,
    scene_version: int = 2,  # participates in dataset cache keys
    gps_sigma: float = 0.05,
    trajectory: str = "sinusoid",
    fx: float = 280.0,
    density: float = 22.0,
    progress: bool = False,
    traj_kwargs: dict | None = None,
    world: str = "dots",
    world_kwargs: dict | None = None,
    with_classmap: bool = False,
):
    """Write a synthetic stereo-inertial dataset; returns (cam_cfg dict,
    T_SC (2,7), ground truth array [t, p, q]).

    trajectory="circuit" switches to the reference-scale loopy benchmark:
    laps of an 8 m-radius circle under a dot ceiling (every lap revisits
    every viewpoint → loop closures), sized via `density` dots/m²."""
    from okvis2x_tpu.cameras import pinhole
    from okvis2x_tpu.imu.preintegration import ImuParams
    from okvis2x_tpu.io.png import write_png

    imu = ImuParams()
    rng = np.random.default_rng(seed + 1)
    cam = pinhole.make_pinhole(
        fx=fx, fy=fx, cx=width / 2, cy=height / 2,
        width=width, height=height, model="radtan",
        dist_params=[-0.25, 0.06, 1e-4, -1e-4],
    )
    # trajectory shape knobs (adversarial variants: fast rotation via
    # circuit radius/speed — tests/test_adversarial.py)
    tk = dict(traj_kwargs or {})
    if trajectory == "circuit":
        traj = lambda t, g=9.81007: circuit_trajectory(t, g, **tk)
    else:
        traj = analytic_trajectory
    T_SC = np.array(
        [[-baseline / 2, 0, 0, 0, 0, 0, 1.0], [baseline / 2, 0, 0, 0, 0, 0, 1.0]]
    )

    t0_ns = 1_400_000_000_000_000_000
    root = os.path.join(out_dir, "mav0")
    os.makedirs(root, exist_ok=True)

    # IMU
    t_imu = np.arange(0.0, duration, 1.0 / imu_rate)
    _, _, _, omega_S, f_S = traj(t_imu, imu.g)
    if imu_noise:
        f_S = f_S + rng.normal(0, imu.sigma_a * np.sqrt(imu_rate), f_S.shape)
        omega_S = omega_S + rng.normal(0, imu.sigma_g * np.sqrt(imu_rate), omega_S.shape)
    os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i, t in enumerate(t_imu):
            ns = t0_ns + int(round(t * 1e9))
            f.write(
                f"{ns},{omega_S[i,0]},{omega_S[i,1]},{omega_S[i,2]},"
                f"{f_S[i,0]},{f_S[i,1]},{f_S[i,2]}\n"
            )

    # scene + frames
    tex_world = None
    if world == "textured":
        # textured panels + moving distractors + cloud sky (occlusion,
        # lighting drift) — the EuRoC-class validation proxy
        tex_world = make_textured_world(
            radius=tk.get("radius", 8.0), seed=seed, density=density,
            **(world_kwargs or {}))
        pts, bright, radius = (
            tex_world["pts"], tex_world["bright"], tex_world["rad"])
    elif trajectory == "circuit":
        pts, bright, radius = make_circuit_scene(
            radius=tk.get("radius", 8.0),
            density=density, seed=seed,
            sectors=6 if scene_version >= 2 else 0)
    else:
        pts, bright, radius = make_scene(n_points, seed)
    t_frames = np.arange(0.3, duration, 1.0 / frame_rate)
    p, q, v, _, _ = traj(t_frames, imu.g)
    from okvis2x_tpu.cameras import pinhole_np
    from okvis2x_tpu.core import se3np

    cam_np = pinhole_np.to_numpy(cam)
    if with_classmap:
        os.makedirs(os.path.join(root, "seg0", "data"), exist_ok=True)
        seg_csv = open(os.path.join(root, "seg0", "data.csv"), "w")
        seg_csv.write("#timestamp [ns],filename\n")
    for c in range(2):
        os.makedirs(os.path.join(root, f"cam{c}", "data"), exist_ok=True)
        with open(os.path.join(root, f"cam{c}", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, t in enumerate(t_frames):
                ns = t0_ns + int(round(t * 1e9))
                T_WS = np.concatenate([p[i], q[i]])
                T_WC = se3np.se3_multiply(T_WS, T_SC[c])
                if tex_world is not None:
                    out = render_textured(
                        cam_np, T_WC, tex_world, t, seed=i * 2 + c,
                        with_classes=(with_classmap and c == 0),
                    )
                    if with_classmap and c == 0:
                        img, cmap = out
                        write_png(
                            os.path.join(root, "seg0", "data", f"{ns}.png"),
                            cmap,
                        )
                        seg_csv.write(f"{ns},{ns}.png\n")
                    else:
                        img = out
                else:
                    img = render_image(
                        cam_np, T_WC, pts, bright, radius, seed=i * 2 + c
                    )
                name = f"{ns}.png"
                write_png(
                    os.path.join(root, f"cam{c}", "data", name),
                    (img * 255).astype(np.uint8),
                )
                f.write(f"{ns},{name}\n")
                if progress and i % 200 == 0:
                    print(f"  cam{c}: {i}/{len(t_frames)} frames rendered",
                          flush=True)
    if with_classmap:
        seg_csv.close()

    # optional cam0-registered depth stream (depth0/, 16-bit PNG millimetres
    # — the extended-EuRoC layout XDatasetReader consumes)
    if with_depth:
        os.makedirs(os.path.join(root, "depth0", "data"), exist_ok=True)
        with open(os.path.join(root, "depth0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, t in enumerate(t_frames):
                ns = t0_ns + int(round(t * 1e9))
                T_WS = np.concatenate([p[i], q[i]])
                T_WC = np.asarray(
                    se3.se3_multiply(jnp.asarray(T_WS), jnp.asarray(T_SC[0]))
                )
                dimg = render_depth(cam, T_WC, pts)
                name = f"{ns}.png"
                arr = np.clip(dimg * 1000.0, 0, 65535).astype(np.uint16)
                write_png(os.path.join(root, "depth0", "data", name), arr)
                f.write(f"{ns},{name}\n")

    # ground truth
    os.makedirs(os.path.join(root, "state_groundtruth_estimate0"), exist_ok=True)
    with open(
        os.path.join(root, "state_groundtruth_estimate0", "data.csv"), "w"
    ) as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz\n")
        for i, t in enumerate(t_frames):
            ns = t0_ns + int(round(t * 1e9))
            f.write(
                f"{ns},{p[i,0]},{p[i,1]},{p[i,2]},"
                f"{q[i,3]},{q[i,0]},{q[i,1]},{q[i,2]},"
                f"{v[i,0]},{v[i,1]},{v[i,2]},0,0,0,0,0,0\n"
            )
    # optional GNSS stream (cartesian, in a shifted+yawed G frame)
    if with_gps:
        from okvis2x_tpu.io.xdataset import GNSS_LEAP_NS

        t_gps = np.arange(0.05, duration, 1.0 / gps_rate)
        pg, qg, _, _, _ = traj(t_gps)
        yaw_g = 0.4
        Rg = np.array(
            [[np.cos(yaw_g), -np.sin(yaw_g), 0],
             [np.sin(yaw_g), np.cos(yaw_g), 0], [0, 0, 1.0]]
        )
        t_G = np.array([30.0, -12.0, 4.0])
        pos_G = pg @ Rg.T + t_G + rng.normal(0, gps_sigma, (len(t_gps), 3))
        os.makedirs(os.path.join(root, "gps0"), exist_ok=True)
        with open(os.path.join(root, "gps0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],x,y,z,err_x,err_y,err_z\n")
            for i, t in enumerate(t_gps):
                ns = t0_ns + int(round(t * 1e9)) + GNSS_LEAP_NS
                f.write(
                    f"{ns},{pos_G[i,0]},{pos_G[i,1]},{pos_G[i,2]},"
                    f"{gps_sigma},{gps_sigma},{gps_sigma}\n"
                )

    # optional LiDAR stream: rays to the scene dots (point-per-line format)
    if with_lidar:
        os.makedirs(os.path.join(root, "lidar0"), exist_ok=True)
        t_sweep = np.arange(0.3, duration, 0.1)
        with open(os.path.join(root, "lidar0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],x,y,z,intensity\n")
            for ts in t_sweep:
                ps, qs, _, _, _ = traj(np.array([ts]))
                T_WS = np.concatenate([ps[0], qs[0]])
                T_SW = se3np.se3_inverse(T_WS)
                p_S = se3np.se3_apply(T_SW, pts[:120])
                rngs = np.linalg.norm(p_S, axis=-1)
                keep = rngs < 15.0
                for k, pt_S in enumerate(p_S):
                    if not keep[k]:
                        continue
                    ns = t0_ns + int(round((ts + k * 1e-4) * 1e9))
                    f.write(
                        f"{ns},{pt_S[0]:.4f},{pt_S[1]:.4f},{pt_S[2]:.4f},1.0\n"
                    )

    gt = np.concatenate([t_frames[:, None], p, q], axis=1)
    return cam, T_SC, gt
