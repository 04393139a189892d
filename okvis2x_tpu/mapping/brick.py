"""Brick-sparse occupancy submaps: fine-resolution grids on a brick pool.

The dense grid in `mapping/submap.py` caps out around 256^3 voxels — the
reference's 25.6 m submap at 0.025 m (config/euroc/se2.yaml:30-32) needs
1024^3, which is 8 GB dense.  supereight2 solves this with a multi-res
octree (integration at okvis_multisensor_processing/src/
SubmappingInterface.cpp:771-902, block allocation in se::MapIntegrator);
the JAX equivalent is a two-level structure built entirely from
gathers/scatters:

  * a dense **brick table** (T^3 int32, T = dim/brick): brick coord ->
    pool slot, -1 = unallocated (occupancy log-odds 0 everywhere there);
  * a flat **brick pool** ((P*b^3 + 1,) float32): all allocated bricks'
    voxels contiguously, one trailing trash voxel absorbing out-of-pool
    scatters.

Allocation is ON DEVICE, inside the integration program: scatter the
touched-brick mask, prefix-sum the newly needed bricks, and write their
slots into the table — no host round trip, so steady-state integration
stays a single async dispatch.  Interpolation/gradient fetch voxels with
two chained gathers (table, then pool); unallocated bricks read as 0.0,
which reproduces supereight's unknown-space mean occupancy.

Voxel/world conventions (centred grid, `_world_to_voxel`) are shared with
the dense module so the ICP factor and the submapping interface work on
either representation through the dispatching wrappers in
`mapping/submap.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from okvis2x_tpu.core import se3


class BrickConfig(NamedTuple):
    table_dim: int = 128  # bricks per side (dim = table_dim * brick)
    brick: int = 8  # voxels per brick side
    res: float = 0.025  # metres per voxel
    pool_bricks: int = 8192  # allocated brick capacity
    log_odd_occ: float = 0.85
    log_odd_free: float = -0.25
    log_odd_min: float = -5.0
    log_odd_max: float = 5.0
    surface_band: float = 0.3
    samples_per_ray: int = 48
    band_samples: int = 8

    @property
    def dim(self) -> int:
        return self.table_dim * self.brick

    @property
    def b3(self) -> int:
        return self.brick ** 3


class BrickSubmap(NamedTuple):
    T_WK: jax.Array  # (7,) anchor pose — re-anchored on loop closure
    table: jax.Array  # (T^3,) int32: brick -> pool slot, -1 unallocated
    brick_xyz: jax.Array  # (P, 3) int32 brick coords per slot (for export)
    pool_lo: jax.Array  # (P*b^3 + 1,) log-odds; [-1] is the trash voxel
    pool_w: jax.Array  # (P*b^3 + 1,) integration weight
    n_alloc: jax.Array  # () int32 allocated brick count


def new_submap(T_WK, cfg: BrickConfig, dtype=jnp.float32) -> BrickSubmap:
    T3 = cfg.table_dim ** 3
    P = cfg.pool_bricks
    return BrickSubmap(
        T_WK=jnp.asarray(T_WK, dtype),
        table=jnp.full((T3,), -1, jnp.int32),
        brick_xyz=jnp.zeros((P, 3), jnp.int32),
        pool_lo=jnp.zeros((P * cfg.b3 + 1,), dtype),
        pool_w=jnp.zeros((P * cfg.b3 + 1,), dtype),
        n_alloc=jnp.zeros((), jnp.int32),
    )


def _table_flat(cfg: BrickConfig, bc: jax.Array) -> jax.Array:
    T = cfg.table_dim
    return (bc[..., 0] * T + bc[..., 1]) * T + bc[..., 2]


def _pool_flat(cfg: BrickConfig, slot: jax.Array, inner: jax.Array) -> jax.Array:
    b = cfg.brick
    innerf = (inner[..., 0] * b + inner[..., 1]) * b + inner[..., 2]
    return slot * cfg.b3 + innerf


def _fetch(sm: BrickSubmap, cfg: BrickConfig, vi: jax.Array) -> jax.Array:
    """Log-odds at integer voxel coords (..., 3) (in-bounds assumed);
    unallocated bricks read 0 (unknown)."""
    bc = vi // cfg.brick
    inner = vi - bc * cfg.brick
    slot = sm.table[_table_flat(cfg, bc)]
    flat = _pool_flat(cfg, jnp.maximum(slot, 0), inner)
    return jnp.where(slot >= 0, sm.pool_lo[flat], 0.0)


def _fetch_weight(sm: BrickSubmap, cfg: BrickConfig, vi: jax.Array) -> jax.Array:
    bc = vi // cfg.brick
    inner = vi - bc * cfg.brick
    slot = sm.table[_table_flat(cfg, bc)]
    flat = _pool_flat(cfg, jnp.maximum(slot, 0), inner)
    return jnp.where(slot >= 0, sm.pool_w[flat], 0.0)


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------


def _scatter_updates(
    sm: BrickSubmap,
    cfg: BrickConfig,
    pts_K: jax.Array,  # (..., 3) metric sample points in submap frame
    upd: jax.Array,  # (...) log-odds deltas
    ok: jax.Array,  # (...) validity
    reduce=None,  # cross-device all-reduce (e.g. lax.psum) for sharded rays
    compact_cap: int | None = None,  # sparse-reduction touched-brick cap
) -> BrickSubmap:
    """Allocate touched bricks (device-side prefix-sum allocation) and
    scatter-add the updates into the pool.

    With `reduce` (parallel/dist_submap.py passes `lax.psum` under a
    shard_map), each device scatters only ITS ray shard and the touched
    mask + update accumulators are all-reduced over ICI before the
    (replicated, deterministic) allocation and mean-update — every device
    ends with an identical submap (≙ BASELINE "submaps sharded across N
    hosts": ray work scales, state stays consistent)."""
    sharded = reduce is not None
    if reduce is None:
        reduce = lambda x: x
    from okvis2x_tpu.mapping.submap import _in_bounds, _world_to_voxel

    v = _world_to_voxel(cfg, pts_K)
    ok = ok & _in_bounds(cfg, v)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, cfg.dim - 1)
    bc = vi // cfg.brick
    tflat = _table_flat(cfg, bc).reshape(-1)
    okf = ok.reshape(-1)

    # --- allocation: mark touched bricks, assign pool slots by prefix sum
    T3 = cfg.table_dim ** 3
    touched = (
        reduce(
            jnp.zeros((T3,), jnp.int32)
            .at[tflat]
            .add(okf.astype(jnp.int32), mode="drop")
        )
        > 0
    )
    need = touched & (sm.table < 0)
    order = jnp.cumsum(need.astype(jnp.int32))
    new_slot = sm.n_alloc + order - 1  # slot for each needed brick
    can = new_slot < cfg.pool_bricks  # pool-full: leave unallocated
    table = jnp.where(need & can, new_slot, sm.table)
    n_alloc = jnp.minimum(sm.n_alloc + order[-1], cfg.pool_bricks)
    # record brick coords of newly allocated slots (out-of-pool -> drop)
    coords = _table_coords(cfg)
    target = jnp.where(need & can, new_slot, cfg.pool_bricks)
    brick_xyz = sm.brick_xyz.at[target].set(coords, mode="drop")

    # --- scatter the updates
    inner = (vi - bc * cfg.brick).reshape(-1, 3)
    slot = table[tflat]
    flat = _pool_flat(
        cfg,
        jnp.maximum(slot, 0),
        inner,
    )
    trash = sm.pool_lo.shape[0] - 1
    flat = jnp.where(okf & (slot >= 0), flat, trash)
    # per-voxel MEAN of this integration's samples (supereight's weighted-
    # mean update model; see mapping/submap.py integrate_rays)
    if compact_cap is not None and sharded:
        # SPARSE cross-device reduction: the naive path all-reduces the
        # ENTIRE pool accumulator twice (pool_bricks x brick^3 floats,
        # ~17 MB at bench shapes) regardless of how few bricks a sweep
        # touches — which is why submap weak scaling cratered (0.38 @ 8
        # devices, round-4 SCALING).  The touched mask was ALREADY
        # all-reduced above, so every device derives the SAME compact
        # touched-brick -> slot mapping by prefix sum; each device
        # scatters its shard into the (cap, brick^3) compact buffer and
        # only THAT is all-reduced (~16x less traffic at cap=256).
        # Bricks beyond the cap fall back into a trash row (deterministic
        # and identical on every device; a sweep touching > cap bricks is
        # off the design envelope — cap covers the whole table at bench
        # shapes).
        B3 = cfg.brick ** 3
        c_order = jnp.cumsum(touched.astype(jnp.int32)) - 1
        c_slot_of_brick = jnp.where(
            touched & (c_order < compact_cap), c_order, compact_cap
        )  # (T3,): compact slot, overflow/untouched -> trash row
        # per-sample compact flat index
        c_slot = c_slot_of_brick[tflat]
        inner_flat = (
            (inner[:, 0] * cfg.brick + inner[:, 1]) * cfg.brick
            + inner[:, 2]
        )
        c_flat = jnp.where(
            okf & (slot >= 0), c_slot * B3 + inner_flat,
            compact_cap * B3,
        )
        c_sum = reduce(
            jnp.zeros((compact_cap * B3 + 1,), sm.pool_lo.dtype)
            .at[c_flat].add(jnp.where(okf, upd.reshape(-1), 0.0))
        )
        c_cnt = reduce(
            jnp.zeros((compact_cap * B3 + 1,), sm.pool_lo.dtype)
            .at[c_flat].add(okf.astype(sm.pool_lo.dtype))
        )
        # expand back into pool-shaped accumulators LOCALLY (replicated):
        # pool cell -> its brick's compact slot (or trash)
        pool_slot = table  # (T3,) brick -> pool slot (may be -1)
        # build pool-flat gather indices: for each compact cell, its pool
        # destination; invert instead: for each pool brick slot, find its
        # compact slot via brick_xyz ordering — simpler: scatter compact
        # cells into the pool by building destination indices per compact
        # slot from the same shared mapping
        dest_brick = jnp.argsort(
            jnp.where(c_slot_of_brick < compact_cap, c_slot_of_brick, T3)
        )[:compact_cap]  # table-flat brick index per compact slot
        dest_pool_slot = table[dest_brick]  # (cap,)
        dest_ok = (c_slot_of_brick[dest_brick] < compact_cap) & (
            dest_pool_slot >= 0
        )
        dest_base = jnp.where(
            dest_ok, dest_pool_slot * B3, sm.pool_lo.shape[0] - 1
        )
        dflat = (
            dest_base[:, None] + jnp.arange(B3, dtype=jnp.int32)[None, :]
        )
        dflat = jnp.where(dest_ok[:, None], dflat, sm.pool_lo.shape[0] - 1)
        sum_upd = (
            jnp.zeros_like(sm.pool_lo)
            .at[dflat.reshape(-1)]
            .add(c_sum[: compact_cap * B3])
        )
        cnt = (
            jnp.zeros_like(sm.pool_lo)
            .at[dflat.reshape(-1)]
            .add(c_cnt[: compact_cap * B3])
        )
    else:
        sum_upd = reduce(
            jnp.zeros_like(sm.pool_lo).at[flat].add(
                jnp.where(okf, upd.reshape(-1), 0.0)
            )
        )
        cnt = reduce(
            jnp.zeros_like(sm.pool_lo).at[flat].add(
                okf.astype(sm.pool_lo.dtype)
            )
        )
    pool_lo = sm.pool_lo + sum_upd / jnp.maximum(cnt, 1.0)
    pool_lo = jnp.clip(pool_lo, cfg.log_odd_min, cfg.log_odd_max)
    pool_lo = pool_lo.at[trash].set(0.0)
    # weights from the (cross-device-reduced) count accumulator: the old
    # per-device scatter left pool_w under-counted and NON-replicated in
    # the sharded path
    pool_w = (sm.pool_w + cnt.astype(sm.pool_w.dtype)).at[trash].set(0)
    return sm._replace(
        table=table,
        brick_xyz=brick_xyz,
        pool_lo=pool_lo,
        pool_w=pool_w,
        n_alloc=n_alloc,
    )


def _table_coords(cfg: BrickConfig) -> jax.Array:
    """(T^3, 3) int32 brick coordinates in table-flat order."""
    T = cfg.table_dim
    i = jnp.arange(T * T * T, dtype=jnp.int32)
    return jnp.stack([i // (T * T), (i // T) % T, i % T], axis=-1)


def integrate_rays(
    sm: BrickSubmap,
    cfg: BrickConfig,
    origin_K: jax.Array,
    end_K: jax.Array,
    valid: jax.Array,
    sigma: jax.Array | float = 0.1,
) -> BrickSubmap:
    """Batch ray integration (≙ se::MapIntegrator::integrateRayBatch at
    SubmappingInterface.cpp:785) — same σ-aware sampling profile as the
    dense module, scattered through the brick table."""
    from okvis2x_tpu.mapping.submap import _ray_samples

    pts, upd, ok = _ray_samples(cfg, origin_K, end_K, valid, sigma, sm.pool_lo.dtype)
    return _scatter_updates(sm, cfg, pts, upd, ok)


# ---------------------------------------------------------------------------
# field interpolation — two-level gather trilinear (shares the dense math)
# ---------------------------------------------------------------------------


def interp_occupancy(sm: BrickSubmap, cfg: BrickConfig, p_K: jax.Array):
    from okvis2x_tpu.mapping.submap import _in_bounds, _world_to_voxel

    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    v = jnp.clip(v, 0.0, cfg.dim - 1.001)
    v0 = jnp.floor(v).astype(jnp.int32)
    f = v - v0

    def g(dx, dy, dz):
        return _fetch(sm, cfg, v0 + jnp.array([dx, dy, dz], jnp.int32))

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return jnp.where(ok, val, 0.0), ok


def grad_occupancy(sm: BrickSubmap, cfg: BrickConfig, p_K: jax.Array):
    from okvis2x_tpu.mapping.submap import _in_bounds, _world_to_voxel

    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    v = jnp.clip(v, 0.0, cfg.dim - 1.001)
    v0 = jnp.floor(v).astype(jnp.int32)
    f = v - v0

    def g(dx, dy, dz):
        return _fetch(sm, cfg, v0 + jnp.array([dx, dy, dz], jnp.int32))

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    dx = (
        (g(1, 0, 0) - g(0, 0, 0)) * (1 - fy) * (1 - fz)
        + (g(1, 1, 0) - g(0, 1, 0)) * fy * (1 - fz)
        + (g(1, 0, 1) - g(0, 0, 1)) * (1 - fy) * fz
        + (g(1, 1, 1) - g(0, 1, 1)) * fy * fz
    )
    dy = (
        (g(0, 1, 0) - g(0, 0, 0)) * (1 - fx) * (1 - fz)
        + (g(1, 1, 0) - g(1, 0, 0)) * fx * (1 - fz)
        + (g(0, 1, 1) - g(0, 0, 1)) * (1 - fx) * fz
        + (g(1, 1, 1) - g(1, 0, 1)) * fx * fz
    )
    dz = (
        (g(0, 0, 1) - g(0, 0, 0)) * (1 - fx) * (1 - fy)
        + (g(1, 0, 1) - g(1, 0, 0)) * fx * (1 - fy)
        + (g(0, 1, 1) - g(0, 1, 0)) * (1 - fx) * fy
        + (g(1, 1, 1) - g(1, 1, 0)) * fx * fy
    )
    grad = jnp.stack([dx, dy, dz], axis=-1) / cfg.res
    return jnp.where(ok[..., None], grad, 0.0), ok


def observed_mask(sm: BrickSubmap, cfg: BrickConfig, p_K: jax.Array):
    """(...,) bool: point lands in a voxel that has received updates (for
    the submap-overlap heuristic, ≙ evaluateDepthOverlap)."""
    from okvis2x_tpu.mapping.submap import _in_bounds, _world_to_voxel

    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, cfg.dim - 1)
    return (_fetch_weight(sm, cfg, vi) > 0) & ok


def occupied_point_list(
    sm: BrickSubmap,
    cfg: BrickConfig,
    threshold: float = 1.0,
    max_points: int = 4096,
):
    """Compact (max_points, 3) submap-frame centres of occupied voxels +
    validity mask (device-side compaction via fixed-size nonzero)."""
    occ = sm.pool_lo[:-1] > threshold
    count = jnp.sum(occ)
    idx = jnp.nonzero(occ, size=max_points, fill_value=0)[0]
    slot = idx // cfg.b3
    innerf = idx % cfg.b3
    b = cfg.brick
    inner = jnp.stack(
        [innerf // (b * b), (innerf // b) % b, innerf % b], axis=-1
    )
    vi = sm.brick_xyz[slot] * b + inner
    half = cfg.dim * cfg.res / 2.0
    centers = (vi.astype(sm.pool_lo.dtype) + 0.5) * cfg.res - half
    valid = jnp.arange(max_points) < count
    return centers, valid
