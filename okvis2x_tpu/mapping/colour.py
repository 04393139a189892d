"""Per-voxel colour for occupancy submaps.

JAX counterpart of the reference's `se::OccupancyColIdMap`
(okvis_mapping/include/okvis/mapTypedefs.hpp:19-26, built with
USE_COLIDMAP) and the camera-colour warp into depth integration
(okvis_multisensor_processing/src/SubmappingInterface.cpp:848-888):
each integrated depth ray carries the colour of its source pixel, splatted
into the voxel at the ray endpoint (the surface voxel — the only one a
mesh export reads back).

The store is a PARALLEL pool sharing the occupancy submap's indexing
(brick table -> pool slot -> voxel), so occupancy programs keep their
pytrees/compiled signatures; colour is an independent accumulation:

    colour(v) = col_sum(v) / max(w(v), 1)

Dense (test-scale) submaps use the voxel grid flat index directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ColourStore(NamedTuple):
    col: jax.Array  # (V+1, 3) weighted colour sums; [-1] = trash
    w: jax.Array  # (V+1,) accumulation weights


def _n_voxels(cfg) -> int:
    from okvis2x_tpu.mapping.submap import _is_brick

    if _is_brick(cfg):
        return cfg.pool_bricks * cfg.b3
    return cfg.dim ** 3


def new_store(cfg, dtype=jnp.float32) -> ColourStore:
    V = _n_voxels(cfg)
    return ColourStore(
        col=jnp.zeros((V + 1, 3), dtype),
        w=jnp.zeros((V + 1,), dtype),
    )


def _voxel_flat(sm, cfg, p_K: jax.Array):
    """Flat store index of the voxel containing each point (trash index
    for out-of-map / unallocated-brick points); shared brick/dense."""
    from okvis2x_tpu.mapping.submap import (
        _in_bounds, _is_brick, _world_to_voxel,
    )

    v = _world_to_voxel(cfg, p_K)
    ok = _in_bounds(cfg, v)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, cfg.dim - 1)
    if _is_brick(cfg):
        from okvis2x_tpu.mapping.brick import _pool_flat, _table_flat

        bc = vi // cfg.brick
        inner = vi - bc * cfg.brick
        slot = sm.table[_table_flat(cfg, bc)]
        flat = _pool_flat(cfg, jnp.maximum(slot, 0), inner)
        ok = ok & (slot >= 0)
    else:
        d = cfg.dim
        flat = (vi[..., 0] * d + vi[..., 1]) * d + vi[..., 2]
    trash = _n_voxels(cfg)
    return jnp.where(ok, flat, trash), ok


def splat(
    store: ColourStore,
    sm,
    cfg,
    p_K: jax.Array,  # (N, 3) ray endpoints in submap frame
    col: jax.Array,  # (N, 3) colours in [0, 1]
    valid: jax.Array,  # (N,)
) -> ColourStore:
    """Accumulate per-ray colour into the endpoint voxels (run AFTER the
    occupancy integration so the touched bricks are allocated)."""
    flat, ok = _voxel_flat(sm, cfg, p_K)
    ok = ok & valid
    wnew = ok.astype(store.w.dtype)
    col = jnp.where(ok[:, None], col.astype(store.col.dtype), 0.0)
    return ColourStore(
        col=store.col.at[flat].add(col),
        w=store.w.at[flat].add(wnew),
    )


def colour_at(store: ColourStore, sm, cfg, p_K: jax.Array):
    """Nearest-voxel colour at (..., 3) submap-frame points; grey (0.5)
    where no colour was ever splatted."""
    flat, _ = _voxel_flat(sm, cfg, p_K)
    w = store.w[flat]
    c = store.col[flat] / jnp.maximum(w, 1.0)[..., None]
    return jnp.where(w[..., None] > 0, c, 0.5)
