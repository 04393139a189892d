"""Submap integration sharded over a device mesh.

The reference integrates rays into supereight2 octree submaps with OpenMP
threads on one host (okvis_multisensor_processing/src/
SubmappingInterface.cpp:771-902, README.md:447 OMP_NUM_THREADS=2).  The
design here shards the RAY BATCH over the mesh axis: each device
samples and scatters its shard of rays into local accumulators, the
touched-brick mask and the log-odds accumulators all-reduce across the
mesh (`lax.psum`), and the brick allocation + mean update then run replicated
and deterministically — every device holds an identical `BrickSubmap`
afterwards, so interpolation/ICP can read the map on any device without a
broadcast (BASELINE target "submaps sharded across N hosts").

Complementarily, *different* submaps are naturally placed on different
hosts (each submap is anchored to its own keyframe and integrated
independently); this module covers the within-submap axis where a single
dense sweep (e.g. a 360° LiDAR scan: 10-100k rays) is the unit of work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from okvis2x_tpu.mapping.brick import (
    BrickConfig,
    BrickSubmap,
    _scatter_updates,
)
from okvis2x_tpu.parallel.mesh import OBS_AXIS


def integrate_rays_sharded(
    sm: BrickSubmap,
    cfg: BrickConfig,
    origin_K: jax.Array,  # (3,) sensor centre in submap frame
    end_K: jax.Array,  # (R, 3) end points, R divisible by mesh size
    valid: jax.Array,  # (R,)
    mesh: Mesh,
    sigma: float = 0.1,
    compact_cap: int = 256,
) -> BrickSubmap:
    """Ray-sharded brick integration; returns the (replicated) new submap.

    `compact_cap`: the cross-device reduction rides a compacted
    touched-brick buffer of this many bricks (~cap x brick^3 floats x 2)
    instead of the full pool accumulators (pool_bricks x brick^3 x 2,
    ~17 MB at default shapes) — the all-reduce payload that cratered
    submap weak scaling at 8 devices (round-4 SCALING 0.38).  The mapping
    is derived from the all-reduced touched mask, so it is identical on
    every device and the result stays exactly replicated."""
    from okvis2x_tpu.mapping.submap import _ray_samples

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(OBS_AXIS), P(OBS_AXIS)),
        out_specs=P(),
        check_rep=False,
    )
    def run(sm_in, o, e, v):
        pts, upd, ok = _ray_samples(
            cfg, o, e, v, sigma, sm_in.pool_lo.dtype
        )
        return _scatter_updates(
            sm_in, cfg, pts, upd, ok,
            reduce=lambda x: jax.lax.psum(x, OBS_AXIS),
            compact_cap=compact_cap,
        )

    return run(sm, origin_K, end_K, valid)
