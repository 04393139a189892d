"""Device mesh helpers.

The reference has no distributed capability (SURVEY §2.11) — parallelism is
std::thread + OpenMP.  Here distribution is a first-class axis: a 1-D
`jax.sharding.Mesh` over all local/global devices, with observation tables
and landmark blocks sharded along it and the reduced camera system psum'd
across the mesh (SURVEY §7.1 "Distribution").
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

OBS_AXIS = "obs"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (OBS_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def obs_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(OBS_AXIS))
