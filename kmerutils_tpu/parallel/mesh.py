"""Device-mesh helpers.

The engine's parallel axes (SURVEY.md §2.10): reads are data-parallel across
devices; kmer space is hash-partitioned for counting (the DispatchableT shard
semantics) with an all-to-all exchange between devices; sketch/filter state merges
with psum/pmax collectives.  One 1-D mesh covers all of it.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def reads_sharding(mesh: Mesh, axis: str = READS_AXIS) -> NamedSharding:
    """Shard the leading (reads) dimension."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
