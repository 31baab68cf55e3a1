"""Device-mesh helpers.

The reference's distribution story is gRPC streams between processes
(arrow-flight, SURVEY.md §2.4); this engine's is a jax.sharding.Mesh whose
collectives ride the device interconnect inside one XLA program.  One
logical axis ("shards") carries the hash-partitioned table distribution —
the engine's analogue of data parallelism.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_axis", "table_sharding", "P"]

SHARD_AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (SHARD_AXIS,))


def shard_axis(mesh: Mesh) -> str:
    return mesh.axis_names[0]


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded over the mesh axis (columns are 1-D row tensors)."""
    return NamedSharding(mesh, P(shard_axis(mesh)))
