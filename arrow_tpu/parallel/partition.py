"""Hash-partitioned shuffle: the engine's distributed exchange.

Replaces the reference's arrow-flight gRPC exchange (SURVEY.md §3.4) with an
in-program `all_to_all` over the mesh — the shuffle never leaves XLA,
rides the device interconnect (NVLink), and overlaps with surrounding
compute under the XLA scheduler.

Static-shape discipline (XLA requirement): every shard sends a fixed
(n_shards, capacity) slab; real rows are marked by a validity mask.
Capacity defaults to the local row count (lossless upper bound); callers
with known balance can shrink it.  Overflow is NEVER silent: every
capacity-bounded stage carries an `overflow` flag tensor, psum'd across
the mesh by `exchange`, so an undersized capacity is detected rather than
silently dropping rows (the skew-aware path splits heavy keys before
shuffling so capacities stay honest under Zipf keys).

All functions here are shard_map bodies or jit-safe helpers: no host syncs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import shard_axis

__all__ = ["hash_u64", "bucketize", "exchange", "ShuffleResult",
           "repartition_arrays"]


def hash_u64(key: jnp.ndarray) -> jnp.ndarray:
    """splitmix64 finalizer over u64 order keys: uniform shard assignment
    even for sequential keys."""
    x = key.astype(jnp.uint64)
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> jnp.uint64(31))


class ShuffleResult(NamedTuple):
    """Per-shard receive slab: arrays shaped (n_shards * capacity, ...),
    `valid` marking real rows, `overflow` a mesh-wide flag (True anywhere
    => some shard dropped rows for capacity: results are incomplete and
    the eager wrappers raise)."""
    arrays: tuple          # pytree tuple of value tensors
    valid: jnp.ndarray     # bool (n_shards * capacity,)
    overflow: jnp.ndarray  # bool scalar, psum-agreed across the mesh


def bucketize(target: jnp.ndarray, valid: jnp.ndarray, n_shards: int,
              capacity: int, *arrays: jnp.ndarray):
    """Scatter local rows into per-destination buckets.

    target: int32 destination shard per row; rows with valid=False are
    dropped.  Returns (slabs..., slab_valid) with each slab shaped
    (n_shards, capacity).  One stable sort groups rows by destination —
    the dense-vector analogue of the CPU radix partition pass.
    """
    n = target.shape[0]
    t = jnp.where(valid, target, n_shards)  # invalid rows -> overflow bin
    order = jnp.argsort(t, stable=True)
    t_sorted = t[order]
    # run boundaries of each destination in the sorted order
    bounds = jnp.searchsorted(t_sorted, jnp.arange(n_shards + 1,
                                                   dtype=t_sorted.dtype))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    overflow = jnp.any(counts > capacity)
    # slab fill is a GATHER, so it is deterministic:
    # slab[s, p] = row order[starts[s]+p]
    # when p < counts[s]; out-of-count slots carry garbage bytes masked
    # by slab_valid (the ShuffleResult contract is mask-driven).
    slot_pos = jnp.arange(capacity)
    slab_valid = slot_pos[None, :] < counts[:, None]
    src = jnp.minimum(starts[:, None] + slot_pos[None, :], n - 1)
    gidx = order[src.reshape(-1)]
    slabs = tuple(a[gidx].reshape(n_shards, capacity, *a.shape[1:])
                  for a in arrays)
    return slabs, slab_valid, overflow


def exchange(axis: str, slabs: tuple, slab_valid: jnp.ndarray,
             overflow: Optional[jnp.ndarray] = None) -> ShuffleResult:
    """all_to_all the (n_shards, capacity) slabs: row i of the result came
    from shard i.  Runs inside shard_map.  The local overflow flag is
    psum'd so EVERY shard agrees whether the shuffle lost rows."""
    def a2a(x):
        return jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
                                  tiled=True)
    out = tuple(a2a(s).reshape(-1, *s.shape[2:]) for s in slabs)
    valid = a2a(slab_valid).reshape(-1)
    if overflow is None:
        overflow = jnp.zeros((), jnp.bool_)
    global_overflow = jax.lax.psum(overflow.astype(jnp.int32), axis) > 0
    return ShuffleResult(out, valid, global_overflow)


def repartition_arrays(axis: str, key: jnp.ndarray, valid: jnp.ndarray,
                       capacity: int, *arrays: jnp.ndarray
                       ) -> ShuffleResult:
    """Full shuffle: route each row to shard hash(key) % n_shards.
    shard_map body; arrays are the row payloads (the key itself may be one
    of them)."""
    n_shards = jax.lax.axis_size(axis)
    target = (hash_u64(key) % jnp.uint64(n_shards)).astype(jnp.int32)
    slabs, slab_valid, overflow = bucketize(target, valid, n_shards,
                                            capacity, *arrays)
    return exchange(axis, slabs, slab_valid, overflow)
