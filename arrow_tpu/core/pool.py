"""Memory observability (arrow-buffer/src/pool.rs:73 MemoryPool /
TrackingMemoryPool; arrow-array get_{array,buffer}_memory_size,
dictionary occupancy dictionary_array.rs:563).

On the device the allocator is XLA's memory arena, so the pool here is an
accounting layer: columns register their device-tensor footprints into a
pool; TrackingMemoryPool keeps the running and peak totals.  Sizes are
exact tensor byte sizes (device tensors are dense, no slack bytes).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.table import Table

__all__ = ["MemoryPool", "TrackingMemoryPool", "MemoryReservation",
           "column_memory_size", "table_memory_size",
           "dictionary_occupancy", "device_memory_stats"]


def _nbytes(x) -> int:
    if not (hasattr(x, "dtype") and hasattr(x, "shape")):
        return 0
    try:
        item = np.dtype(x.dtype).itemsize
    except TypeError:      # non-tensor leaf (e.g. NullColumn's dtype tag)
        return 0
    return int(item * int(np.prod(x.shape)))


def column_memory_size(col: Column) -> int:
    """get_array_memory_size: total bytes of all device tensors reachable
    from the column (buffers + validity + children)."""
    leaves = jax.tree_util.tree_leaves(col)
    return sum(_nbytes(a) for a in leaves)


def table_memory_size(table: Table) -> int:
    return sum(column_memory_size(c) for c in table.columns)


def dictionary_occupancy(col: DictionaryColumn) -> float:
    """Fraction of dictionary entries referenced by live codes
    (dictionary_array.rs:563 occupancy, as a ratio)."""
    size = len(col.values)
    if size == 0:
        return 0.0
    codes = col.codes
    if col.validity is not None:
        # sentinel must be truly OUT of bounds: mode='drop' normalizes
        # negative indices first, so -1 would mark values[size-1]
        codes = jnp.where(col.validity, codes,
                          jnp.asarray(size, codes.dtype))
    used = jnp.zeros((size,), jnp.bool_).at[codes].set(True, mode="drop")
    return float(jnp.sum(used)) / size


class MemoryPool:
    """pool.rs:73 trait: register/unregister/resize via reservations."""

    def reserve(self, size: int) -> "MemoryReservation":
        return MemoryReservation(self, size)

    def _grow(self, size: int):
        pass

    def _shrink(self, size: int):
        pass

    def used(self) -> int:
        return 0


class TrackingMemoryPool(MemoryPool):
    """pool.rs:93: tracks current and peak usage (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._used = 0
        self._peak = 0

    def _grow(self, size: int):
        with self._lock:
            self._used += size
            self._peak = max(self._peak, self._used)

    def _shrink(self, size: int):
        with self._lock:
            self._used -= size

    def used(self) -> int:
        with self._lock:
            return self._used

    def peak(self) -> int:
        with self._lock:
            return self._peak


class MemoryReservation:
    """RAII-style reservation; resize like pool.rs MemoryReservation."""

    def __init__(self, pool: MemoryPool, size: int):
        self._pool = pool
        self._size = size
        pool._grow(size)

    @property
    def size(self) -> int:
        return self._size

    def resize(self, new_size: int):
        delta = new_size - self._size
        if delta > 0:
            self._pool._grow(delta)
        else:
            self._pool._shrink(-delta)
        self._size = new_size

    def free(self):
        self._pool._shrink(self._size)
        self._size = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()

    @classmethod
    def for_column(cls, pool: MemoryPool, col: Column
                   ) -> "MemoryReservation":
        return cls(pool, column_memory_size(col))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Live HBM stats from the device runtime, when the backend exposes
    them (the XLA allocator's own accounting)."""
    d = device or jax.devices()[0]
    try:
        s = d.memory_stats()
    except Exception:
        return None
    if not s:
        return None
    return {k: int(v) for k, v in s.items()
            if isinstance(v, (int, np.integer))}
