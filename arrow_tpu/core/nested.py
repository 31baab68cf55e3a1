"""Extended array layouts: fixed-size list/binary, map, union, run-end,
decimal128/256, interval month_day_nano.

Completes the reference's physical layout registry
(arrow-data/src/data.rs:1579 layout(); arrow-array typed wrappers:
fixed_size_list FixedSizeListArray :119, map_array.rs:36,
union_array.rs:123, run_array.rs:63, fixed_size_binary_array.rs:53)
with device-native representations: every layout is a pytree of dense
device tensors; variable-width indirection is offsets/ids tensors, and
the 128/256-bit scalars (Decimal128/Decimal256 — the i256 analog,
arrow-buffer/src/bigint/mod.rs) are little-endian u64 limb planes so
kernels can operate limb-wise without host round-trips.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from . import validity as vd
from .column import Column, PrimitiveColumn, StructColumn

__all__ = [
    "FixedSizeListColumn", "FixedSizeBinaryColumn", "MapColumn",
    "UnionColumn", "RunEndColumn", "DecimalColumn", "IntervalMDNColumn",
]


@jax.tree_util.register_pytree_node_class
class FixedSizeListColumn(Column):
    """FixedSizeList<T, k> (arrow-array fixed_size_list FixedSizeListArray):
    child has len(col) * k rows; no offsets tensor."""

    def __init__(self, child: Column, list_size: int,
                 validity: vd.Mask = None):
        assert len(child) % max(list_size, 1) == 0 or len(child) == 0
        self.child = child
        self.list_size = int(list_size)
        self.validity = validity
        self.dtype = dt.fixed_size_list(child.dtype, self.list_size)

    def tree_flatten(self):
        if self.validity is None:
            return (self.child,), (self.list_size, False)
        return (self.child, self.validity), (self.list_size, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        size, has_v = aux
        obj = cls.__new__(cls)
        obj.child = children[0]
        obj.validity = children[1] if has_v else None
        obj.list_size = size
        obj.dtype = dt.fixed_size_list(obj.child.dtype, size)
        return obj

    def __len__(self):
        return 0 if self.list_size == 0 else \
            len(self.child) // self.list_size

    def with_validity(self, validity):
        return FixedSizeListColumn(self.child, self.list_size, validity)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return FixedSizeListColumn(
            self.child.slice(offset * self.list_size,
                             length * self.list_size),
            self.list_size, v)


@jax.tree_util.register_pytree_node_class
class FixedSizeBinaryColumn(Column):
    """FixedSizeBinary(w) (fixed_size_binary_array.rs:53): (n, w) u8."""

    def __init__(self, data: jnp.ndarray, validity: vd.Mask = None):
        assert data.ndim == 2 and data.dtype == jnp.uint8
        self.data = data
        self.validity = validity
        self.dtype = dt.fixed_size_binary(int(data.shape[1]))

    @property
    def byte_width(self) -> int:
        return int(self.data.shape[1])

    def tree_flatten(self):
        if self.validity is None:
            return (self.data,), (False,)
        return (self.data, self.validity), (True,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (has_v,) = aux
        obj = cls.__new__(cls)
        obj.data = children[0]
        obj.validity = children[1] if has_v else None
        obj.dtype = dt.fixed_size_binary(int(obj.data.shape[1]))
        return obj

    def __len__(self):
        return int(self.data.shape[0])

    def with_validity(self, validity):
        return FixedSizeBinaryColumn(self.data, validity)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return FixedSizeBinaryColumn(self.data[offset:offset + length], v)


@jax.tree_util.register_pytree_node_class
class MapColumn(Column):
    """Map<K, V> (map_array.rs:36): list of {key, value} structs."""

    def __init__(self, offsets: jnp.ndarray, entries: StructColumn,
                 validity: vd.Mask = None):
        assert len(entries.fields) == 2
        self.offsets = offsets
        self.entries = entries
        self.validity = validity
        self.dtype = dt.map_(entries.fields[0].dtype,
                             entries.fields[1].dtype)

    @property
    def keys(self) -> Column:
        return self.entries.children[0]

    @property
    def items(self) -> Column:
        return self.entries.children[1]

    def tree_flatten(self):
        if self.validity is None:
            return (self.offsets, self.entries), (False,)
        return (self.offsets, self.entries, self.validity), (True,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (has_v,) = aux
        obj = cls.__new__(cls)
        obj.offsets = children[0]
        obj.entries = children[1]
        obj.validity = children[2] if has_v else None
        obj.dtype = dt.map_(obj.entries.fields[0].dtype,
                            obj.entries.fields[1].dtype)
        return obj

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    def with_validity(self, validity):
        return MapColumn(self.offsets, self.entries, validity)

    def slice(self, offset, length):
        offs = self.offsets[offset:offset + length + 1]
        start, end = int(offs[0]), int(offs[-1])
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return MapColumn(offs - start,
                         self.entries.slice(start, end - start), v)


@jax.tree_util.register_pytree_node_class
class UnionColumn(Column):
    """Union (union_array.rs:123).  sparse: every child has n rows and
    offsets is None; dense: child rows are referenced via offsets.
    Unions carry no top-level validity (Arrow spec)."""

    def __init__(self, type_ids: jnp.ndarray,
                 offsets: Optional[jnp.ndarray],
                 children: Sequence[Column],
                 fields: Sequence[dt.Field],
                 ids: Optional[Sequence[int]] = None):
        self.type_ids = type_ids            # (n,) int8
        self.offsets = offsets              # (n,) int32 | None (sparse)
        self.children = tuple(children)
        self.fields = tuple(fields)
        self.ids = tuple(ids) if ids is not None \
            else tuple(range(len(self.children)))
        self.validity = None
        mode = "sparse" if offsets is None else "dense"
        self.dtype = dt.union(self.fields, mode, self.ids)

    @property
    def mode(self) -> str:
        return "sparse" if self.offsets is None else "dense"

    def tree_flatten(self):
        kids = (self.type_ids,) + ((self.offsets,)
                                   if self.offsets is not None else ()) \
            + tuple(self.children)
        return kids, (self.fields, self.ids, self.offsets is not None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fields, ids, dense = aux
        obj = cls.__new__(cls)
        obj.type_ids = children[0]
        k = 1
        obj.offsets = None
        if dense:
            obj.offsets = children[1]
            k = 2
        obj.children = tuple(children[k:])
        obj.fields = fields
        obj.ids = ids
        obj.validity = None
        obj.dtype = dt.union(fields, "dense" if dense else "sparse", ids)
        return obj

    def __len__(self):
        return int(self.type_ids.shape[0])

    def with_validity(self, validity):
        raise TypeError("union arrays carry no top-level validity")

    def child_index(self, type_id: int) -> int:
        return self.ids.index(type_id)

    def slice(self, offset, length):
        tids = self.type_ids[offset:offset + length]
        if self.offsets is None:
            return UnionColumn(tids, None,
                               [c.slice(offset, length)
                                for c in self.children],
                               self.fields, self.ids)
        return UnionColumn(tids, self.offsets[offset:offset + length],
                           self.children, self.fields, self.ids)


@jax.tree_util.register_pytree_node_class
class RunEndColumn(Column):
    """RunEndEncoded (run_array.rs:63): run_ends (strictly increasing,
    last == logical length) + values (one per run, may contain nulls)."""

    def __init__(self, run_ends: jnp.ndarray, values: Column,
                 length: Optional[int] = None):
        self.run_ends = run_ends
        self.values = values
        self._length = int(length) if length is not None else (
            int(run_ends[-1]) if run_ends.shape[0] else 0)
        self.validity = None               # nulls live in `values`
        self.dtype = dt.run_end_encoded(
            {"int16": dt.int16, "int32": dt.int32,
             "int64": dt.int64}[np.dtype(run_ends.dtype).name],
            values.dtype)

    def tree_flatten(self):
        return (self.run_ends, self.values), (self._length,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.run_ends = children[0]
        obj.values = children[1]
        obj._length = aux[0]
        obj.validity = None
        obj.dtype = dt.run_end_encoded(
            {"int16": dt.int16, "int32": dt.int32,
             "int64": dt.int64}[np.dtype(obj.run_ends.dtype).name],
            obj.values.dtype)
        return obj

    def __len__(self):
        return self._length

    @property
    def num_runs(self) -> int:
        return int(self.run_ends.shape[0])

    def row_to_run(self, rows: jnp.ndarray) -> jnp.ndarray:
        """Physical run index for each logical row (searchsorted right)."""
        return jnp.searchsorted(self.run_ends.astype(jnp.int64),
                                rows.astype(jnp.int64), side="right") \
            .astype(jnp.int32)

    def with_validity(self, validity):
        raise TypeError("run-end arrays carry no top-level validity")

    def slice(self, offset, length):
        # logical slice: shift run ends, clamp, drop empty runs
        re64 = self.run_ends.astype(jnp.int64)
        new_re = jnp.clip(re64 - offset, 0, length)
        keep = np.asarray((new_re > 0) & (jnp.concatenate(
            [jnp.zeros((1,), jnp.int64), new_re[:-1]]) < length))
        idx = np.nonzero(keep)[0]
        return RunEndColumn(new_re[idx].astype(self.run_ends.dtype),
                            _take_rows(self.values, idx), length)


class DecimalColumn(Column):
    """Decimal128/Decimal256: little-endian u64 limb planes (n, k).

    k=2 for decimal128, k=4 for decimal256 (the reference's i256,
    arrow-buffer/src/bigint/mod.rs).  Values are two's-complement over
    the full 64k bits.
    """

    def __init__(self, limbs: jnp.ndarray, dtype: dt.DataType,
                 validity: vd.Mask = None):
        assert dtype.name in ("decimal128", "decimal256")
        k = 2 if dtype.name == "decimal128" else 4
        assert limbs.ndim == 2 and limbs.shape[1] == k, limbs.shape
        self.limbs = limbs.astype(jnp.uint64)
        self.validity = validity
        self.dtype = dtype

    def tree_flatten(self):
        if self.validity is None:
            return (self.limbs,), (self.dtype, False)
        return (self.limbs, self.validity), (self.dtype, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dtype, has_v = aux
        obj = cls.__new__(cls)
        obj.limbs = children[0]
        obj.validity = children[1] if has_v else None
        obj.dtype = dtype
        return obj

    def __len__(self):
        return int(self.limbs.shape[0])

    def with_validity(self, validity):
        return DecimalColumn(self.limbs, self.dtype, validity)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return DecimalColumn(self.limbs[offset:offset + length],
                             self.dtype, v)

    # host conversions (python ints are arbitrary precision)
    @staticmethod
    def from_pyints(ints: Sequence, dtype: dt.DataType,
                    validity: vd.Mask = None) -> "DecimalColumn":
        k = 2 if dtype.name == "decimal128" else 4
        bits = 64 * k
        out = np.zeros((len(ints), k), np.uint64)
        for i, v in enumerate(ints):
            u = int(v) & ((1 << bits) - 1)       # two's complement
            for j in range(k):
                out[i, j] = (u >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
        return DecimalColumn(jnp.asarray(out), dtype, validity)

    def to_pyints(self):
        limbs = np.asarray(self.limbs)
        k = limbs.shape[1]
        bits = 64 * k
        vals = []
        valid = None if self.validity is None else np.asarray(self.validity)
        for i in range(limbs.shape[0]):
            if valid is not None and not valid[i]:
                vals.append(None)
                continue
            u = 0
            for j in range(k):
                u |= int(limbs[i, j]) << (64 * j)
            if u >= 1 << (bits - 1):
                u -= 1 << bits
            vals.append(u)
        return vals


jax.tree_util.register_pytree_node_class(DecimalColumn)


@jax.tree_util.register_pytree_node_class
class IntervalMDNColumn(Column):
    """Interval[month_day_nano] (arrow-buffer/src/interval.rs
    IntervalMonthDayNano): months i32, days i32, nanoseconds i64."""

    def __init__(self, months: jnp.ndarray, days: jnp.ndarray,
                 nanos: jnp.ndarray, validity: vd.Mask = None):
        self.months = months.astype(jnp.int32)
        self.days = days.astype(jnp.int32)
        self.nanos = nanos.astype(jnp.int64)
        self.validity = validity
        self.dtype = dt.interval("month_day_nano")

    def tree_flatten(self):
        if self.validity is None:
            return (self.months, self.days, self.nanos), (False,)
        return (self.months, self.days, self.nanos, self.validity), (True,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (has_v,) = aux
        obj = cls.__new__(cls)
        obj.months, obj.days, obj.nanos = children[:3]
        obj.validity = children[3] if has_v else None
        obj.dtype = dt.interval("month_day_nano")
        return obj

    def __len__(self):
        return int(self.months.shape[0])

    def with_validity(self, validity):
        return IntervalMDNColumn(self.months, self.days, self.nanos,
                                 validity)

    def slice(self, offset, length):
        s = slice(offset, offset + length)
        v = self.validity[s] if self.validity is not None else None
        return IntervalMDNColumn(self.months[s], self.days[s],
                                 self.nanos[s], v)


@jax.tree_util.register_pytree_node_class
class ListViewColumn(Column):
    """ListView / LargeListView (arrow-array/src/array/list_view_array.rs):
    independent offsets + sizes over a shared child — element i is
    child[offsets[i] : offsets[i] + sizes[i]].  Views may overlap, be
    out of order, or leave child gaps, which makes take/slice O(selected)
    index arithmetic instead of child copies."""

    def __init__(self, offsets: jnp.ndarray, sizes: jnp.ndarray,
                 child: Column, validity: vd.Mask = None,
                 dtype: dt.DataType = None):
        self.offsets = offsets
        self.sizes = sizes
        self.child = child
        self.validity = validity
        self.dtype = dtype if dtype is not None \
            else dt.list_view(child.dtype)
        assert self.dtype.name in ("list_view", "large_list_view")

    def tree_flatten(self):
        if self.validity is None:
            return (self.offsets, self.sizes, self.child), \
                (False, self.dtype)
        return (self.offsets, self.sizes, self.child, self.validity), \
            (True, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        has_v, dtype = aux
        obj = cls.__new__(cls)
        obj.offsets, obj.sizes, obj.child = children[:3]
        obj.validity = children[3] if has_v else None
        obj.dtype = dtype
        return obj

    def __len__(self):
        return int(self.offsets.shape[0])

    def with_validity(self, validity):
        return ListViewColumn(self.offsets, self.sizes, self.child,
                              validity, self.dtype)

    def slice(self, offset, length):
        s = slice(offset, offset + length)
        v = self.validity[s] if self.validity is not None else None
        # views: the child is untouched; only the view arrays narrow
        return ListViewColumn(self.offsets[s], self.sizes[s], self.child,
                              v, self.dtype)


def _take_rows(col: Column, idx) -> Column:
    """Host-index gather used by RunEndColumn.slice (small physical runs)."""
    from ..ops.take import take as take_kernel
    return take_kernel(col, PrimitiveColumn(jnp.asarray(
        np.asarray(idx, np.int64)), dt.int64))
