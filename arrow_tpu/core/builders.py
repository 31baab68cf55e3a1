"""Typed array builders (arrow-array/src/builder/, 19 builders).

Builders are construction-time host-side accumulators — in the reference
they are append loops over MutableBuffer; here they accumulate in numpy
and upload one device tensor at finish() (device round-trips per append
would be absurd on an accelerator).  The dictionary builder hash-interns
values like generic_bytes_dictionary_builder.rs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from .column import (Column, DictionaryColumn, ListColumn, NullColumn,
                     PrimitiveColumn, StringColumn, StructColumn)
from ..errors import ArrowInvalid, ArrowTypeError

__all__ = [
    "PrimitiveBuilder", "BooleanBuilder", "StringBuilder", "BinaryBuilder",
    "LargeStringBuilder", "LargeBinaryBuilder", "FixedSizeBinaryBuilder",
    "Decimal128Builder", "Decimal256Builder", "DictionaryBuilder",
    "StringDictionaryBuilder", "ListBuilder", "FixedSizeListBuilder",
    "StructBuilder", "MapBuilder", "NullBuilder", "make_builder",
]


class _Base:
    def __len__(self):
        return self._len

    def append_nulls(self, n: int):
        for _ in range(n):
            self.append_null()

    def extend(self, values):
        for v in values:
            self.append(v)
        return self


class PrimitiveBuilder(_Base):
    """PrimitiveBuilder<T> (builder/primitive_builder.rs)."""

    def __init__(self, dtype: dt.DataType):
        if not dtype.is_primitive:
            raise ArrowTypeError(f"not primitive: {dtype}")
        self.dtype = dtype
        self._np = np.dtype(dtype.to_jax())
        self._vals: List = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        self._vals.append(v)
        self._valid.append(True)
        self._len += 1
        return self

    append_value = append

    def append_null(self):
        self._vals.append(0)
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self) -> PrimitiveColumn:
        vals = np.asarray(self._vals, self._np)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        dtype = self.dtype
        PrimitiveBuilder.__init__(self, dtype)   # reset (subclass-safe)
        return PrimitiveColumn(jnp.asarray(vals), dtype, validity)


class BooleanBuilder(PrimitiveBuilder):
    def __init__(self):
        super().__init__(dt.bool_)

    def append(self, v):
        return super().append(None if v is None else bool(v))


class _BytesBuilder(_Base):
    """GenericByteBuilder (builder/generic_bytes_builder.rs)."""

    def __init__(self, dtype: dt.DataType):
        self.dtype = dtype
        self._chunks: List[bytes] = []
        self._offsets: List[int] = [0]
        self._valid: List[bool] = []
        self._len = 0

    def _to_bytes(self, v) -> bytes:
        return v.encode() if isinstance(v, str) else bytes(v)

    def append(self, v):
        if v is None:
            return self.append_null()
        b = self._to_bytes(v)
        self._chunks.append(b)
        self._offsets.append(self._offsets[-1] + len(b))
        self._valid.append(True)
        self._len += 1
        return self

    append_value = append

    def append_null(self):
        self._offsets.append(self._offsets[-1])
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self) -> StringColumn:
        data = np.frombuffer(b"".join(self._chunks), np.uint8).copy()
        off_np = np.int64 if self.dtype.name.startswith("large") else np.int32
        offs = np.asarray(self._offsets, off_np)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        dtype = self.dtype
        _BytesBuilder.__init__(self, dtype)
        return StringColumn(jnp.asarray(offs), jnp.asarray(data), dtype,
                            validity)


class StringBuilder(_BytesBuilder):
    def __init__(self):
        super().__init__(dt.utf8)


class LargeStringBuilder(_BytesBuilder):
    def __init__(self):
        super().__init__(dt.large_utf8)


class BinaryBuilder(_BytesBuilder):
    def __init__(self):
        super().__init__(dt.binary)


class LargeBinaryBuilder(_BytesBuilder):
    def __init__(self):
        super().__init__(dt.large_binary)


class FixedSizeBinaryBuilder(_Base):
    def __init__(self, byte_width: int):
        self.byte_width = byte_width
        self._rows: List[bytes] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        b = bytes(v)
        if len(b) != self.byte_width:
            raise ArrowInvalid(f"expected {self.byte_width} bytes")
        self._rows.append(b)
        self._valid.append(True)
        self._len += 1
        return self

    def append_null(self):
        self._rows.append(b"\0" * self.byte_width)
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self):
        from .nested import FixedSizeBinaryColumn
        data = np.frombuffer(b"".join(self._rows), np.uint8).copy() \
            .reshape(self._len, self.byte_width)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        w = self.byte_width
        FixedSizeBinaryBuilder.__init__(self, w)
        return FixedSizeBinaryColumn(jnp.asarray(data), validity)


class _DecimalBuilder(_Base):
    def __init__(self, dtype: dt.DataType):
        self.dtype = dtype
        self._vals: List[int] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        self._vals.append(int(v))
        self._valid.append(True)
        self._len += 1
        return self

    def append_null(self):
        self._vals.append(0)
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self):
        from .nested import DecimalColumn
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        dtype = self.dtype
        col = DecimalColumn.from_pyints(self._vals, dtype, validity)
        _DecimalBuilder.__init__(self, dtype)
        return col


class Decimal128Builder(_DecimalBuilder):
    def __init__(self, precision: int = 38, scale: int = 0):
        super().__init__(dt.decimal128(precision, scale))


class Decimal256Builder(_DecimalBuilder):
    def __init__(self, precision: int = 76, scale: int = 0):
        super().__init__(dt.decimal256(precision, scale))


class DictionaryBuilder(_Base):
    """Hash-interning dictionary builder
    (builder/generic_bytes_dictionary_builder.rs)."""

    def __init__(self, value_builder, index_dtype=None):
        self._value_builder = value_builder
        self._index_np = np.int32 if index_dtype is None \
            else index_dtype.to_numpy()
        self._intern: Dict = {}
        self._codes: List[int] = []
        self._valid: List[bool] = []
        self._len = 0

    def append(self, v):
        if v is None:
            return self.append_null()
        code = self._intern.get(v)
        if code is None:
            code = len(self._intern)
            self._intern[v] = code
            self._value_builder.append(v)
        self._codes.append(code)
        self._valid.append(True)
        self._len += 1
        return self

    def append_null(self):
        self._codes.append(0)
        self._valid.append(False)
        self._len += 1
        return self

    @property
    def dictionary_size(self) -> int:
        return len(self._intern)

    def finish(self) -> DictionaryColumn:
        values = self._value_builder.finish()
        codes = np.asarray(self._codes, self._index_np)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        vb = self._value_builder
        idx_np = self._index_np
        DictionaryBuilder.__init__(self, vb)
        self._index_np = idx_np
        return DictionaryColumn(jnp.asarray(codes), values, validity)


class StringDictionaryBuilder(DictionaryBuilder):
    def __init__(self):
        super().__init__(StringBuilder())


class ListBuilder(_Base):
    """ListBuilder (builder/generic_list_builder.rs): append via the
    `values` child builder, close each list with append(True)."""

    def __init__(self, values_builder, large: bool = False):
        self.values = values_builder
        self.large = large
        self._offsets: List[int] = [0]
        self._valid: List[bool] = []
        self._len = 0

    def append(self, is_valid=True):
        """Close the current list."""
        self._offsets.append(len(self.values))
        self._valid.append(bool(is_valid))
        self._len += 1
        return self

    def append_value(self, values: Sequence):
        for v in values:
            self.values.append(v)
        return self.append(True)

    def append_null(self):
        return self.append(False)

    def finish(self) -> ListColumn:
        child = self.values.finish()
        offs = np.asarray(self._offsets,
                          np.int64 if self.large else np.int32)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        vb, large = self.values, self.large
        ListBuilder.__init__(self, vb, large)
        return ListColumn(jnp.asarray(offs), child, validity, large=large)


class FixedSizeListBuilder(_Base):
    def __init__(self, values_builder, list_size: int):
        self.values = values_builder
        self.list_size = list_size
        self._valid: List[bool] = []
        self._len = 0

    def append_value(self, values: Sequence):
        if len(values) != self.list_size:
            raise ArrowInvalid(f"expected {self.list_size} values")
        for v in values:
            self.values.append(v)
        self._valid.append(True)
        self._len += 1
        return self

    append = append_value

    def append_null(self):
        for _ in range(self.list_size):
            self.values.append_null()
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self):
        from .nested import FixedSizeListColumn
        child = self.values.finish()
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        vb, k = self.values, self.list_size
        FixedSizeListBuilder.__init__(self, vb, k)
        return FixedSizeListColumn(child, k, validity)


class StructBuilder(_Base):
    """StructBuilder (builder/struct_builder.rs): per-field child builders."""

    def __init__(self, fields: Sequence[dt.Field], builders):
        self.fields = tuple(fields)
        self.builders = list(builders)
        self._valid: List[bool] = []
        self._len = 0

    def field_builder(self, i: int):
        return self.builders[i]

    def append(self, is_valid=True):
        self._valid.append(bool(is_valid))
        self._len += 1
        return self

    def append_null(self):
        for b in self.builders:
            b.append_null()
        return self.append(False)

    def finish(self) -> StructColumn:
        children = tuple(b.finish() for b in self.builders)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        f, bs = self.fields, self.builders
        StructBuilder.__init__(self, f, bs)
        return StructColumn(children, f, validity)


class MapBuilder(_Base):
    """MapBuilder (builder/map_builder.rs)."""

    def __init__(self, key_builder, item_builder,
                 key_field: str = "key", item_field: str = "value"):
        self.keys = key_builder
        self.items = item_builder
        self._names = (key_field, item_field)
        self._offsets: List[int] = [0]
        self._valid: List[bool] = []
        self._len = 0

    def append_value(self, pairs):
        for k, v in pairs:
            self.keys.append(k)
            self.items.append(v)
        self._offsets.append(len(self.keys))
        self._valid.append(True)
        self._len += 1
        return self

    append = append_value

    def append_null(self):
        self._offsets.append(self._offsets[-1])
        self._valid.append(False)
        self._len += 1
        return self

    def finish(self):
        from .nested import MapColumn
        keys = self.keys.finish()
        items = self.items.finish()
        entries = StructColumn(
            (keys, items),
            (dt.Field(self._names[0], keys.dtype, nullable=False),
             dt.Field(self._names[1], items.dtype)))
        offs = np.asarray(self._offsets, np.int32)
        validity = None if all(self._valid) \
            else jnp.asarray(np.asarray(self._valid, bool))
        kb, ib, names = self.keys, self.items, self._names
        MapBuilder.__init__(self, kb, ib, *names)
        return MapColumn(jnp.asarray(offs), entries, validity)


class NullBuilder(_Base):
    def __init__(self):
        self._len = 0

    def append_null(self):
        self._len += 1
        return self

    append = append_null

    def finish(self) -> NullColumn:
        n = self._len
        self._len = 0
        return NullColumn(n)


def make_builder(dtype: dt.DataType):
    """Builder for a dtype (builder/mod.rs make_builder)."""
    if dtype.is_null:
        return NullBuilder()
    if dtype == dt.bool_:
        return BooleanBuilder()
    if dtype.is_primitive:
        return PrimitiveBuilder(dtype)
    if dtype.name == "utf8":
        return StringBuilder()
    if dtype.name == "large_utf8":
        return LargeStringBuilder()
    if dtype.name == "binary":
        return BinaryBuilder()
    if dtype.name == "large_binary":
        return LargeBinaryBuilder()
    if dtype.name == "fixed_size_binary":
        return FixedSizeBinaryBuilder(dtype.list_size)
    if dtype.name == "decimal128":
        return Decimal128Builder(dtype.precision, dtype.scale)
    if dtype.name == "decimal256":
        return Decimal256Builder(dtype.precision, dtype.scale)
    if dtype.name == "dictionary":
        return DictionaryBuilder(make_builder(dtype.value_type),
                                 dtype.index_type)
    if dtype.name in ("list", "large_list"):
        return ListBuilder(make_builder(dtype.value_type),
                           large=dtype.name == "large_list")
    if dtype.name == "fixed_size_list":
        return FixedSizeListBuilder(make_builder(dtype.value_type),
                                    dtype.list_size)
    if dtype.name == "struct":
        return StructBuilder(dtype.fields,
                             [make_builder(f.dtype) for f in dtype.fields])
    if dtype.name == "map":
        kv = dtype.value_type
        return MapBuilder(make_builder(kv.fields[0].dtype),
                          make_builder(kv.fields[1].dtype))
    raise ArrowTypeError(f"no builder for {dtype}")
