"""Device-resident columnar arrays.

Device-native re-design of the reference's array model (arrow-array/src/array/,
arrow-data/src/data.rs:205).  Differences by design, not translation:

  - A column is a JAX pytree of device tensors, not a byte-buffer graph:
    values live in HBM as SoA tensors, validity is a dense bool tensor
    (see core/validity.py), and nested types nest pytrees.
  - No offset/slice-view machinery (ArrayData.offset): XLA slices are
    zero-copy views already, and static shapes are required under jit.
  - Null slots are canonicalized to zero at construction so every column has
    exactly one bit pattern per logical value (the reference leaves null
    slots unspecified; determinism here buys bitwise-exact goldens and
    hashable rows).

Class map (reference -> here):
  PrimitiveArray / BooleanArray / temporal arrays -> PrimitiveColumn
  GenericByteArray (Utf8/Binary)                  -> StringColumn
  DictionaryArray                                 -> DictionaryColumn
  GenericListArray                                -> ListColumn
  StructArray                                     -> StructColumn
  NullArray                                       -> NullColumn
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..errors import ArrowInvalid, ArrowTypeError
from . import validity as vd

__all__ = [
    "Column", "PrimitiveColumn", "StringColumn", "DictionaryColumn",
    "ListColumn", "StructColumn", "NullColumn", "column",
]


class Column:
    """Abstract base: a logical Arrow array on device.

    Mirrors the `Array` trait surface (arrow-array/src/array/mod.rs:82):
    len / data_type / nulls / is_null / slice / to_data-analogue.
    """

    dtype: dt.DataType
    validity: vd.Mask

    def __arrow_c_array__(self, requested_schema=None):
        """Arrow PyCapsule protocol (C data interface): any consumer —
        pa.array() included — ingests engine columns zero-conversion
        (arrow-pyarrow/src/lib.rs:88 role, io/cdata.py)."""
        from ..io.cdata import export_column
        return export_column(self)

    # -- basic protocol ------------------------------------------------------
    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int(vd.null_count(self.validity, len(self)))

    def is_valid_mask(self) -> jnp.ndarray:
        return vd.make_mask(len(self), self.validity)

    def with_validity(self, validity: vd.Mask) -> "Column":
        raise NotImplementedError

    def slice(self, offset: int, length: int) -> "Column":
        raise NotImplementedError

    # -- host conversion (eager API / tests) --------------------------------
    def to_pylist(self):
        import pyarrow  # local import; io.interop owns the bridge
        from ..io.interop import column_to_pyarrow
        return column_to_pyarrow(self).to_pylist()

    def to_pyarrow(self):
        from ..io.interop import column_to_pyarrow
        return column_to_pyarrow(self)

    def equals(self, other) -> bool:
        """Logical equality (arrow-data/src/equal/ + the arrays'
        PartialEq): same dtype, same nulls, same values.  Data equality
        in the reference is byte-level, so NaN == NaN at matching
        slots — unlike pyarrow's Array.equals."""
        if self is other:
            return True
        if not isinstance(other, Column):
            return False
        if self.dtype != other.dtype or len(self) != len(other):
            return False
        return _py_equal(self.to_pylist(), other.to_pylist())

    def __repr__(self):
        head = f"{type(self).__name__}<{self.dtype!r}>[{len(self)}]"
        try:
            return head + " " + str(self.to_pylist()[:10])
        except Exception:
            return head


def _py_equal(a, b) -> bool:
    """Recursive NaN-equal value comparison (byte-equality semantics:
    NaN == NaN at matching bits, -0.0 != 0.0, like arrow-rs PartialEq)."""
    if isinstance(a, float) and isinstance(b, float):
        import struct as _st
        return _st.pack("<d", a) == _st.pack("<d", b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_py_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_py_equal(v, b[k])
                                            for k, v in a.items())
    return a == b


@jax.tree_util.register_pytree_node_class
class PrimitiveColumn(Column):
    """Fixed-width values: numeric, boolean, temporal.

    values: jnp array of dtype.to_jax(), shape (n,)
    validity: dense bool mask or None
    """

    def __init__(self, values: jnp.ndarray, dtype: dt.DataType,
                 validity: vd.Mask = None, *, _canonical: bool = False):
        if not _canonical:
            values = vd.canonicalize(values, validity)
        self.values = values
        self.dtype = dtype
        self.validity = validity

    def tree_flatten(self):
        if self.validity is None:
            return (self.values,), (self.dtype, False)
        return (self.values, self.validity), (self.dtype, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dtype, has_validity = aux
        obj = cls.__new__(cls)
        obj.values = children[0]
        obj.validity = children[1] if has_validity else None
        obj.dtype = dtype
        return obj

    def __len__(self):
        return int(self.values.shape[0])

    def with_validity(self, validity):
        return PrimitiveColumn(self.values, self.dtype, validity)

    def with_values(self, values, dtype=None, *, _canonical=True):
        return PrimitiveColumn(values, dtype or self.dtype, self.validity,
                               _canonical=_canonical)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return PrimitiveColumn(self.values[offset:offset + length],
                               self.dtype, v, _canonical=True)

    def to_numpy(self, zero_nulls: bool = True) -> np.ndarray:
        return np.asarray(self.values)


@jax.tree_util.register_pytree_node_class
class StringColumn(Column):
    """Variable-length bytes in the Arrow Utf8/Binary layout
    (arrow-array/src/array/byte_array.rs:87): offsets (n+1,) + data bytes.

    Device-resident but *not* a hot compute representation: comparison /
    sort / group kernels dictionary-encode first (the reference itself
    late-materializes dictionaries in hot paths, arrow-ord/src/cmp.rs:387).
    Selection kernels (take/filter/concat) work directly on it via
    offset-arithmetic gathers in the eager API.
    """

    def __init__(self, offsets: jnp.ndarray, data: jnp.ndarray,
                 dtype: dt.DataType = dt.utf8, validity: vd.Mask = None):
        self.offsets = offsets          # int32/int64, shape (n+1,)
        self.data = data                # uint8, shape (nbytes,)
        self.dtype = dtype
        self.validity = validity

    def tree_flatten(self):
        if self.validity is None:
            return (self.offsets, self.data), (self.dtype, False)
        return (self.offsets, self.data, self.validity), (self.dtype, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dtype, has_validity = aux
        obj = cls.__new__(cls)
        obj.offsets = children[0]
        obj.data = children[1]
        obj.validity = children[2] if has_validity else None
        obj.dtype = dtype
        return obj

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    def with_validity(self, validity):
        return StringColumn(self.offsets, self.data, self.dtype, validity)

    def slice(self, offset, length):
        # Rebase offsets so data can be sliced too (eager only).
        offs = self.offsets[offset:offset + length + 1]
        start = int(offs[0])
        end = int(offs[-1])
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return StringColumn(offs - start, self.data[start:end],
                            self.dtype, v)

    @staticmethod
    def from_pylist(values: Sequence, dtype: dt.DataType = dt.utf8):
        enc = (lambda s: s.encode()) if dtype.is_string else (lambda s: s)
        datas, offsets, mask = [], [0], []
        total = 0
        for s in values:
            if s is None:
                mask.append(False)
            else:
                b = enc(s)
                datas.append(np.frombuffer(b, dtype=np.uint8))
                total += len(b)
                mask.append(True)
            offsets.append(total)
        data = np.concatenate(datas) if datas else np.zeros((0,), np.uint8)
        validity = None if all(mask) else jnp.asarray(mask)
        return StringColumn(jnp.asarray(np.asarray(offsets, np.int32)),
                            jnp.asarray(data), dtype, validity)

    def to_pylist_host(self):
        offs = np.asarray(self.offsets)
        data = np.asarray(self.data).tobytes()
        mask = np.asarray(self.validity) if self.validity is not None else None
        out = []
        for i in range(len(self)):
            if mask is not None and not mask[i]:
                out.append(None)
            else:
                b = data[offs[i]:offs[i + 1]]
                out.append(b.decode() if self.dtype.is_string else b)
        return out


@jax.tree_util.register_pytree_node_class
class DictionaryColumn(Column):
    """Dictionary-encoded column (arrow-array/src/array/dictionary_array.rs:243).

    codes: integer tensor (the keys); negative/any value under a null slot is
    canonicalized to 0.  values: a device-resident Column (usually
    StringColumn) holding the dictionary — keeping the dictionary on device
    keeps the whole pytree traceable with no host round-trips and no
    recompile per dictionary.
    """

    def __init__(self, codes: jnp.ndarray, values: Column,
                 validity: vd.Mask = None, *, _canonical: bool = False,
                 ordered: bool = False):
        if not _canonical:
            codes = vd.canonicalize(codes, validity)
        self.codes = codes
        self.values = values
        self.validity = validity
        self.dtype = dt.dictionary(_jax_to_logical(codes.dtype),
                                   values.dtype, ordered=ordered)

    @property
    def ordered(self) -> bool:
        return bool(self.dtype.ordered)

    def tree_flatten(self):
        aux_ord = bool(self.dtype.ordered)
        if self.validity is None:
            return (self.codes, self.values), (False, aux_ord)
        return (self.codes, self.values, self.validity), (True, aux_ord)

    @classmethod
    def tree_unflatten(cls, aux, children):
        has_validity, aux_ord = aux
        obj = cls.__new__(cls)
        obj.codes = children[0]
        obj.values = children[1]
        obj.validity = children[2] if has_validity else None
        obj.dtype = dt.dictionary(_jax_to_logical(obj.codes.dtype),
                                  obj.values.dtype, ordered=aux_ord)
        return obj

    def __len__(self):
        return int(self.codes.shape[0])

    def with_validity(self, validity):
        return DictionaryColumn(self.codes, self.values, validity,
                                ordered=self.ordered)

    def with_codes(self, codes, *, _canonical=True):
        return DictionaryColumn(codes, self.values, self.validity,
                                _canonical=_canonical,
                                ordered=self.ordered)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return DictionaryColumn(self.codes[offset:offset + length],
                                self.values, v, _canonical=True,
                                ordered=self.ordered)

    @property
    def dictionary_size(self) -> int:
        return len(self.values)


@jax.tree_util.register_pytree_node_class
class ListColumn(Column):
    """List<T> (arrow-array/src/array/list_array.rs:169): offsets + child."""

    def __init__(self, offsets: jnp.ndarray, child: Column,
                 validity: vd.Mask = None, large: bool = False):
        self.offsets = offsets
        self.child = child
        self.validity = validity
        self.dtype = (dt.large_list if large else dt.list_)(child.dtype)

    def tree_flatten(self):
        # the large_list tag must survive jit/pytree boundaries (cast
        # retags via dtype assignment; recomputing as list_ dropped it)
        large = self.dtype.name == "large_list"
        if self.validity is None:
            return (self.offsets, self.child), (False, large)
        return (self.offsets, self.child, self.validity), (True, large)

    @classmethod
    def tree_unflatten(cls, aux, children):
        has_validity, large = aux
        obj = cls.__new__(cls)
        obj.offsets = children[0]
        obj.child = children[1]
        obj.validity = children[2] if has_validity else None
        obj.dtype = (dt.large_list if large
                     else dt.list_)(obj.child.dtype)
        return obj

    def __len__(self):
        return int(self.offsets.shape[0]) - 1

    def _large(self) -> bool:
        return self.dtype.name == "large_list"

    def with_validity(self, validity):
        return ListColumn(self.offsets, self.child, validity,
                          self._large())

    def slice(self, offset, length):
        offs = self.offsets[offset:offset + length + 1]
        start, end = int(offs[0]), int(offs[-1])
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return ListColumn(offs - start,
                          self.child.slice(start, end - start), v,
                          self._large())


@jax.tree_util.register_pytree_node_class
class StructColumn(Column):
    """Struct (arrow-array/src/array/struct_array.rs:77): named children."""

    def __init__(self, children: Tuple[Column, ...], fields: Tuple[dt.Field, ...],
                 validity: vd.Mask = None):
        assert len(children) == len(fields)
        self.children = tuple(children)
        self.fields = tuple(fields)
        self.validity = validity
        self.dtype = dt.struct(self.fields)

    def tree_flatten(self):
        if self.validity is None:
            return tuple(self.children), (self.fields, False)
        return tuple(self.children) + (self.validity,), (self.fields, True)

    @classmethod
    def tree_unflatten(cls, aux, children):
        fields, has_validity = aux
        obj = cls.__new__(cls)
        if has_validity:
            obj.children = tuple(children[:-1])
            obj.validity = children[-1]
        else:
            obj.children = tuple(children)
            obj.validity = None
        obj.fields = fields
        obj.dtype = dt.struct(fields)
        return obj

    def __len__(self):
        return len(self.children[0]) if self.children else 0

    def with_validity(self, validity):
        return StructColumn(self.children, self.fields, validity)

    def slice(self, offset, length):
        v = self.validity[offset:offset + length] \
            if self.validity is not None else None
        return StructColumn(tuple(c.slice(offset, length)
                                  for c in self.children), self.fields, v)

    def field(self, name: str) -> Column:
        for f, c in zip(self.fields, self.children):
            if f.name == name:
                return c
        raise KeyError(name)


class NullColumn(Column):
    """All-null column (arrow-array NullArray)."""

    def __init__(self, length: int):
        self._length = length
        self.dtype = dt.null
        self.validity = jnp.zeros((length,), jnp.bool_)

    def __len__(self):
        return self._length

    def with_validity(self, validity):
        return self

    def slice(self, offset, length):
        return NullColumn(length)


# ---- constructors ----------------------------------------------------------

_NUMPY_TO_LOGICAL = {
    "bool": dt.bool_,
    "int8": dt.int8, "int16": dt.int16, "int32": dt.int32, "int64": dt.int64,
    "uint8": dt.uint8, "uint16": dt.uint16, "uint32": dt.uint32,
    "uint64": dt.uint64,
    "float16": dt.float16, "float32": dt.float32, "float64": dt.float64,
}


def _jax_to_logical(jdtype) -> dt.DataType:
    name = np.dtype(jdtype).name
    if name not in _NUMPY_TO_LOGICAL:
        raise ArrowTypeError(f"no logical type for {name}")
    return _NUMPY_TO_LOGICAL[name]


def column(data, dtype: Optional[dt.DataType] = None,
           validity=None) -> Column:
    """Build a Column from python list / numpy / jnp array / pyarrow array.

    The engine's make_array analogue.  Python lists may contain None (nulls).
    Strings dictionary-encode via `ops.strings.dictionary_encode` if desired;
    here they become StringColumn.
    """
    if isinstance(data, Column):
        return data
    # pyarrow is optional: an object can only be a pyarrow array if the
    # caller has imported pyarrow already
    pa = sys.modules.get("pyarrow")
    if pa is not None and isinstance(data, (pa.Array, pa.ChunkedArray)):
        from ..io.interop import column_from_pyarrow
        return column_from_pyarrow(data)
    if isinstance(data, (jnp.ndarray, np.ndarray)) and not (
            isinstance(data, np.ndarray) and data.dtype == object):
        arr = jnp.asarray(data)
        ldt = dtype or _jax_to_logical(arr.dtype)
        if dtype is not None and arr.dtype != dtype.to_jax():
            arr = arr.astype(dtype.to_jax())
        v = None if validity is None else jnp.asarray(validity, jnp.bool_)
        return PrimitiveColumn(arr, ldt, v)
    if isinstance(data, (list, tuple)):
        return _column_from_pylist(list(data), dtype, validity)
    raise ArrowTypeError(f"cannot build column from {type(data)}")


def _column_from_pylist(values: list, dtype, validity) -> Column:
    has_none = any(v is None for v in values)
    non_null = [v for v in values if v is not None]
    if dtype is None:
        if not non_null:
            return NullColumn(len(values))
        v0 = non_null[0]
        if isinstance(v0, bool):
            dtype = dt.bool_
        elif isinstance(v0, int):
            dtype = dt.int64
        elif isinstance(v0, float):
            dtype = dt.float64
        elif isinstance(v0, str):
            dtype = dt.utf8
        elif isinstance(v0, (bytes, bytearray)):
            dtype = dt.binary
        elif isinstance(v0, (list, tuple)):
            inner = _column_from_pylist(
                [x for row in non_null for x in row], None, None)
            dtype = dt.list_(inner.dtype)
        else:
            raise ArrowTypeError(f"cannot infer dtype from {type(v0)}")
    if dtype.name in ("list", "large_list"):
        # ListArray::from_iter (list_array.rs:169 FromIterator role)
        from .builders import ListBuilder, make_builder
        lb = ListBuilder(make_builder(dtype.value_type),
                         large=dtype.name == "large_list")
        for row in values:
            lb.append_null() if row is None else lb.append_value(row)
        return lb.finish()
    if dtype.is_string and dtype.name != "fixed_size_binary" \
            or dtype.name in ("binary", "large_binary", "binary_view"):
        return StringColumn.from_pylist(values, dtype)
    if dtype.name in ("decimal128", "decimal256"):
        # decimal.Decimal values scale exactly; ints are unscaled units
        import decimal as _dec
        from .builders import make_builder
        b = make_builder(dtype)
        for v in values:
            if v is None:
                b.append_null()
            elif isinstance(v, _dec.Decimal):
                scaled = v.scaleb(dtype.scale)
                if scaled != scaled.to_integral_value():
                    raise ArrowInvalid(f"{v} does not fit scale "
                                       f"{dtype.scale}")
                b.append(int(scaled))
            else:
                b.append(int(v) * 10 ** dtype.scale)
        return b.finish()
    if dtype.name == "interval" and dtype.unit == "month_day_nano":
        from .nested import IntervalMDNColumn
        m, d_, nn = [], [], []
        for v in values:
            if v is None:
                m.append(0), d_.append(0), nn.append(0)
            elif isinstance(v, dict):
                m.append(v.get("months", 0)), d_.append(v.get("days", 0))
                nn.append(v.get("nanoseconds", 0))
            else:
                mm, dd, ns = v
                m.append(mm), d_.append(dd), nn.append(ns)
        mk = None
        if has_none or validity is not None:
            mk = jnp.asarray([v is not None for v in values], jnp.bool_) \
                if validity is None else jnp.asarray(validity, jnp.bool_)
        return IntervalMDNColumn(jnp.asarray(np.asarray(m, np.int32)),
                                 jnp.asarray(np.asarray(d_, np.int32)),
                                 jnp.asarray(np.asarray(nn, np.int64)), mk)
    if dtype.name == "struct":
        from .builders import make_builder
        kids = []
        for i, f in enumerate(dtype.fields):
            kids.append(_column_from_pylist(
                [None if row is None else
                 (row.get(f.name) if isinstance(row, dict) else row[i])
                 for row in values], f.dtype, None))
        mk = None
        if has_none:
            mk = jnp.asarray([v is not None for v in values], jnp.bool_)
        return StructColumn(tuple(kids), tuple(dtype.fields), mk)
    if dtype.name in ("fixed_size_binary", "fixed_size_list", "map",
                      "dictionary"):
        from .builders import make_builder
        b = make_builder(dtype)
        for v in values:
            b.append_null() if v is None else b.append(v)
        out = b.finish()
        if dtype.name == "dictionary" and \
                out.codes.dtype != dtype.index_type.to_jax():
            out = DictionaryColumn(out.codes.astype(dtype.index_type
                                                    .to_jax()),
                                   out.values, out.validity,
                                   _canonical=True)
        return out
    mask = None
    if has_none or validity is not None:
        mask = jnp.asarray([v is not None for v in values], jnp.bool_) \
            if validity is None else jnp.asarray(validity, jnp.bool_)
    np_dtype = np.dtype(dtype.to_jax())
    filled = np.asarray([0 if v is None else v for v in values],
                        dtype=np_dtype)
    return PrimitiveColumn(jnp.asarray(filled), dtype, mask)
