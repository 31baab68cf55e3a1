"""Logical type system.

Device-native re-design of the reference's arrow-schema crate
(arrow-schema/src/datatype.rs:97-441): the same logical-type vocabulary, but
each logical type maps onto a *physical device representation* chosen for
XLA (static shapes, SoA tensors, dense bool validity masks) rather than
the reference's byte-buffer layouts.

Physical mapping summary:
  - fixed-width primitives  -> one jnp array of the matching width
  - Boolean                 -> jnp bool_ array (dense, not bit-packed; the VPU
                               operates on vector lanes, not CPU words)
  - Timestamp/Date/Time/Duration -> integer tensor + unit/tz metadata
  - Utf8/Binary             -> Arrow-layout (offsets int32/int64, data uint8)
                               device tensors, or dictionary-encoded codes
  - Dictionary              -> int code tensor + device-resident value column
  - Decimal128              -> two int64 limb tensors (hi, lo)  [round 2]
  - List/Struct             -> offset tensor + child columns (pytree nesting)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "DataType", "null", "bool_", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
    "utf8", "large_utf8", "utf8_view", "binary", "large_binary",
    "binary_view", "fixed_size_binary", "date32", "date64",
    "timestamp", "time32", "time64", "duration", "interval",
    "decimal32", "decimal64", "decimal128", "decimal256",
    "dictionary", "list_", "large_list", "list_view", "large_list_view",
    "struct", "fixed_size_list",
    "map_", "union", "run_end_encoded",
    "Field", "Schema", "ExtensionType",
    "uuid", "json_", "bool8", "fixed_shape_tensor", "opaque",
]


@dataclass(frozen=True)
class DataType:
    """A logical Arrow data type (cf. arrow-schema/src/datatype.rs:97)."""

    name: str
    # parametric payloads (None when not applicable)
    unit: Optional[str] = None        # 's' | 'ms' | 'us' | 'ns'
    tz: Optional[str] = None          # timestamp timezone
    precision: Optional[int] = None   # decimal precision
    scale: Optional[int] = None       # decimal scale
    index_type: Optional["DataType"] = None   # dictionary key / run-end type
    value_type: Optional["DataType"] = None   # dictionary/list value type
    fields: Optional[Tuple["Field", ...]] = None  # struct/union children
    list_size: Optional[int] = None   # fixed-size list / fixed-size binary
    mode: Optional[str] = None        # union: 'sparse' | 'dense'
    type_ids: Optional[Tuple[int, ...]] = None  # union child type ids
    # dictionary: values are sorted and code order IS value order
    # (datatype.rs Dictionary ordered bool; IPC isOrdered).  None (not
    # False) when unordered so equality matches pre-flag constructions.
    ordered: Optional[bool] = None

    # ---- categories ------------------------------------------------------
    @property
    def is_integer(self) -> bool:
        return self.name in _INT_NAMES

    @property
    def is_signed_integer(self) -> bool:
        return self.name in ("int8", "int16", "int32", "int64")

    @property
    def is_unsigned_integer(self) -> bool:
        return self.name in ("uint8", "uint16", "uint32", "uint64")

    @property
    def is_floating(self) -> bool:
        return self.name in ("float16", "float32", "float64")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_decimal(self) -> bool:
        return self.name in ("decimal32", "decimal64", "decimal128",
                             "decimal256")

    @property
    def is_temporal(self) -> bool:
        return self.name in ("timestamp", "date32", "date64",
                             "time32", "time64", "duration", "interval")

    @property
    def is_boolean(self) -> bool:
        return self.name == "bool"

    @property
    def is_string(self) -> bool:
        return self.name in ("utf8", "large_utf8", "utf8_view")

    @property
    def is_binary(self) -> bool:
        return self.name in ("binary", "large_binary", "binary_view",
                             "fixed_size_binary")

    @property
    def is_dictionary(self) -> bool:
        return self.name == "dictionary"

    @property
    def is_run_end_encoded(self) -> bool:
        return self.name == "run_end_encoded"

    @property
    def is_union(self) -> bool:
        return self.name == "union"

    @property
    def is_nested(self) -> bool:
        return self.name in ("list", "large_list", "list_view",
                             "large_list_view", "fixed_size_list",
                             "struct", "map", "union", "run_end_encoded")

    @property
    def is_null(self) -> bool:
        return self.name == "null"

    @property
    def is_primitive(self) -> bool:
        """Fixed-width, single-tensor representable."""
        if self.is_decimal:
            return False
        if self.name == "interval" and self.unit == "month_day_nano":
            return False      # 128-bit: IntervalMDNColumn (two tensors)
        return self.is_numeric or self.is_boolean or self.is_temporal

    # ---- physical mapping -------------------------------------------------
    def to_jax(self):
        """jnp dtype of the physical value tensor for this logical type."""
        m = _JAX_DTYPE.get(self.name)
        if m is not None:
            return m
        if self.name == "timestamp" or self.name == "duration":
            return jnp.int64
        if self.name == "time32":
            return jnp.int32
        if self.name == "time64":
            return jnp.int64
        if self.name == "decimal32":
            return jnp.int32
        if self.name == "decimal64":
            return jnp.int64
        if self.name == "interval":
            # year_month: i32 months; day_time: i64 (days<<32 | millis).
            # month_day_nano is 128-bit -> IntervalMDNColumn (two tensors)
            if self.unit == "year_month":
                return jnp.int32
            if self.unit == "day_time":
                return jnp.int64
            raise TypeError("interval[month_day_nano] is two-tensor")
        if self.name == "dictionary":
            return self.index_type.to_jax()
        raise TypeError(f"{self} has no single-tensor physical dtype")

    def to_numpy(self):
        return np.dtype(self.to_jax().__name__ if hasattr(self.to_jax(), "__name__")
                        else self.to_jax())

    @property
    def byte_width(self) -> int:
        return np.dtype(self.to_jax()).itemsize

    @property
    def bit_width(self) -> int:
        if self.name == "bool":
            return 1
        return self.byte_width * 8

    def __repr__(self) -> str:
        if self.name == "timestamp":
            return f"timestamp[{self.unit}{', tz=' + self.tz if self.tz else ''}]"
        if self.name in ("time32", "time64", "duration", "interval"):
            return f"{self.name}[{self.unit}]"
        if self.is_decimal:
            return f"{self.name}({self.precision}, {self.scale})"
        if self.name == "fixed_size_binary":
            return f"fixed_size_binary({self.list_size})"
        if self.name == "dictionary":
            return f"dictionary<{self.index_type!r}, {self.value_type!r}>"
        if self.name in ("list", "large_list", "list_view",
                         "large_list_view"):
            return f"{self.name}<{self.value_type!r}>"
        if self.name == "fixed_size_list":
            return f"fixed_size_list<{self.value_type!r}, {self.list_size}>"
        if self.name == "struct":
            inner = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.fields or ())
            return f"struct<{inner}>"
        if self.name == "union":
            inner = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.fields or ())
            return f"union<{inner}; mode={self.mode}>"
        if self.name == "run_end_encoded":
            return f"run_end_encoded<{self.index_type!r}, {self.value_type!r}>"
        return self.name


_INT_NAMES = ("int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64")

_JAX_DTYPE = {
    "bool": jnp.bool_,
    "int8": jnp.int8, "int16": jnp.int16, "int32": jnp.int32, "int64": jnp.int64,
    "uint8": jnp.uint8, "uint16": jnp.uint16, "uint32": jnp.uint32,
    "uint64": jnp.uint64,
    "float16": jnp.float16, "float32": jnp.float32, "float64": jnp.float64,
    "date32": jnp.int32, "date64": jnp.int64,
}

# ---- singletons -----------------------------------------------------------
null = DataType("null")
bool_ = DataType("bool")
int8 = DataType("int8")
int16 = DataType("int16")
int32 = DataType("int32")
int64 = DataType("int64")
uint8 = DataType("uint8")
uint16 = DataType("uint16")
uint32 = DataType("uint32")
uint64 = DataType("uint64")
float16 = DataType("float16")
float32 = DataType("float32")
float64 = DataType("float64")
utf8 = DataType("utf8")
large_utf8 = DataType("large_utf8")
utf8_view = DataType("utf8_view")
binary = DataType("binary")
large_binary = DataType("large_binary")
binary_view = DataType("binary_view")
date32 = DataType("date32")
date64 = DataType("date64")


def fixed_size_binary(byte_width: int) -> DataType:
    """FixedSizeBinary(w) (arrow-schema/src/datatype.rs FixedSizeBinary);
    the width rides in `list_size`."""
    return DataType("fixed_size_binary", list_size=byte_width)


def timestamp(unit: str = "us", tz: Optional[str] = None) -> DataType:
    assert unit in ("s", "ms", "us", "ns"), unit
    return DataType("timestamp", unit=unit, tz=tz)


def time32(unit: str = "s") -> DataType:
    assert unit in ("s", "ms"), unit
    return DataType("time32", unit=unit)


def time64(unit: str = "us") -> DataType:
    assert unit in ("us", "ns"), unit
    return DataType("time64", unit=unit)


def duration(unit: str = "us") -> DataType:
    assert unit in ("s", "ms", "us", "ns"), unit
    return DataType("duration", unit=unit)


def interval(unit: str = "month_day_nano") -> DataType:
    """Interval(YearMonth | DayTime | MonthDayNano)
    (arrow-buffer/src/interval.rs; datatype.rs Interval)."""
    assert unit in ("year_month", "day_time", "month_day_nano"), unit
    return DataType("interval", unit=unit)


def decimal32(precision: int, scale: int) -> DataType:
    assert 1 <= precision <= 9
    return DataType("decimal32", precision=precision, scale=scale)


def decimal64(precision: int, scale: int) -> DataType:
    assert 1 <= precision <= 18
    return DataType("decimal64", precision=precision, scale=scale)


def decimal128(precision: int, scale: int) -> DataType:
    assert 1 <= precision <= 38
    return DataType("decimal128", precision=precision, scale=scale)


def decimal256(precision: int, scale: int) -> DataType:
    """256-bit decimal (the i256 analog, arrow-buffer/src/bigint/mod.rs);
    stored as 4 x u64 little-endian limb tensors."""
    assert 1 <= precision <= 76
    return DataType("decimal256", precision=precision, scale=scale)


def dictionary(index_type: DataType, value_type: DataType,
               ordered: bool = False) -> DataType:
    assert index_type.is_integer
    return DataType("dictionary", index_type=index_type,
                    value_type=value_type,
                    ordered=True if ordered else None)


def list_(value_type: DataType) -> DataType:
    return DataType("list", value_type=value_type)


def large_list(value_type: DataType) -> DataType:
    """LargeList: 64-bit offsets at the boundary; device representation is
    identical to list (offsets are already int64 tensors on device)."""
    return DataType("large_list", value_type=value_type)


def list_view(value_type: DataType) -> DataType:
    """ListView: offsets + sizes layout (datatype.rs ListView; arrays may
    share/overlap child ranges and need not be in order)."""
    return DataType("list_view", value_type=value_type)


def large_list_view(value_type: DataType) -> DataType:
    return DataType("large_list_view", value_type=value_type)


def union(fields, mode: str = "sparse", type_ids=None) -> DataType:
    """Union(sparse|dense) (arrow-array/src/array/union_array.rs:123)."""
    assert mode in ("sparse", "dense"), mode
    fields = tuple(fields)
    tids = tuple(type_ids) if type_ids is not None \
        else tuple(range(len(fields)))
    assert len(tids) == len(fields)
    return DataType("union", fields=fields, mode=mode, type_ids=tids)


def run_end_encoded(run_end_type: DataType, value_type: DataType
                    ) -> DataType:
    """RunEndEncoded (arrow-array/src/array/run_array.rs:63); the run-end
    integer type rides in `index_type`."""
    assert run_end_type.name in ("int16", "int32", "int64")
    return DataType("run_end_encoded", index_type=run_end_type,
                    value_type=value_type)


def fixed_size_list(value_type: DataType, list_size: int) -> DataType:
    return DataType("fixed_size_list", value_type=value_type,
                    list_size=list_size)


def struct(fields) -> DataType:
    return DataType("struct", fields=tuple(fields))


def _merge_field_lists(existing, incoming):
    """SchemaBuilder::try_merge role (schema.rs:98): merge by name,
    append new names in arrival order."""
    out = list(existing)
    index = {f.name: i for i, f in enumerate(out)}
    for f in incoming:
        i = index.get(f.name)
        if i is None:
            index[f.name] = len(out)
            out.append(f)
        else:
            out[i] = out[i].try_merge(f)
    return out


def map_(key_type: DataType, item_type: DataType) -> DataType:
    kv = struct([Field("key", key_type, nullable=False),
                 Field("value", item_type)])
    return DataType("map", value_type=kv)


# ---- extension types (arrow-schema/src/extension/mod.rs:188) ---------------

@dataclass(frozen=True)
class ExtensionType:
    """A logical type layered on a storage DataType via field metadata
    (keys ARROW:extension:name / ARROW:extension:metadata, like the
    reference's ExtensionType trait)."""

    extension_name: str
    storage: DataType
    extension_metadata: str = ""

    def field_metadata(self) -> Tuple[Tuple[str, str], ...]:
        md = (("ARROW:extension:name", self.extension_name),)
        if self.extension_metadata:
            md += (("ARROW:extension:metadata", self.extension_metadata),)
        return md

    def __repr__(self):
        return f"extension<{self.extension_name}, {self.storage!r}>"


def uuid() -> ExtensionType:
    """arrow.uuid (extension/canonical/uuid.rs)."""
    return ExtensionType("arrow.uuid", fixed_size_binary(16))


def json_(storage: DataType = utf8) -> ExtensionType:
    """arrow.json (extension/canonical/json.rs)."""
    assert storage.is_string
    return ExtensionType("arrow.json", storage)


def bool8() -> ExtensionType:
    """arrow.bool8 (extension/canonical/bool8.rs): bools as int8 storage."""
    return ExtensionType("arrow.bool8", int8)


def fixed_shape_tensor(value_type: DataType, shape) -> ExtensionType:
    """arrow.fixed_shape_tensor (extension/canonical/fixed_shape_tensor.rs)."""
    import json as _json
    size = 1
    for s in shape:
        size *= int(s)
    return ExtensionType("arrow.fixed_shape_tensor",
                         fixed_size_list(value_type, size),
                         _json.dumps({"shape": list(map(int, shape))}))


def opaque(storage: DataType, type_name: str, vendor_name: str
           ) -> ExtensionType:
    """arrow.opaque (extension/canonical/opaque.rs)."""
    import json as _json
    return ExtensionType(
        "arrow.opaque", storage,
        _json.dumps({"type_name": type_name, "vendor_name": vendor_name}))


# ---- numeric promotion helpers (used by arith kernels & cast) -------------

_RANK = {n: i for i, n in enumerate(
    ("int8", "int16", "int32", "int64"))}
_URANK = {n: i for i, n in enumerate(
    ("uint8", "uint16", "uint32", "uint64"))}
_FRANK = {n: i for i, n in enumerate(("float16", "float32", "float64"))}

INT_MIN = {n: -(2 ** (8 * 2 ** i - 1)) for i, n in enumerate(
    ("int8", "int16", "int32", "int64"))}
INT_MAX = {n: 2 ** (8 * 2 ** i - 1) - 1 for i, n in enumerate(
    ("int8", "int16", "int32", "int64"))}
UINT_MAX = {n: 2 ** (8 * 2 ** i) - 1 for i, n in enumerate(
    ("uint8", "uint16", "uint32", "uint64"))}


def integer_bounds(dt: DataType):
    """(lo, hi) inclusive value bounds of an integer logical type."""
    if dt.is_signed_integer:
        return INT_MIN[dt.name], INT_MAX[dt.name]
    if dt.is_unsigned_integer:
        return 0, UINT_MAX[dt.name]
    raise TypeError(f"not an integer type: {dt}")


# ---- Field / Schema (cf. arrow-schema/src/{field.rs,schema.rs}) ------------

@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    metadata: Tuple[Tuple[str, str], ...] = ()

    def with_name(self, name: str) -> "Field":
        return dataclasses.replace(self, name=name)

    def with_nullable(self, nullable: bool) -> "Field":
        return dataclasses.replace(self, nullable=nullable)

    def try_merge(self, other: "Field") -> "Field":
        """Unify with a same-named field from another schema
        (arrow-schema/src/field.rs:697 Field::try_merge): metadata
        unions with per-key conflict errors, struct/list children merge
        recursively, Null widens to the other type, otherwise dtypes
        must match; nullability ORs."""
        from .errors import SchemaError
        meta = dict(self.metadata)
        for k, v in other.metadata:
            if k in meta and meta[k] != v:
                raise SchemaError(
                    f"conflicting metadata for key {k!r} merging field "
                    f"{self.name!r}")
            meta[k] = v
        sd, od = self.dtype, other.dtype
        if sd.name == "null":
            dtype, nullable = od, True
        elif od.name == "null":
            dtype, nullable = sd, True
        elif sd.name == "struct":
            if od.name != "struct":
                raise SchemaError(
                    f"field {self.name!r}: {od!r} is not struct")
            dtype = struct(_merge_field_lists(sd.fields, od.fields))
            nullable = self.nullable or other.nullable
        elif sd.name in ("list", "large_list"):
            if od.name != sd.name:
                raise SchemaError(
                    f"field {self.name!r}: {od!r} is not {sd.name}")
            elem = Field("item", sd.value_type).try_merge(
                Field("item", od.value_type))
            dtype = DataType(sd.name, value_type=elem.dtype)
            nullable = self.nullable or other.nullable
        else:
            if sd != od:
                raise SchemaError(
                    f"field {self.name!r}: {od!r} does not equal {sd!r}")
            dtype = sd
            nullable = self.nullable or other.nullable
        return Field(self.name, dtype, nullable, tuple(meta.items()))


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]
    metadata: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def names(self):
        return [f.name for f in self.fields]

    def field(self, i) -> Field:
        if isinstance(i, str):
            return self.fields[self.index_of(i)]
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def project(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices), self.metadata)

    @staticmethod
    def try_merge(schemas) -> "Schema":
        """Unify schemas field-by-field (arrow-schema/src/schema.rs:295
        Schema::try_merge): fields match by name (new names append),
        schema metadata unions with per-key conflict errors."""
        from .errors import SchemaError
        meta: dict = {}
        fields: list = []
        for s in schemas:
            for k, v in s.metadata:
                if k in meta and meta[k] != v:
                    raise SchemaError(
                        f"conflicting schema metadata for key {k!r}")
                meta[k] = v
            fields = _merge_field_lists(fields, s.fields)
        return Schema(tuple(fields), tuple(meta.items()))

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)
