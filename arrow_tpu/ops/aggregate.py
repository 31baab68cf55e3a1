"""Whole-array reductions: sum/min/max/count/bool_and/bool_or.

Mirrors arrow-arith/src/aggregate.rs.  The reference's LANES-array
accumulator design (aggregate.rs:98-145,277) exists to coax SIMD out of a
scalar compiler; on the device a reduction IS the native XLA primitive, so the
kernels are direct masked reductions.

Semantics matched:
  - nulls are skipped; empty or all-null input -> null scalar
  - min/max on floats use IEEE totalOrder via the row-format key transform
    (reference ArrowNativeTypeOp::compare semantics: NaN > +inf)
  - `sum` wraps on integer overflow (aggregate.rs sum), `sum_checked`
    raises ArithmeticOverflow (aggregate.rs:819 try_ variants); the checked
    path for int64 verifies against exact big-int host arithmetic since no
    wider device type exists
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, DictionaryColumn, PrimitiveColumn, StringColumn
from ..core.datum import Scalar
from ..errors import ArithmeticOverflow, ArrowTypeError

__all__ = ["sum_", "sum_checked", "min_", "max_", "count", "count_nulls",
           "bool_and", "bool_or", "bit_and", "bit_or", "bit_xor",
           "min_max"]


def _valid_count(col: Column) -> int:
    return len(col) - col.null_count


def sum_(col: PrimitiveColumn) -> Scalar:
    """Wrapping sum (aggregate.rs sum_array)."""
    if col.dtype.is_decimal:
        return _decimal_reduce(col, "sum")
    if not col.dtype.is_numeric:
        raise ArrowTypeError(f"sum of {col.dtype!r}")
    if _valid_count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    vals = vd.canonicalize(col.values, col.validity)  # nulls -> 0
    # accumulate in T: integer sums wrap in-type like the reference
    return Scalar(jnp.sum(vals, dtype=vals.dtype), col.dtype)


def sum_checked(col: PrimitiveColumn) -> Scalar:
    if not col.dtype.is_integer:
        return sum_(col)
    if _valid_count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    vals = vd.canonicalize(col.values, col.validity)
    if col.dtype.byte_width < 8:
        wide = jnp.sum(vals.astype(jnp.int64))
        lo, hi = dt.integer_bounds(col.dtype)
        if bool((wide < lo) | (wide > hi)):
            raise ArithmeticOverflow("sum overflowed")
        return Scalar(wide.astype(col.dtype.to_jax()), col.dtype)
    # int64/uint64: exact big-int verification on host (eager path only)
    device_sum = jnp.sum(vals)
    exact = int(np.asarray(vals).astype(object).sum())
    lo, hi = dt.integer_bounds(col.dtype)
    if exact < lo or exact > hi:
        raise ArithmeticOverflow("sum overflowed")
    return Scalar(device_sum, col.dtype)


def _total_order_reduce(col: Column, want_max: bool):
    """min/max via the order-preserving u64 key (handles NaN/null/strings
    uniformly); returns index of the extremum among valid slots."""
    from .row_format import encode_value_key
    key, validity = encode_value_key(col)
    if validity is None:
        idx = jnp.argmax(key) if want_max else jnp.argmin(key)
        return int(idx)
    # sentinel keys can TIE with extreme valid values (i64::MIN encodes
    # to key 0), so find the extremum among valid keys first, then the
    # first valid slot holding it — never a null slot
    sentinel = jnp.uint64(0) if want_max else \
        jnp.uint64(0xFFFFFFFFFFFFFFFF)
    masked = jnp.where(validity, key, sentinel)
    m = jnp.max(masked) if want_max else jnp.min(masked)
    idx = jnp.argmax(validity & (key == m))
    return int(idx)


def min_max(col: Column):
    """(min, max) scalars."""
    return min_(col), max_(col)


def _extremum(col: Column, want_max: bool) -> Scalar:
    if col.dtype.is_decimal:
        return _decimal_reduce(col, "max" if want_max else "min")
    if _valid_count(col) == 0:
        if col.dtype.is_primitive:
            return Scalar(0, col.dtype, valid=False)
        return _PyScalar(None, col.dtype)
    i = _total_order_reduce(col, want_max)
    if isinstance(col, PrimitiveColumn):
        return Scalar(col.values[i], col.dtype)
    # string/dictionary extrema (aggregate.rs:507-552 min_string/max_binary)
    val = col.to_pylist()[i]
    return _PyScalar(val, col.dtype)


class _PyScalar(Scalar):
    """Scalar carrying a host python value (string extrema)."""

    def __init__(self, value, dtype):
        self._py = value
        self.value = None
        self.dtype = dtype
        self.valid = value is not None

    def as_py(self):
        return self._py

    def tree_flatten(self):  # pragma: no cover
        raise TypeError("_PyScalar is host-only")


def min_(col: Column) -> Scalar:
    return _extremum(col, want_max=False)


def max_(col: Column) -> Scalar:
    return _extremum(col, want_max=True)


def count(col: Column) -> int:
    """Non-null count."""
    return len(col) - col.null_count


def count_nulls(col: Column) -> int:
    return col.null_count


def bool_and(col: PrimitiveColumn) -> Scalar:
    """AND of all non-null values (aggregate.rs:754)."""
    if not col.dtype.is_boolean:
        raise ArrowTypeError("bool_and on non-boolean")
    if _valid_count(col) == 0:
        return Scalar(False, dt.bool_, valid=False)
    vals = jnp.where(col.is_valid_mask(), col.values, True)
    return Scalar(jnp.all(vals), dt.bool_)


def bool_or(col: PrimitiveColumn) -> Scalar:
    if not col.dtype.is_boolean:
        raise ArrowTypeError("bool_or on non-boolean")
    if _valid_count(col) == 0:
        return Scalar(False, dt.bool_, valid=False)
    vals = jnp.where(col.is_valid_mask(), col.values, False)
    return Scalar(jnp.any(vals), dt.bool_)


def _bit_reduce(col: PrimitiveColumn, op: str) -> Scalar:
    """bit_and / bit_or / bit_xor over non-null values
    (aggregate.rs:719-752); null rows contribute the identity."""
    if not col.dtype.is_integer:
        raise ArrowTypeError(f"{op} on non-integer {col.dtype!r}")
    if _valid_count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    v = col.values
    if op == "bit_and":
        ident = jnp.asarray(-1, v.dtype) if col.dtype.is_signed_integer \
            else jnp.asarray(np.iinfo(np.dtype(v.dtype)).max, v.dtype)
        fn = jnp.bitwise_and
    else:
        ident = jnp.zeros((), v.dtype)
        fn = jnp.bitwise_or if op == "bit_or" else jnp.bitwise_xor
    if col.validity is not None:
        v = jnp.where(col.is_valid_mask(), v, ident)
    out = jax.lax.reduce(v, ident, lambda a, b: fn(a, b), (0,))
    return Scalar(out, col.dtype)


def bit_and(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_and")


def bit_or(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_or")


def bit_xor(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_xor")


def _decimal_reduce(col, op: str) -> Scalar:
    """Decimal whole-array reductions (aggregate.rs decimal arms):
    host-exact python ints at any width; result keeps the input type."""
    from ..core.nested import DecimalColumn
    import numpy as np
    if isinstance(col, DecimalColumn):
        vals = [v for v in col.to_pyints() if v is not None]
    else:
        raw = np.asarray(col.values)
        valid = None if col.validity is None else np.asarray(col.validity)
        vals = [int(x) for i, x in enumerate(raw)
                if valid is None or valid[i]]
    if not vals:
        return _PyScalar(None, col.dtype)
    r = {"sum": sum, "min": min, "max": max}[op](vals)
    from decimal import Decimal
    out = Decimal(r).scaleb(-col.dtype.scale)
    return _PyScalar(out, col.dtype)
