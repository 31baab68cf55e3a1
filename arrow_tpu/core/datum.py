"""Datum: scalar-vs-array broadcasting for kernel arguments.

Mirrors the reference's `Datum` trait + `Scalar` wrapper
(arrow-array/src/scalar.rs:78,128): every binary kernel accepts
(array, array), (array, scalar) or (scalar, array) and broadcasts.
On the device a scalar is a rank-0 tensor — XLA broadcasts for free, so
unlike the reference no specialized scalar code paths are needed; kernels
just call `broadcast_values`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..errors import ArrowTypeError
from .column import Column, PrimitiveColumn, column as make_column
from . import validity as vd

__all__ = ["Scalar", "Datum", "scalar", "as_datum", "broadcast_pair"]


@jax.tree_util.register_pytree_node_class
class Scalar:
    """A single (possibly null) value with a logical type."""

    def __init__(self, value, dtype: dt.DataType, valid: bool = True):
        if not isinstance(value, jnp.ndarray):
            value = jnp.asarray(0 if not valid else value,
                                dtype=dtype.to_jax())
        self.value = value          # rank-0 device tensor
        self.dtype = dtype
        self.valid = valid          # static python bool

    def tree_flatten(self):
        return (self.value,), (self.dtype, self.valid)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.value = children[0]
        obj.dtype, obj.valid = aux
        return obj

    def as_py(self):
        """Host value (None when null)."""
        if not self.valid:
            return None
        v = np.asarray(self.value).item()
        return v

    def __repr__(self):
        v = self.value if self.valid else None
        return f"Scalar<{self.dtype!r}>({v})"


Datum = Union[Column, Scalar]


def scalar(value, dtype: Optional[dt.DataType] = None) -> Scalar:
    if value is None:
        if dtype is None:
            raise ArrowTypeError("null scalar requires a dtype")
        return Scalar(0, dtype, valid=False)
    if dtype is None:
        if isinstance(value, (bool, np.bool_)):
            dtype = dt.bool_
        elif isinstance(value, (int, np.integer)):
            dtype = dt.int64
        elif isinstance(value, (float, np.floating)):
            dtype = dt.float64
        else:
            raise ArrowTypeError(f"cannot infer scalar dtype for {type(value)}")
    return Scalar(value, dtype)


def as_datum(x) -> Datum:
    if isinstance(x, (Column, Scalar)):
        return x
    if isinstance(x, (bool, int, float, np.generic)) or x is None:
        return scalar(x)
    return make_column(x)


def broadcast_pair(lhs: Datum, rhs: Datum
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, vd.Mask, int,
                              dt.DataType, dt.DataType]:
    """Resolve (lhs, rhs) datums to equal-length value tensors + joint mask.

    Returns (l_values, r_values, joint_validity, length, l_dtype, r_dtype).
    Mirrors the length/broadcast rules of arrow-arith binary kernels
    (arrow-arith/src/arity.rs:29-305); scalar nullness folds into the mask.
    """
    lhs, rhs = as_datum(lhs), as_datum(rhs)
    if isinstance(lhs, Scalar) and isinstance(rhs, Scalar):
        raise ArrowTypeError("at least one side must be a Column")

    def parts(x, n):
        if isinstance(x, Scalar):
            vals = jnp.broadcast_to(x.value, (n,))
            mask = None if x.valid else jnp.zeros((n,), jnp.bool_)
            return vals, mask, x.dtype
        if not isinstance(x, PrimitiveColumn):
            raise ArrowTypeError(
                f"binary kernel expects primitive columns, got {type(x)}")
        return x.values, x.validity, x.dtype

    n = len(lhs) if isinstance(lhs, Column) else len(rhs)
    if isinstance(lhs, Column) and isinstance(rhs, Column) and \
            len(lhs) != len(rhs):
        raise ArrowTypeError(
            f"length mismatch: {len(lhs)} vs {len(rhs)}")
    lv, lm, ldt = parts(lhs, n)
    rv, rm, rdt = parts(rhs, n)
    return lv, rv, vd.union(lm, rm), n, ldt, rdt
