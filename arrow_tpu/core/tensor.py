"""Tensor type (arrow facade src/tensor.rs): a dense n-dimensional value
container over one device buffer, with shape/strides/dim-names metadata.

On the device the natural representation IS a jnp.ndarray; this wrapper
adds the Arrow Tensor API surface (shape, strides in bytes, dimension names,
row/column-major predicates) and pyarrow interchange.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..errors import ArrowInvalid

__all__ = ["Tensor"]


class Tensor:
    def __init__(self, data: jnp.ndarray,
                 dim_names: Optional[Sequence[str]] = None):
        self.data = jnp.asarray(data)
        if dim_names is not None and len(dim_names) != self.data.ndim:
            raise ArrowInvalid("dim_names length != ndim")
        self.dim_names = tuple(dim_names) if dim_names is not None else None

    # -- Arrow Tensor API (tensor.rs) -----------------------------------
    @property
    def dtype(self) -> dt.DataType:
        from .column import _jax_to_logical
        return _jax_to_logical(self.data.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return int(np.prod(self.data.shape)) if self.data.shape else 1

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major byte strides (device tensors are dense row-major)."""
        item = np.dtype(self.data.dtype).itemsize
        out = []
        acc = item
        for s in reversed(self.shape):
            out.append(acc)
            acc *= s
        return tuple(reversed(out))

    def dim_name(self, i: int) -> Optional[str]:
        return None if self.dim_names is None else self.dim_names[i]

    def is_contiguous(self) -> bool:
        return True

    def is_row_major(self) -> bool:
        return True

    def is_column_major(self) -> bool:
        return self.ndim <= 1

    # -- interchange ------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)

    def to_pyarrow(self):
        import pyarrow as pa
        return pa.Tensor.from_numpy(self.to_numpy(),
                                    dim_names=list(self.dim_names)
                                    if self.dim_names else None)

    @staticmethod
    def from_pyarrow(t) -> "Tensor":
        names = list(t.dim_names) if t.dim_names else None
        return Tensor(jnp.asarray(t.to_numpy()), names)

    def __repr__(self):
        names = f", dim_names={self.dim_names}" if self.dim_names else ""
        return f"Tensor(shape={self.shape}, dtype={self.dtype!r}{names})"
