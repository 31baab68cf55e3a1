"""Dynamic comparators (arrow-ord/src/ord.rs:28 make_comparator).

make_comparator(a, b, options) returns cmp(i, j) -> -1|0|1 comparing
a[i] with b[j] under SortOptions — the reference's building block for
merge operators and generic sorting of arbitrary types.  Here the
comparator rides the engine's order-preserving u64 key encoding
(ops.row_format, the arrow-row fixed.rs map), pulled to host once per
array; nested types compare via their encoded key stacks.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..core.column import Column
from .row_format import SortOptions, encode_keys

__all__ = ["make_comparator", "make_lexicographic_comparator"]


def _key_matrix(col: Column, opt: SortOptions) -> np.ndarray:
    """(n, k) uint64 key stack; lexicographic row order == column order.

    Validity is forced explicit so both sides of a comparator produce
    the same key-stack shape (encode_keys omits the null-class key for
    columns without a validity mask)."""
    import jax.numpy as jnp
    if col.validity is None:
        col = col.with_validity(jnp.ones((len(col),), jnp.bool_))
    keys = encode_keys([col], [opt])
    return np.stack([np.asarray(k) for k in keys], axis=1)


def make_comparator(a: Column, b: Column,
                    options: SortOptions = SortOptions()
                    ) -> Callable[[int, int], int]:
    """cmp(i, j): order of a[i] vs b[j] (ord.rs:28), nested types
    included (the reference's headline use: cmp kernels reject nested
    and point here).  Nested ranks must agree ACROSS both arrays, so
    they are computed over the concatenation."""
    if a.dtype != b.dtype:
        raise TypeError(f"comparator type mismatch {a.dtype} vs {b.dtype}")
    from .row_format import _host_rankable, _host_rank_parts
    if _host_rankable(a):
        import jax.numpy as jnp
        from .. import dtypes as dt
        from ..core.column import PrimitiveColumn
        from .concat import concat
        vals, _, _, validity = _host_rank_parts(concat([a, b]), options)
        proxy = PrimitiveColumn(vals, dt.uint32, validity)
        stacked = _key_matrix(proxy, options)
        ka, kb = stacked[:len(a)], stacked[len(a):]
    else:
        # string/dictionary keys are RANKS of each array's distinct
        # values — only comparable when computed over the CONCAT of
        # both arrays (per-array ranks mis-ordered 'b' vs 'b')
        from .concat import concat
        stacked = _key_matrix(concat([a, b]), options)
        ka, kb = stacked[:len(a)], stacked[len(a):]

    def cmp(i: int, j: int) -> int:
        ra, rb = ka[i], kb[j]
        for x, y in zip(ra, rb):
            if x != y:
                return -1 if x < y else 1
        return 0

    return cmp


def make_lexicographic_comparator(
        left: Sequence[Column], right: Sequence[Column],
        options: Sequence[SortOptions]) -> Callable[[int, int], int]:
    """Multi-column comparator (the LexicographicalComparator of
    sort.rs:865, over two batches)."""
    cmps = [make_comparator(a, b, o)
            for a, b, o in zip(left, right, options)]

    def cmp(i: int, j: int) -> int:
        for c in cmps:
            r = c(i, j)
            if r:
                return r
        return 0

    return cmp
