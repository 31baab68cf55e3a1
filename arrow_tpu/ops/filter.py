"""filter: select rows where a boolean predicate is true.

Re-design of arrow-select/src/filter.rs.  The reference picks between a
run-memcpy strategy and an index-gather strategy at selectivity 0.8
(filter.rs:42,268-285) — a CPU-cache heuristic.  Here compaction is one
stable PARTITION, which carries every column of the batch in one device
sort instead of one gather per column:

    keep = predicate_values AND predicate_validity     (prep_null_mask,
                                                        filter.rs:116)
    count = popcount(keep)                              (filter.rs:111)
    one stable multi-operand sort keyed on NOT keep    -- moves every
        column's kept rows to the front in original order, in one pass,
        with no gather/scatter
    slice [:count]

`FilterPredicate` is computed once and reused across all columns of a
batch, like FilterBuilder::optimize + the shared predicate in
filter_record_batch (filter.rs:171-189); here the sort itself carries all
columns as payload operands, so the whole batch compacts in ONE kernel.

For query pipelines that immediately consume the filtered column
(filter->arith->aggregate), do not compact at all: keep the mask and fuse
(ops.arity kernels accept validity masks) — that path is one streaming
pass over device memory (bench.py).  The output length is data-dependent;
the eager API syncs the popcount (one scalar); `filter_static` is the
jit-safe capacity-padded variant (SURVEY.md §7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, PrimitiveColumn
from ..core.datum import as_datum
from ..core.table import Table
from ..errors import ArrowInvalid
from .take import take as take_kernel

__all__ = ["FilterPredicate", "filter", "filter_table", "filter_static"]


class FilterPredicate:
    """Precomputed selection, reusable across columns (FilterBuilder,
    filter.rs:202,223)."""

    def __init__(self, predicate: PrimitiveColumn):
        if not predicate.dtype.is_boolean:
            raise ArrowInvalid("filter predicate must be boolean")
        keep = predicate.values
        if predicate.validity is not None:
            keep = jnp.logical_and(keep, predicate.validity)
        self.keep = keep
        self.count = int(jnp.sum(keep))  # host sync: one scalar
        self._indices: Optional[PrimitiveColumn] = None

    @property
    def indices(self) -> PrimitiveColumn:
        if self._indices is None:
            idx = _nonzero_indices(self.keep, self.count)
            self._indices = PrimitiveColumn(idx, dt.int32)
        return self._indices


def _nonzero_indices(keep: jnp.ndarray, count: int) -> jnp.ndarray:
    # partition-by-sort: row index payload sorted by NOT keep, stable ->
    # kept rows' indices first, original order
    n = keep.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _, idx = jax.lax.sort((~keep, iota), num_keys=1, is_stable=True)
    return idx[:count]


def compact_by_mask(keep: jnp.ndarray, count: int, *arrays: jnp.ndarray):
    """Partition every array's kept rows to the front, slice to `count`
    (static): one stable sort keyed on NOT keep, every array a payload
    operand."""
    sorted_ops = jax.lax.sort((~keep,) + tuple(arrays), num_keys=1,
                              is_stable=True)
    return tuple(a[:count] for a in sorted_ops[1:])


def filter(values: Column, predicate) -> Column:
    """filter kernel (filter.rs:143)."""
    pred = predicate if isinstance(predicate, FilterPredicate) \
        else FilterPredicate(as_datum(predicate))
    if isinstance(values, Column) and len(values) != len(pred.keep):
        raise ArrowInvalid("filter length mismatch")
    if isinstance(values, PrimitiveColumn):
        ins = (values.values,) if values.validity is None \
            else (values.values, values.validity)
        outs = compact_by_mask(pred.keep, pred.count, *ins)
        validity = None if values.validity is None else outs[1]
        return PrimitiveColumn(outs[0], values.dtype, validity,
                               _canonical=True)
    from ..core.column import DictionaryColumn
    if isinstance(values, DictionaryColumn):
        ins = (values.codes,) if values.validity is None \
            else (values.codes, values.validity)
        outs = compact_by_mask(pred.keep, pred.count, *ins)
        validity = None if values.validity is None else outs[1]
        return DictionaryColumn(outs[0], values.values, validity,
                                _canonical=True)
    return take_kernel(values, pred.indices)


def filter_table(table: Table, predicate) -> Table:
    """filter_record_batch (filter.rs:171): one predicate, all columns.
    All primitive/dictionary buffers of the batch ride ONE partition-sort
    (payload operands of the same stable sort); other layouts fall back to
    the shared index gather."""
    from ..core.column import DictionaryColumn
    pred = predicate if isinstance(predicate, FilterPredicate) \
        else FilterPredicate(as_datum(predicate))
    buffers = []
    plans = []  # (kind, col, has_validity)
    for c in table.columns:
        if isinstance(c, (PrimitiveColumn, DictionaryColumn)):
            vals = c.values if isinstance(c, PrimitiveColumn) else c.codes
            buffers.append(vals)
            if c.validity is not None:
                buffers.append(c.validity)
            plans.append(("sortable", c, c.validity is not None))
        else:
            plans.append(("take", c, False))
    outs = compact_by_mask(pred.keep, pred.count, *buffers) if buffers \
        else ()
    cols = []
    k = 0
    for kind, c, has_v in plans:
        if kind == "take":
            cols.append(take_kernel(c, pred.indices))
            continue
        vals = outs[k]
        k += 1
        validity = None
        if has_v:
            validity = outs[k]
            k += 1
        if isinstance(c, PrimitiveColumn):
            cols.append(PrimitiveColumn(vals, c.dtype, validity,
                                        _canonical=True))
        else:
            cols.append(DictionaryColumn(vals, c.values, validity,
                                         _canonical=True))
    return Table(tuple(cols), table.schema, _validated=True)


def filter_static(values: jnp.ndarray, keep: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shape-static compaction for jitted pipelines.

    Returns (compacted, valid_len): kept rows packed at the front in
    original order (tail = dropped rows), valid_len a traced int32.  One
    stable partition-sort; no host sync.  Prefer NOT compacting at all
    when a fused masked consumer can absorb the predicate (see module
    docstring).
    """
    out, = compact_by_mask(keep, values.shape[0], values)
    return out, jnp.sum(keep, dtype=jnp.int32)


def filter_static_multi(keep: jnp.ndarray, *arrays: jnp.ndarray):
    """filter_static over several aligned arrays sharing ONE partition
    sort (each extra operand rides the same sort).  Returns
    (tuple_of_compacted, valid_len)."""
    outs = compact_by_mask(keep, arrays[0].shape[0], *arrays)
    return outs, jnp.sum(keep, dtype=jnp.int32)
