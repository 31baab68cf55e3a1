"""concat + interleave: merge primitives.

concat (arrow-select/src/concat.rs:371): on the device a concat of tensors
is a single XLA concatenate per buffer — capacity precomputation
(concat.rs:46-82) is XLA's job.  Dictionary concat shifts codes into a
combined dictionary (the reference merges + remaps when beneficial,
concat.rs:98-109; value-dedup is ops.strings.dictionary_unify's job).

interleave (arrow-select/src/interleave.rs:70) builds an array from
(array_idx, row_idx) pairs over N sources — realized as concat + flat
gather instead of the reference's per-type copy loops: one gather per
buffer.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowTypeError
from .take import take as take_kernel

__all__ = ["concat", "concat_tables", "interleave", "interleave_tables"]


def _concat_masks(cols: Sequence[Column]) -> vd.Mask:
    if all(c.validity is None for c in cols):
        return None
    return jnp.concatenate([c.is_valid_mask() for c in cols])


def concat(cols: Sequence[Column]) -> Column:
    if not cols:
        raise ArrowInvalid("concat of zero arrays")
    if len({c.dtype for c in cols}) != 1:
        raise ArrowTypeError(
            f"concat type mismatch: {[c.dtype for c in cols]}")
    c0 = cols[0]
    if len(cols) == 1:
        return c0

    if isinstance(c0, NullColumn):
        return NullColumn(sum(len(c) for c in cols))

    if isinstance(c0, PrimitiveColumn):
        return PrimitiveColumn(jnp.concatenate([c.values for c in cols]),
                               c0.dtype, _concat_masks(cols),
                               _canonical=True)

    if isinstance(c0, StringColumn):
        datas = [c.data for c in cols]
        offsets = [np.asarray(cols[0].offsets)]
        base = int(offsets[0][-1])
        for c in cols[1:]:
            o = np.asarray(c.offsets)
            offsets.append(o[1:] + base)
            base += int(o[-1])
        return StringColumn(jnp.asarray(np.concatenate(offsets)),
                            jnp.concatenate(datas), c0.dtype,
                            _concat_masks(cols))

    if isinstance(c0, DictionaryColumn):
        if all(c.values is c0.values for c in cols[1:]):
            # shared dictionary object: concat codes only, keep the
            # dictionary (and its ordered flag) intact
            return DictionaryColumn(
                jnp.concatenate([c.codes for c in cols]), c0.values,
                _concat_masks(cols), _canonical=True,
                ordered=bool(c0.dtype.ordered))
        total = sum(len(c.values) for c in cols)
        code_max = int(jnp.iinfo(c0.codes.dtype).max)
        if total - 1 > code_max:
            # merge_dictionary_values role (concat.rs:112 /
            # dictionary.rs:177): dedup values so the combined code
            # space fits the key type instead of silently wrapping
            return _concat_dictionaries_merged(cols, code_max)
        # shift each batch's codes into a concatenated dictionary
        dict_concat = concat([c.values for c in cols])
        shifted = []
        base = 0
        for c in cols:
            shifted.append(c.codes + jnp.asarray(base, c.codes.dtype))
            base += len(c.values)
        return DictionaryColumn(jnp.concatenate(shifted), dict_concat,
                                _concat_masks(cols))

    if isinstance(c0, StructColumn):
        children = tuple(concat([c.children[i] for c in cols])
                         for i in range(len(c0.children)))
        return StructColumn(children, c0.fields, _concat_masks(cols))

    if isinstance(c0, ListColumn):
        child = concat([c.child for c in cols])
        offsets = [np.asarray(cols[0].offsets)]
        base = int(offsets[0][-1])
        for c in cols[1:]:
            o = np.asarray(c.offsets)
            offsets.append(o[1:] + base)
            base += int(o[-1])
        return ListColumn(jnp.asarray(np.concatenate(offsets)), child,
                          _concat_masks(cols))

    from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                               FixedSizeListColumn, IntervalMDNColumn,
                               MapColumn, RunEndColumn, UnionColumn)

    if isinstance(c0, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(
            jnp.concatenate([c.data for c in cols], axis=0),
            _concat_masks(cols))

    if isinstance(c0, DecimalColumn):
        return DecimalColumn(
            jnp.concatenate([c.limbs for c in cols], axis=0),
            c0.dtype, _concat_masks(cols))

    if isinstance(c0, IntervalMDNColumn):
        return IntervalMDNColumn(
            jnp.concatenate([c.months for c in cols]),
            jnp.concatenate([c.days for c in cols]),
            jnp.concatenate([c.nanos for c in cols]),
            _concat_masks(cols))

    if isinstance(c0, FixedSizeListColumn):
        return FixedSizeListColumn(concat([c.child for c in cols]),
                                   c0.list_size, _concat_masks(cols))

    if isinstance(c0, MapColumn):
        entries = concat([c.entries for c in cols])
        offsets = [np.asarray(cols[0].offsets)]
        base = int(offsets[0][-1])
        for c in cols[1:]:
            o = np.asarray(c.offsets)
            offsets.append(o[1:] + base)
            base += int(o[-1])
        return MapColumn(jnp.asarray(np.concatenate(offsets)), entries,
                         _concat_masks(cols))

    if isinstance(c0, UnionColumn):
        tids = jnp.concatenate([c.type_ids for c in cols])
        if c0.offsets is None:         # sparse: concat children directly
            children = [concat([c.children[i] for c in cols])
                        for i in range(len(c0.children))]
            return UnionColumn(tids, None, children, c0.fields, c0.ids)
        # dense: per-child concat with per-batch offset shifts
        children = [concat([c.children[i] for c in cols])
                    for i in range(len(c0.children))]
        shifted = []
        bases = [0] * len(c0.children)
        for c in cols:
            shift = np.zeros(len(c), np.int32)
            tid_np = np.asarray(c.type_ids)
            for i, tid in enumerate(c.ids):
                shift[tid_np == tid] = bases[i]
                bases[i] += len(c.children[i])
            shifted.append(np.asarray(c.offsets) + shift)
        return UnionColumn(tids, jnp.asarray(np.concatenate(shifted)),
                           children, c0.fields, c0.ids)

    if isinstance(c0, RunEndColumn):
        # shift run ends; adjacent runs across the seam stay separate
        # (same as arrow-rs concat of run arrays)
        vals = concat([c.values for c in cols])
        ends = []
        base = 0
        for c in cols:
            ends.append(np.asarray(c.run_ends, np.int64) + base)
            base += len(c)
        re_dt = np.asarray(c0.run_ends).dtype
        if base > np.iinfo(re_dt).max:
            raise ArrowInvalid(
                f"run-end overflow: total length {base} exceeds {re_dt}")
        re = np.concatenate(ends).astype(re_dt)
        return RunEndColumn(jnp.asarray(re), vals, base)

    from ..core.nested import ListViewColumn
    if isinstance(c0, ListViewColumn):
        # views may overlap/reorder within each child, so children
        # concatenate whole and each batch's offsets shift by the
        # preceding child lengths (concat.rs list-view arm semantics)
        child = concat([c.child for c in cols])
        offs, base = [], 0
        for c in cols:
            offs.append(np.asarray(c.offsets) + base)
            base += len(c.child)
        wide = c0.dtype.name == "large_list_view"
        odt = np.int64 if wide else np.int32
        return ListViewColumn(
            jnp.asarray(np.concatenate(offs).astype(odt)),
            jnp.concatenate([c.sizes for c in cols]), child,
            _concat_masks(cols), dtype=c0.dtype)

    raise ArrowTypeError(f"concat of {type(c0)}")


def _concat_dictionaries_merged(cols, code_max: int) -> DictionaryColumn:
    """Dedup the combined dictionary values (merge_dictionary_values,
    arrow-select/src/dictionary.rs:177) and remap each batch's codes.
    Host pass over the VALUES only (codes remap on device)."""
    c0 = cols[0]
    uniq: dict = {}
    order: List = []            # first-occurrence values
    maps = []
    for c in cols:
        vals = c.values.to_pylist()
        m = np.zeros(max(len(vals), 1), np.int64)
        for i, v in enumerate(vals):
            key = v if not isinstance(v, (list, dict)) else repr(v)
            if key not in uniq:
                uniq[key] = len(order)
                order.append((c, i))
            m[i] = uniq[key]
        maps.append(m)
    if len(order) - 1 > code_max:
        raise ArrowInvalid(
            f"dictionary key space overflow: {len(order)} merged values "
            f"exceed {c0.codes.dtype}")
    merged_values = interleave([c.values for c in cols],
                               [(cols.index(c), i) for c, i in order]) \
        if len(cols) > 1 else take_kernel(
            c0.values, PrimitiveColumn(
                jnp.asarray(np.asarray([i for _, i in order], np.int64)),
                dt.int64))
    shifted = [jnp.take(jnp.asarray(m).astype(c.codes.dtype),
                        jnp.clip(c.codes, 0, len(m) - 1))
               for c, m in zip(cols, maps)]
    return DictionaryColumn(jnp.concatenate(shifted), merged_values,
                            _concat_masks(cols))


def concat_tables(tables: Sequence[Table]) -> Table:
    """concat_batches (concat.rs:470)."""
    if not tables:
        raise ArrowInvalid("concat of zero tables")
    t0 = tables[0]
    for t in tables[1:]:
        if t.schema.names != t0.schema.names:
            raise ArrowInvalid("schema mismatch in concat_tables")
    cols = tuple(concat([t.columns[i] for t in tables])
                 for i in range(t0.num_columns))
    return Table(cols, t0.schema, _validated=True)


def interleave(cols: Sequence[Column],
               indices: Sequence[Tuple[int, int]]) -> Column:
    """Build a column picking (array_idx, row_idx) pairs
    (interleave.rs:70)."""
    offsets = np.zeros(len(cols) + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=offsets[1:])
    flat = np.asarray([offsets[a] + r for a, r in indices], np.int64)
    merged = concat(list(cols)) if len(cols) > 1 else cols[0]
    idx = PrimitiveColumn(jnp.asarray(flat), dt.int64)
    return take_kernel(merged, idx)


def interleave_tables(tables: Sequence[Table],
                      indices: Sequence[Tuple[int, int]]) -> Table:
    """interleave_record_batch (interleave.rs:359)."""
    t0 = tables[0]
    cols = tuple(interleave([t.columns[i] for t in tables], indices)
                 for i in range(t0.num_columns))
    return Table(cols, t0.schema, _validated=True)
