"""take: gather rows by an index column.

Re-design of arrow-select/src/take.rs:86.  On the device the gather is one
fused XLA gather per tensor; per-layout dispatch mirrors take_impl
(take.rs:196):

  primitive   -> values gather + validity gather (take.rs:408,434)
  dictionary  -> gather the codes, dictionary shared (take.rs take_dict)
  string      -> offset-arithmetic byte gather (host-assisted in the eager
                 API; hot paths dictionary-encode first)
  struct      -> recursive child takes
  list        -> offsets rebuild + child gather

Null indices produce null outputs.  TakeOptions{check_bounds} (take.rs:357):
unchecked mode clamps (the reference's unchecked mode is UB; clamping is the
deterministic device-safe analogue), checked mode verifies and raises.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.datum import as_datum
from ..core.table import Table
from ..errors import ArrowInvalid

__all__ = ["take", "take_table"]


def take(values: Column, indices, *, check_bounds: bool = False) -> Column:
    indices = as_datum(indices)
    if not isinstance(indices, PrimitiveColumn) or \
            not indices.dtype.is_integer:
        raise ArrowInvalid("take indices must be an integer column")
    if check_bounds:
        n = len(values)
        idx = indices.values
        bad = jnp.logical_and(
            jnp.logical_or(idx < 0, idx >= n),
            indices.is_valid_mask())
        if bool(jnp.any(bad)):
            raise ArrowInvalid(f"take index out of bounds 0..{n}")
    return _take_impl(values, indices)


def _gather_validity(values: Column, indices: PrimitiveColumn) -> vd.Mask:
    """out valid = indices valid AND values[idx] valid (take.rs take_bits)."""
    idx = indices.values
    out = None
    if values.validity is not None:
        out = jnp.take(values.validity, idx, mode="clip")
    return vd.union(out, indices.validity)


def _take_impl(values: Column, indices: PrimitiveColumn) -> Column:
    idx = indices.values

    if isinstance(values, NullColumn):
        return NullColumn(int(idx.shape[0]))

    if isinstance(values, PrimitiveColumn):
        out = jnp.take(values.values, idx, mode="clip")
        return PrimitiveColumn(out, values.dtype,
                               _gather_validity(values, indices))

    if isinstance(values, DictionaryColumn):
        codes = jnp.take(values.codes, idx, mode="clip")
        return DictionaryColumn(codes, values.values,
                                _gather_validity(values, indices))

    if isinstance(values, StructColumn):
        children = tuple(_take_impl(c, indices) for c in values.children)
        iv = indices.validity
        v = None if values.validity is None else \
            jnp.take(values.validity, idx, mode="clip")
        return StructColumn(children, values.fields, vd.union(v, iv))

    if isinstance(values, StringColumn):
        return _take_bytes(values, indices)

    if isinstance(values, ListColumn):
        return _take_list(values, indices)

    from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                               FixedSizeListColumn, IntervalMDNColumn,
                               ListViewColumn, MapColumn, RunEndColumn,
                               UnionColumn)

    if isinstance(values, ListViewColumn):
        # the view-layout payoff: take gathers offsets+sizes only, the
        # child is shared untouched (list_view_array.rs semantics)
        return ListViewColumn(
            jnp.take(values.offsets, idx, mode="clip"),
            jnp.take(values.sizes, idx, mode="clip"),
            values.child, _gather_validity(values, indices),
            values.dtype)

    if isinstance(values, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(
            jnp.take(values.data, idx, axis=0, mode="clip"),
            _gather_validity(values, indices))

    if isinstance(values, DecimalColumn):
        return DecimalColumn(
            jnp.take(values.limbs, idx, axis=0, mode="clip"),
            values.dtype, _gather_validity(values, indices))

    if isinstance(values, IntervalMDNColumn):
        return IntervalMDNColumn(
            jnp.take(values.months, idx, mode="clip"),
            jnp.take(values.days, idx, mode="clip"),
            jnp.take(values.nanos, idx, mode="clip"),
            _gather_validity(values, indices))

    if isinstance(values, FixedSizeListColumn):
        k = values.list_size
        child_idx = (idx[:, None].astype(jnp.int64) * k
                     + jnp.arange(k, dtype=jnp.int64)[None, :]).reshape(-1)
        child = _take_impl(values.child,
                           PrimitiveColumn(child_idx, indices.dtype))
        return FixedSizeListColumn(child, k,
                                   _gather_validity(values, indices))

    if isinstance(values, MapColumn):
        as_list = ListColumn(values.offsets, values.entries,
                             values.validity)
        out = _take_list(as_list, indices)
        return MapColumn(out.offsets, out.child, out.validity)

    if isinstance(values, UnionColumn):
        tids = jnp.take(values.type_ids, idx, mode="clip")
        if values.offsets is None:        # sparse: gather every child
            children = [_take_impl(c, indices) for c in values.children]
            return UnionColumn(tids, None, children, values.fields,
                               values.ids)
        offs = jnp.take(values.offsets, idx, mode="clip")
        return UnionColumn(tids, offs, values.children, values.fields,
                           values.ids)

    if isinstance(values, RunEndColumn):
        return _take_run(values, indices)

    raise ArrowInvalid(f"take of {type(values)}")


def _take_run(values, indices: PrimitiveColumn):
    """take on RunEndEncoded (take.rs take_run): map logical rows to
    physical runs, then merge adjacent equal physical indices into the
    output runs (host-assisted run rebuild, like the offsets paths)."""
    from ..core.nested import RunEndColumn
    phys = np.asarray(values.row_to_run(indices.values))
    n = len(phys)
    if n == 0:
        return RunEndColumn(jnp.zeros((0,), values.run_ends.dtype),
                            values.values.slice(0, 0), 0)
    start = np.ones(n, bool)
    start[1:] = phys[1:] != phys[:-1]
    run_phys = phys[start]
    ends = np.nonzero(start)[0]
    run_ends = np.concatenate([ends[1:], [n]]).astype(
        np.asarray(values.run_ends).dtype)
    vals = _take_impl(values.values,
                      PrimitiveColumn(jnp.asarray(run_phys.astype(np.int64)),
                                      indices.dtype))
    out = RunEndColumn(jnp.asarray(run_ends), vals, n)
    iv = indices.validity
    if iv is not None:
        raise ArrowInvalid("take on run-end arrays with null indices is "
                           "not supported; mask first")
    return out


def _take_bytes(values: StringColumn, indices: PrimitiveColumn
                ) -> StringColumn:
    """Variable-width gather.  Eager/host-assisted: output byte count is
    data-dependent, so the offsets round-trip to host once; the byte gather
    itself stays a device gather."""
    # unchecked mode clamps (the documented device-safe analogue;
    # numpy fancy indexing would IndexError / wrap negatives)
    idx = np.clip(np.asarray(indices.values), 0, max(len(values) - 1, 0))
    offs = np.asarray(values.offsets)
    starts = offs[idx]
    lens = offs[idx + 1] - starts
    new_offs = np.zeros(len(idx) + 1, offs.dtype)
    np.cumsum(lens, out=new_offs[1:])
    total = int(new_offs[-1])
    # byte gather map: for each output byte, its source byte index
    src = np.repeat(starts - new_offs[:-1], lens) + np.arange(total,
                                                             dtype=offs.dtype)
    data = jnp.take(values.data, jnp.asarray(src), mode="clip") \
        if total else jnp.zeros((0,), jnp.uint8)
    return StringColumn(jnp.asarray(new_offs), data, values.dtype,
                        _gather_validity(values, indices))


def _take_list(values: ListColumn, indices: PrimitiveColumn) -> ListColumn:
    idx = np.clip(np.asarray(indices.values), 0, max(len(values) - 1, 0))
    offs = np.asarray(values.offsets)
    starts = offs[idx]
    lens = offs[idx + 1] - starts
    new_offs = np.zeros(len(idx) + 1, offs.dtype)
    np.cumsum(lens, out=new_offs[1:])
    total = int(new_offs[-1])
    src = np.repeat(starts - new_offs[:-1], lens) + np.arange(total,
                                                             dtype=offs.dtype)
    child_idx = PrimitiveColumn(jnp.asarray(src), indices.dtype)
    child = _take_impl(values.child, child_idx)
    return ListColumn(jnp.asarray(new_offs), child,
                      _gather_validity(values, indices))


import functools

import jax


@functools.partial(jax.jit, static_argnames=("plan",))
def _take_stage(plan, idx, idx_valid, buffers):
    """All single-tensor gathers of a batch in ONE XLA program (eager
    per-column gathers cost a dispatch each).  plan[i] marks whether
    buffers[i] is a validity mask (they AND with the index validity)."""
    outs = []
    for is_validity, buf in zip(plan, buffers):
        g = jnp.take(buf, idx, mode="clip")
        if is_validity:
            g = g if idx_valid is None else (g & idx_valid)
        outs.append(g)
    return tuple(outs)


def take_table(table: Table, indices, *, check_bounds: bool = False) -> Table:
    """take_record_batch (take.rs:964): one index column over all
    columns.  Primitive/dictionary buffers ride one fused gather
    program; other layouts fall back to per-column take."""
    indices = as_datum(indices)
    if check_bounds:
        cols = tuple(take(c, indices, check_bounds=True)
                     for c in table.columns)
        return Table(cols, table.schema, _validated=True)

    idx = indices.values
    plan = []          # (is_validity,) per buffer
    buffers = []
    recipe = []        # per column: ("fused", kind, has_valid) | ("take",)
    for c in table.columns:
        if isinstance(c, PrimitiveColumn):
            buffers.append(c.values)
            plan.append(False)
            buffers.append(c.is_valid_mask() if c.validity is not None
                           else None)
            recipe.append(("fused", "prim", c.validity is not None))
        elif isinstance(c, DictionaryColumn):
            buffers.append(c.codes)
            plan.append(False)
            buffers.append(c.is_valid_mask() if c.validity is not None
                           else None)
            recipe.append(("fused", "dict", c.validity is not None))
        else:
            recipe.append(("take",))
            continue
        if buffers[-1] is None:
            buffers.pop()
        else:
            plan.append(True)

    outs = _take_stage(tuple(plan), idx, indices.validity,
                       tuple(buffers)) if buffers else ()
    cols = []
    k = 0
    for r, c in zip(recipe, table.columns):
        if r[0] == "take":
            cols.append(take(c, indices))
            continue
        _, kind, has_valid = r
        vals = outs[k]
        k += 1
        validity = None
        if has_valid:
            validity = outs[k]
            k += 1
        elif indices.validity is not None:
            validity = indices.validity
        if kind == "prim":
            cols.append(PrimitiveColumn(vals, c.dtype, validity,
                                        _canonical=validity is None))
        else:
            cols.append(DictionaryColumn(vals, c.values, validity,
                                         _canonical=validity is None))
    return Table(tuple(cols), table.schema, _validated=True)
