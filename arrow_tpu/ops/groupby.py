"""Grouped aggregation (hash aggregate).

Not present in the reference (arrow-rs has only whole-array reductions,
SURVEY.md §2.2 arrow-arith/aggregate); this is the BASELINE config-4
operator, composed from the engine's own primitives per SURVEY.md §7 M5:

  1. order-preserving key encode        (ops.row_format)
  2. stable sort by keys                (radix-style argsort)
  3. run boundaries via shifted compare (ops.sort.partition idea)
  4. segmented reductions               (XLA segment_sum/min/max — these
                                         lower to one fused scatter pass)

This sort-based plan has no per-row hash-table chasing: every step is a
dense vector kernel.  A low-cardinality fast path for dictionary keys skips
the sort and reduces straight into `num_groups` slots (segment ops over the
dense combined code).

Aggregate null semantics (SQL/DataFusion):
  sum/min/max skip nulls; a group with no non-null input yields null
  count counts non-null rows; count_all counts rows
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from .row_format import encode_keys, SortOptions, lexsort_indices_from_keys
from .take import take as take_kernel

__all__ = ["group_by", "AggSpec", "segment_aggregate"]

_AGG_OPS = ("sum", "count", "count_all", "min", "max", "mean")

def float_group_sums(contrib, diff_fn):
    """IEEE-honest float grouped sums on the cumsum+boundary-diff plan.

    A raw prefix sum poisons every group after the first non-finite value
    (NaN propagates; +inf then -inf gives inf-inf = NaN at the boundary
    diff), so non-finite contributions are zeroed out of the cumsum and
    re-injected per group from dedicated flag counts.  Sequential-sum
    semantics (the pyarrow oracle): any NaN -> NaN, +inf and -inf
    together -> NaN, else a lone infinity wins, else the finite sum.
    The fixup (three more int32 boundary-diffs) only runs when a
    non-finite value is present (lax.cond).

    contrib: f64 contributions in group-sorted order, excluded rows
    already zeroed.  diff_fn: per-group boundary-diff reduction.
    """
    finite = jnp.isfinite(contrib)
    safe_sums = diff_fn(jnp.where(finite, contrib,
                                  jnp.zeros((), contrib.dtype)))

    def fixup(s):
        has_nan = diff_fn(jnp.isnan(contrib).astype(jnp.int32)) > 0
        has_pinf = diff_fn((contrib == jnp.inf).astype(jnp.int32)) > 0
        has_ninf = diff_fn((contrib == -jnp.inf).astype(jnp.int32)) > 0
        s = jnp.where(has_pinf, jnp.array(jnp.inf, s.dtype), s)
        s = jnp.where(has_ninf, jnp.array(-jnp.inf, s.dtype), s)
        return jnp.where(has_nan | (has_pinf & has_ninf),
                         jnp.array(jnp.nan, s.dtype), s)

    return jax.lax.cond(jnp.all(finite), lambda s: s, fixup, safe_sums)


@dataclass(frozen=True)
class AggSpec:
    column: str
    op: str          # sum | count | count_all | min | max | mean
    name: Optional[str] = None

    @property
    def out_name(self) -> str:
        return self.name or f"{self.column}_{self.op}"


def group_by(table: Table, keys: Sequence[str],
             aggs: Sequence[AggSpec]) -> Table:
    """GROUP BY keys with per-column aggregates; one output row per
    distinct key combination, rows in first-key sorted order (nulls first,
    the engine's deterministic group order)."""
    for a in aggs:
        if a.op not in _AGG_OPS:
            raise ArrowInvalid(f"unknown aggregate {a.op}")
    str_mm = [i for i, a in enumerate(aggs)
              if a.op in ("min", "max") and isinstance(
                  table.column(a.column), (StringColumn,
                                           DictionaryColumn))]
    if str_mm and table.num_rows:
        return _group_by_string_minmax(table, keys, aggs, str_mm)

    key_cols = [table.column(k) for k in keys]
    n = table.num_rows
    if n == 0:
        out_cols = [c.slice(0, 0) for c in key_cols]
        fields = [table.schema.field(k) for k in keys]
        for a in aggs:
            col, f = _empty_agg(table, a)
            out_cols.append(col)
            fields.append(f)
        return Table(out_cols, dt.Schema(tuple(fields)))

    # hash-agg fast path: dictionary keys with a small combined code
    # domain aggregate in ONE pass over the data (segment ops over the
    # dense code) with no row sort at all — the row lexsort below exists
    # only to discover groups.
    fast = _dictionary_fast_path(table, key_cols, keys, aggs)
    if fast is not None:
        return fast

    # perfect binning: integer keys whose combined range is small skip
    # group discovery entirely (bin id = rebased digits) and run the
    # aggregation sorts on rebased NARROW operands
    fast = _int_range_fast_path(table, key_cols, keys, aggs)
    if fast is not None:
        return fast

    if n > _SORT_AGG_CHUNK:
        return _group_by_chunked(table, keys, aggs, n)

    # 1-3: group discovery — key encode, stable lexsort, run boundaries,
    # dense group ids — fused into ONE jitted program.
    from .row_format import key_kind, key_parts
    kinds, parts = [], []
    for c in key_cols:
        kinds.append(key_kind(c))
        parts.append(key_parts(c))
    # aggregate source tensors ride the discovery sort as payload
    # operands (no post-sort random gather; see _discover_stage)
    from ..core.column import NullColumn as _NullColumn
    payload_list = []
    payload_pos = {}

    def payload_slot(t):
        key = id(t)
        if key not in payload_pos:
            payload_pos[key] = len(payload_list)
            payload_list.append(t)
        return payload_pos[key]

    pre_plan = []
    for a in aggs:
        src = table.column(a.column)
        if isinstance(src, PrimitiveColumn) and not isinstance(
                src, _NullColumn):
            vslot = payload_slot(src.values)
            mslot = None if src.validity is None \
                else payload_slot(src.validity)
            pre_plan.append((vslot, mslot))
        else:
            pre_plan.append(None)

    order, gid, run_start, starts_raw, ng, sorted_payloads = \
        _discover_stage(tuple(kinds), tuple(parts),
                        tuple(payload_list))
    num_groups = int(ng)  # host sync (output cardinality)

    # 4: one fused jitted stage computes run starts, representative
    # rows, and every aggregate.
    from ..core.column import NullColumn
    plan = []
    arrays = []
    for a, pre in zip(aggs, pre_plan):
        src = table.column(a.column)
        if isinstance(src, NullColumn) or (
                not isinstance(src, PrimitiveColumn)
                and a.op in ("count", "count_all")):
            kind = "null" if isinstance(src, NullColumn) else "other"
            plan.append((a.op, len(arrays), kind))
            other_valid = None
            if kind != "null" and src.validity is not None:
                other_valid = src.validity[order]
            arrays.append((jnp.zeros((n,), jnp.int64),
                           jnp.zeros((n,), jnp.bool_) if kind == "null"
                           else other_valid))
        elif isinstance(src, PrimitiveColumn):
            d = src.values.dtype
            kind = "float" if jnp.issubdtype(d, jnp.floating) else "int"
            plan.append((a.op, len(arrays), kind))
            vslot, mslot = pre
            arrays.append((sorted_payloads[vslot],
                           None if mslot is None
                           else sorted_payloads[mslot]))
        else:
            raise ArrowNotImplementedError(f"{a.op} over {type(src)}")

    outs, first_idx = _agg_stage(
        tuple(plan), num_groups, order, gid, run_start, starts_raw,
        tuple(arrays), presorted=True)

    rep = PrimitiveColumn(first_idx.astype(jnp.int64), dt.int64)
    out_cols: List[Column] = [take_kernel(c, rep) for c in key_cols]
    fields = [table.schema.field(k) for k in keys]
    for a, (vals, gvalid) in zip(aggs, outs):
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        if out_dt.is_null:      # all-null source: aggregate as null i64
            out_dt = dt.int64
        nullable = a.op not in ("count", "count_all")
        mask = None
        if nullable and not bool(jnp.all(gvalid)):
            mask = gvalid
        out_cols.append(PrimitiveColumn(vals, out_dt, mask,
                                        _canonical=True))
        fields.append(dt.Field(a.out_name, out_dt, nullable=nullable))
    return Table(out_cols, dt.Schema(tuple(fields)))


import functools


@functools.partial(jax.jit, static_argnames=("kinds",))
def _discover_stage(kinds, parts, payloads=()):
    """Key encode + stable lexsort + run boundaries + dense group ids,
    one XLA program.  Fixed group order: ascending, nulls first (the
    engine's deterministic group order).

    `payloads` (the aggregate source tensors) ride the SAME sort as
    extra operands instead of a post-sort random gather v[order]."""
    from .row_format import encode_keys_traced
    keys = encode_keys_traced(kinds, ((False, True),) * len(kinds),
                              parts)
    n = keys[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.uint32)
    nk = len(keys)
    sorted_ops = jax.lax.sort(
        tuple(keys) + (iota,) + tuple(payloads),
        num_keys=nk, is_stable=True)
    # order/gid/starts ride i32: n < 2^31 always holds on one device and
    # halves the bytes of three n-sized arrays
    order = sorted_ops[nk].astype(jnp.int32)
    sorted_payloads = sorted_ops[nk + 1:]
    neq = jnp.zeros((n - 1,), jnp.bool_)
    for k in sorted_ops[:nk]:
        neq = jnp.logical_or(neq, k[1:] != k[:-1])
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    gid = jnp.cumsum(run_start.astype(jnp.int32)) - 1
    # run-start positions via partition-sort
    _, starts_raw = jax.lax.sort(
        (~run_start, jnp.arange(n, dtype=jnp.int32)), num_keys=1,
        is_stable=True)
    return (order, gid, run_start, starts_raw,
            (gid[-1] + 1).astype(jnp.int64), sorted_payloads)



# The fast path materializes one slot per combination of the key domain,
# occupied or not, and lexsorts those slots; past this many combinations
# the general path, which only materializes occupied groups, is the one
# to take.  The bound is inherited, not measured on the GPU.
_DICT_FAST_MAX_GROUPS = 1024


def _fast_agg_ok(src: Column, op: str) -> bool:
    """Whether the dictionary fast path covers this (column, op): counts
    of anything, integer sums (wrapping i64 addition is exact in any
    order), integer and float min/max.  Float sums stay on the general
    path, whose prefix-sum order is deterministic."""
    if op in ("count", "count_all"):
        return True
    if not isinstance(src, PrimitiveColumn):
        return False
    d = src.values.dtype
    is_int = jnp.issubdtype(d, jnp.integer) and d != jnp.bool_
    if op in ("min", "max"):
        return is_int or jnp.issubdtype(d, jnp.floating)
    return is_int and op in ("sum", "mean")


def _float_order_key(v):
    """IEEE totalOrder key of a float column as an unsigned int of its
    width (f16 widens to f32).  NaNs are made positive first, so NaN
    orders above +inf: min skips NaN unless every value is NaN and max
    is NaN as soon as one is — the general path's semantics."""
    if v.dtype == jnp.float16:
        v = v.astype(jnp.float32)
    ut = jnp.uint64 if v.dtype == jnp.float64 else jnp.uint32
    top = jnp.asarray(1 << (8 * v.dtype.itemsize - 1), ut)
    bits = jax.lax.bitcast_convert_type(
        jnp.where(jnp.isnan(v), jnp.array(jnp.nan, v.dtype), v), ut)
    return jnp.where(bits & top != 0, ~bits, bits | top)


def _float_order_decode(key, dtype):
    ut = key.dtype
    top = jnp.asarray(1 << (8 * key.dtype.itemsize - 1), ut)
    bits = jnp.where(key & top != 0, key & ~top, ~key)
    ft = jnp.float64 if ut == jnp.uint64 else jnp.float32
    return jax.lax.bitcast_convert_type(bits, ft).astype(dtype)


@functools.partial(jax.jit, static_argnames=("sizes", "g_total",
                                             "mm_want"))
def _fast_agg_stage(sizes, g_total, mm_want, key_parts, sum_parts,
                    mm_parts):
    """Device stage of the dictionary fast path, one XLA program:
    mixed-radix combined codes, then segment sums / mins / maxes over
    them.  Returns (sums, counts, [(min, max)]), all g_total-sized;
    empty groups hold identities that callers mask with counts."""
    n = key_parts[0][0].shape[0]
    combined = jnp.zeros((n,), jnp.int32)
    for (codes, validity), size in zip(key_parts, sizes):
        digit = codes.astype(jnp.int32)
        if validity is not None:
            digit = jnp.where(validity, digit, jnp.int32(size))
        combined = combined * jnp.int32(size + 1) + digit

    def seg(fn, x):
        return fn(x, combined, num_segments=g_total,
                  indices_are_sorted=False)

    sums, counts = [], []
    for v, m in sum_parts:
        ones = jnp.ones((n,), jnp.int64) if m is None \
            else m.astype(jnp.int64)
        counts.append(seg(jax.ops.segment_sum, ones))
        if v is None:
            sums.append(None)
            continue
        v64 = jax.lax.bitcast_convert_type(v, jnp.int64) \
            if v.dtype == jnp.uint64 else v.astype(jnp.int64)
        if m is not None:
            v64 = jnp.where(m, v64, jnp.int64(0))
        sums.append(seg(jax.ops.segment_sum, v64))

    mms = []
    for (v, m), (want_min, want_max) in zip(mm_parts, mm_want):
        is_float = jnp.issubdtype(v.dtype, jnp.floating)
        key = _float_order_key(v) if is_float else v
        info = jnp.iinfo(key.dtype)
        out = []
        for want, fn, ident in ((want_min, jax.ops.segment_min, info.max),
                                (want_max, jax.ops.segment_max, info.min)):
            if not want:
                out.append(None)
                continue
            k = key if m is None \
                else jnp.where(m, key, jnp.asarray(ident, key.dtype))
            r = seg(fn, k)
            out.append(_float_order_decode(r, v.dtype) if is_float else r)
        mms.append(tuple(out))
    return sums, counts, mms


def _dictionary_fast_path(table: Table, key_cols, keys, aggs
                          ) -> Optional[Table]:
    """GROUP BY over dictionary-encoded keys without sorting the rows.

    Combined key code = mixed-radix digit stack over (dict size + 1) per
    key (the extra digit encodes null).  All aggregates run in one
    program of segment reductions over that code; only the
    <= _DICT_FAST_MAX_GROUPS group-sized arrays are then ordered (same
    encoded-key lexsort as the general path, so output order is
    identical).
    """
    if not all(isinstance(c, DictionaryColumn) for c in key_cols):
        return None
    sizes = [len(c.values) for c in key_cols]
    g_total = 1
    for s in sizes:
        g_total *= s + 1
    if not (0 < g_total <= _DICT_FAST_MAX_GROUPS):
        return None
    # the mixed-radix CODE domain assumes distinct non-null values per
    # slot; dictionaries with null entries or duplicate values must
    # take the general path (its key encoding folds entry validity and
    # value equality — the code domain does neither).  Dictionaries
    # here are small, so the host rank check is tiny.
    from .row_format import dictionary_value_ranks
    for c in key_cols:
        if getattr(c.values, "validity", None) is not None:
            return None
        try:
            ranks, is_null = dictionary_value_ranks(c.values)
        except Exception:          # noqa: BLE001 (unrankable values)
            return None
        if is_null.any() or len(np.unique(ranks)) != len(ranks):
            return None
    for a in aggs:
        if not _fast_agg_ok(table.column(a.column), a.op):
            return None

    # collect aggregate requests (metadata only — the device work all
    # happens in ONE jitted stage below)
    from ..core.column import NullColumn

    def col_valid(src):
        if isinstance(src, NullColumn):
            return jnp.zeros((len(src),), jnp.bool_)
        return src.validity

    sum_parts = [(None, None)]     # slot 0 = occupancy / count_all
    sum_slot = {None: 0}
    mm_parts = []
    mm_want: List = []
    mm_slot = {}
    for a in aggs:
        src = table.column(a.column)
        if a.op == "count_all":
            continue               # slot 0
        if a.op == "count":
            key = ("cnt", a.column)
            if key not in sum_slot:
                sum_slot[key] = len(sum_parts)
                sum_parts.append((None, col_valid(src)))
        elif a.op in ("sum", "mean"):
            key = ("sum", a.column)
            if key not in sum_slot:
                sum_slot[key] = len(sum_parts)
                sum_parts.append((src.values, col_valid(src)))
        else:                      # min / max
            key = ("mm", a.column)
            if key not in mm_slot:
                mm_slot[key] = len(mm_parts)
                mm_parts.append((src.values, col_valid(src)))
                mm_want.append([False, False])
                if col_valid(src) is not None:
                    # empty-group masking needs per-group valid counts
                    ckey = ("cnt", a.column)
                    if ckey not in sum_slot:
                        sum_slot[ckey] = len(sum_parts)
                        sum_parts.append((None, col_valid(src)))
            w = mm_want[mm_slot[key]]
            if a.op == "min":
                w[0] = True
            else:
                w[1] = True

    key_parts = tuple((c.codes, c.validity) for c in key_cols)
    sums, counts, mms = _fast_agg_stage(
        tuple(sizes), g_total, tuple(tuple(w) for w in mm_want),
        key_parts, tuple(sum_parts), tuple(mm_parts))
    occupancy = counts[0]
    occupied = occupancy > 0

    # group-sized key columns (decode mixed-radix digits)
    gids = jnp.arange(g_total, dtype=jnp.int64)
    key_cols_g: List[Column] = []
    stride = g_total
    for c, size in zip(key_cols, sizes):
        stride //= (size + 1)
        digit = (gids // stride) % (size + 1)
        is_null = digit == size
        codes_g = jnp.where(is_null, jnp.int64(0), digit) \
            .astype(c.codes.dtype)
        mask = None if not bool(jnp.any(is_null)) else ~is_null
        key_cols_g.append(DictionaryColumn(codes_g, c.values, mask,
                                           _canonical=True))

    # materialize each aggregate from the stage outputs
    agg_cols: List[Column] = []
    fields = [table.schema.field(k) for k in keys]
    agg_fields: List[dt.Field] = []
    for a in aggs:
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        if a.op == "count_all":
            agg_cols.append(PrimitiveColumn(occupancy, dt.int64))
            agg_fields.append(dt.Field(a.out_name, dt.int64,
                                       nullable=False))
            continue
        if a.op == "count":
            cnt = counts[sum_slot[("cnt", a.column)]]
            agg_cols.append(PrimitiveColumn(cnt, dt.int64))
            agg_fields.append(dt.Field(a.out_name, dt.int64,
                                       nullable=False))
            continue
        if a.op in ("sum", "mean"):
            slot = sum_slot[("sum", a.column)]
            s, c = sums[slot], counts[slot]
        else:
            mn, mx = mms[mm_slot[("mm", a.column)]]
            # per-group valid count: registered above for nullable
            # columns; all-valid columns reuse occupancy
            c = counts[sum_slot[("cnt", a.column)]] \
                if ("cnt", a.column) in sum_slot else occupancy
        group_valid = c > 0
        group_mask = None if bool(jnp.all(group_valid)) else group_valid
        if a.op == "sum":
            agg_cols.append(PrimitiveColumn(s.astype(src.dtype.to_jax()),
                                            out_dt, group_mask))
        elif a.op == "mean":
            m = s.astype(jnp.float64) / jnp.maximum(c, 1) \
                .astype(jnp.float64)
            agg_cols.append(PrimitiveColumn(m, out_dt, group_mask))
        else:
            r = mn if a.op == "min" else mx
            agg_cols.append(PrimitiveColumn(r, out_dt, group_mask))
        agg_fields.append(dt.Field(a.out_name, out_dt))

    # order groups exactly like the general path: lexsort the encoded
    # keys (nulls first), then drop unoccupied combinations
    keystack_g = encode_keys(key_cols_g, [SortOptions()] * len(key_cols_g))
    order_g = lexsort_indices_from_keys(keystack_g).astype(jnp.int64)
    occ_sorted = occupied[order_g]
    n_occ = int(jnp.sum(occ_sorted))     # host sync (output cardinality)
    sel = order_g[jnp.nonzero(occ_sorted, size=n_occ)[0]]
    sel_col = PrimitiveColumn(sel, dt.int64)

    out_cols = [take_kernel(c, sel_col) for c in key_cols_g]
    out_cols += [take_kernel(c, sel_col) for c in agg_cols]
    return Table(out_cols, dt.Schema(tuple(fields + agg_fields)))


# ---------------------------------------------------------------------------
# Perfect binning: small-range integer keys.
#
# DuckDB-style perfect-hash aggregation re-designed for dense device
# primitives: when every GROUP BY key is an integer column whose value
# range is small, the bin id is computed arithmetically (mixed-radix
# rebased digits) — group discovery costs one whole-array min/max scan
# instead of a 64-bit row lexsort, and the per-aggregate sorts run on
# rebased NARROW operands (u16/u32).  Multi-operand sorts move every
# operand byte through every merge pass, so narrow operands are the
# lever.  The reference has no grouped
# aggregation (SURVEY.md §2.2 — arrow-arith/aggregate.rs is whole-array
# only); bin section math composes partition.rs:156's boundary idea with
# searchsorted instead of scatter.

_BIN_CAP = 1 << 20           # max combined bin count: the per-bin
                             # searchsorted sections and the finalize
                             # gather grow with the bin count, so high
                             # cardinalities take the packed or sort
                             # path.  Not measured on the GPU.
_BIN_CHUNK = 125_000_000     # rows per sort chunk: a bound inherited
                             # from a 16 GB device, not measured on the
                             # GPU

# class codes packed into the low bits of the bin key when a value
# column is nullable or floating: valid < NaN < null, so each bin's
# sections are contiguous and section starts come from ONE searchsorted
_CLS_VALID, _CLS_NAN, _CLS_NULL = 0, 1, 2


def _bin_val_kind(col: Column, vmin: int, vmax: int) -> str:
    d = col.dtype
    if d.is_floating:
        return "f" + d.name[5:]          # f16/f32/f64
    rng = vmax - vmin
    if rng < (1 << 16):
        return "u16"
    if rng < (1 << 32):
        return "u32"
    return "o64u" if d.is_unsigned_integer else "o64"


def _bin_encode_val(values, validity, kind, vmin):
    """(sort_value, cls) for one aggregate source column.  sort_value
    orders ascending within a bin; cls is None when no class bits are
    needed (non-null integer)."""
    if kind[0] == "f":
        v = values.astype(jnp.float32) if kind == "f16" else values
        isnan = jnp.isnan(v)
        sv = jnp.where(isnan, jnp.zeros((), v.dtype), v)
        cls = isnan.astype(jnp.int32)
        if validity is not None:
            cls = jnp.where(validity, cls, jnp.int32(_CLS_NULL))
        return sv, cls
    if kind == "o64u":
        sv = values.astype(jnp.uint64)
    elif kind == "o64":
        sv = jax.lax.bitcast_convert_type(
            values.astype(jnp.int64), jnp.uint64) \
            ^ jnp.uint64(1 << 63)
    else:
        if jnp.issubdtype(values.dtype, jnp.unsignedinteger):
            reb = values.astype(jnp.uint64) - vmin.astype(jnp.uint64)
        else:
            reb = (values.astype(jnp.int64)
                   - vmin.astype(jnp.int64)).astype(jnp.uint64)
        sv = reb.astype(jnp.uint16 if kind == "u16" else jnp.uint32)
    cls = None
    if validity is not None:
        cls = jnp.where(validity, jnp.int32(_CLS_VALID),
                        jnp.int32(_CLS_NULL))
    return sv, cls


def _bin_decode_val(enc, kind, vmin, out_jax_dtype):
    if kind[0] == "f":
        return enc.astype(out_jax_dtype)
    if kind == "o64u":
        return enc.astype(out_jax_dtype)
    if kind == "o64":
        return jax.lax.bitcast_convert_type(
            enc ^ jnp.uint64(1 << 63), jnp.int64).astype(out_jax_dtype)
    if jnp.issubdtype(out_jax_dtype, jnp.unsignedinteger):
        return (enc.astype(jnp.uint64)
                + vmin.astype(jnp.uint64)).astype(out_jax_dtype)
    return (enc.astype(jnp.int64)
            + vmin.astype(jnp.int64)).astype(out_jax_dtype)


@functools.partial(jax.jit, static_argnames=("kplan", "vplan", "g_total"))
def _bin_chunk_stage(kplan, vplan, g_total, key_arrs, kmins, val_arrs,
                     vmins):
    """One chunk of the perfect-binning plan as ONE XLA program.

    kplan: per key column (nullable, base) — static.
    vplan: per value column (kind, nullable, has_mm, sort_idx) — static;
      sort_idx 0 rides the primary sort (as 2nd key if has_mm, else as a
      payload), >0 gets its own (packed, value) sort.
    Returns (cnt_all, per-column partial dicts) — all g_total-sized.
    """
    n = key_arrs[0][0].shape[0]

    # mixed-radix bin id, u32 (g_total <= 2^20 by construction)
    combined = jnp.zeros((n,), jnp.uint32)
    for (nullable, base), (v, m), kmin in zip(kplan, key_arrs, kmins):
        if jnp.issubdtype(v.dtype, jnp.unsignedinteger):
            digit = (v.astype(jnp.uint64)
                     - kmin.astype(jnp.uint64)).astype(jnp.uint32)
        else:
            digit = (v.astype(jnp.int64)
                     - kmin.astype(jnp.int64)).astype(jnp.uint32)
        if nullable:
            digit = jnp.where(m, digit + jnp.uint32(1), jnp.uint32(0))
        combined = combined * jnp.uint32(base) + digit

    # encode value columns; group them by sort
    n_sorts = 1 + sum(1 for p in vplan if p[3] > 0)
    sort_keys: List[list] = [[] for _ in range(n_sorts)]
    payloads: List[list] = [[] for _ in range(n_sorts)]
    col_enc = []
    for (kind, nullable, has_mm, sort_idx), (v, m), vmin in zip(
            vplan, val_arrs, vmins):
        if kind == "cnt":                  # count-only: validity payload
            pl01 = jnp.ones((n,), jnp.uint8) if m is None \
                else m.astype(jnp.uint8)
            payloads[0].append(pl01)
            col_enc.append(("cnt", None))
            continue
        sv, cls = _bin_encode_val(v, m, kind, vmin)
        cb = 0 if cls is None else 2
        if has_mm:
            packed = combined << jnp.uint32(cb)
            if cls is not None:
                packed = packed | cls.astype(jnp.uint32)
            sort_keys[sort_idx] = [packed, sv]
            col_enc.append(("mm", cb))
        else:
            # payload on the primary sort: zero excluded rows now so the
            # full-bin cumsum diff is the null-skipping sum
            contrib = sv if m is None else \
                jnp.where(m, sv, jnp.zeros((), sv.dtype))
            if kind[0] == "f":
                isbad = jnp.isnan(v) if m is None else \
                    (~m | jnp.isnan(v))
                contrib = jnp.where(isbad, jnp.zeros((), sv.dtype), sv)
                payloads[0].append(isbad.astype(jnp.uint8))
            payloads[0].append(contrib)
            if m is not None:
                payloads[0].append(m.astype(jnp.uint8))
            col_enc.append(("pay", 0))
    if not sort_keys[0]:
        sort_keys[0] = [combined]

    sorted_res = []
    for sk, pls in zip(sort_keys, payloads):
        ops = tuple(sk) + tuple(pls)
        sorted_res.append(jax.lax.sort(ops, num_keys=min(len(sk), 2),
                                       is_stable=False))

    bins = jnp.arange(g_total, dtype=jnp.uint32)

    def section(spk, cb, upto_cls):
        return jnp.searchsorted(
            spk, (bins << jnp.uint32(cb)) | jnp.uint32(upto_cls),
            side="left").astype(jnp.int64)

    # bin boundaries from the primary sort (identical across sorts: the
    # bin id occupies the high bits of every packed key)
    cb0 = 0
    for (kind, nullable, has_mm, sort_idx), (tag, cb) in zip(vplan,
                                                             col_enc):
        if tag == "mm" and sort_idx == 0:
            cb0 = cb
    spk0 = sorted_res[0][0]
    b0 = section(spk0, cb0, 0)
    bnext = jnp.concatenate([b0[1:], jnp.full((1,), n, jnp.int64)])
    cnt_all = bnext - b0

    def cs0_of(x):
        cs = jnp.cumsum(x)
        return jnp.concatenate([jnp.zeros((1,), cs.dtype), cs])

    def sec_diff(x, s, e):
        cs0 = cs0_of(x)
        return cs0[e] - cs0[s]

    # -- payload cursor walk (tuple positions mirror the build order) --
    res = []
    cursor0 = len(sort_keys[0])
    p0 = cursor0
    for (kind, nullable, has_mm, sort_idx), (tag, cb) in zip(vplan,
                                                             col_enc):
        if tag == "cnt":
            v01 = sorted_res[0][p0]
            p0 += 1
            vc = sec_diff(v01.astype(jnp.int64), b0, bnext)
            res.append({"validcnt": vc})
            continue
        if tag == "mm":
            spk, sv = sorted_res[sort_idx][0], sorted_res[sort_idx][1]
            if cb:
                s1 = section(spk, cb, _CLS_NAN)
                s2 = section(spk, cb, _CLS_NULL)
            else:
                s1 = s2 = bnext
            validcnt = s2 - b0
            out = {"validcnt": validcnt}
            # sums over the valid section [b0, s2)
            if kind[0] == "f":
                contrib = sv.astype(jnp.float64)
                fin = jnp.isfinite(contrib)
                fsum = sec_diff(jnp.where(fin, contrib, 0.0), b0, s2)
                pinf = sec_diff((sv == jnp.inf).astype(jnp.int32),
                                b0, s2) > 0
                ninf = sec_diff((sv == -jnp.inf).astype(jnp.int32),
                                b0, s2) > 0
                nan_cnt = s2 - s1
                fsum = jnp.where(pinf, jnp.inf, fsum)
                fsum = jnp.where(ninf, -jnp.inf, fsum)
                fsum = jnp.where((nan_cnt > 0) | (pinf & ninf),
                                 jnp.nan, fsum)
                out["fsum"] = fsum
            else:
                out["esum"] = sec_diff(sv.astype(jnp.uint64), b0, s2)
            # min at the valid-section start, max at its end (NaNs sort
            # just below nulls, so any NaN makes the max NaN and an
            # all-NaN bin makes the min NaN — mm_pick semantics)
            mn_pos = jnp.clip(b0, 0, max(n - 1, 0))
            mx_pos = jnp.clip(s2 - 1, 0, max(n - 1, 0))
            mn_e = sv[mn_pos]
            mx_e = sv[mx_pos]
            if kind[0] == "f":
                mn_e = jnp.where(b0 < s1, mn_e,
                                 jnp.array(jnp.nan, mn_e.dtype))
                mx_e = jnp.where(s1 < s2,
                                 jnp.array(jnp.nan, mx_e.dtype), mx_e)
            out["mn"] = mn_e
            out["mx"] = mx_e
            res.append(out)
            continue
        # payload column on the primary sort
        if kind[0] == "f":
            isbad = sorted_res[0][p0]
            contrib = sorted_res[0][p0 + 1]
            p0 += 2
            c64 = contrib.astype(jnp.float64)
            fin = jnp.isfinite(c64)
            fsum = sec_diff(jnp.where(fin, c64, 0.0), b0, bnext)
            pinf = sec_diff((contrib == jnp.inf).astype(jnp.int32),
                            b0, bnext) > 0
            ninf = sec_diff((contrib == -jnp.inf).astype(jnp.int32),
                            b0, bnext) > 0
            has_nan = sec_diff(
                (isbad == 1).astype(jnp.int32), b0, bnext)
            # isbad counts nulls too when nullable; recount NaNs exactly
            out = {}
            if nullable:
                v01 = sorted_res[0][p0]
                p0 += 1
                vc = sec_diff(v01.astype(jnp.int64), b0, bnext)
                nan_in = has_nan - (cnt_all - vc)
            else:
                vc = cnt_all
                nan_in = has_nan
            fsum = jnp.where(pinf, jnp.inf, fsum)
            fsum = jnp.where(ninf, -jnp.inf, fsum)
            fsum = jnp.where((nan_in > 0) | (pinf & ninf), jnp.nan,
                             fsum)
            out["validcnt"] = vc
            out["fsum"] = fsum
            res.append(out)
        else:
            contrib = sorted_res[0][p0]
            p0 += 1
            esum = sec_diff(contrib.astype(jnp.uint64), b0, bnext)
            if nullable:
                v01 = sorted_res[0][p0]
                p0 += 1
                vc = sec_diff(v01.astype(jnp.int64), b0, bnext)
            else:
                vc = cnt_all
            res.append({"validcnt": vc, "esum": esum})
    return cnt_all, tuple(res)


@functools.partial(jax.jit, static_argnames=("vplan",))
def _bin_merge(vplan, acc, part):
    """Combine two per-bin partial sets (tiny, g_total-sized)."""
    cnt_a, cols_a = acc
    cnt_b, cols_b = part
    out = []
    for (kind, *_), da, db in zip(vplan, cols_a, cols_b):
        d = {"validcnt": da["validcnt"] + db["validcnt"]}
        if "esum" in da:
            d["esum"] = da["esum"] + db["esum"]
        if "fsum" in da:
            d["fsum"] = da["fsum"] + db["fsum"]
        if "mn" in da:
            va = da["validcnt"] > 0
            vb = db["validcnt"] > 0
            mna, mxa, mnb, mxb = da["mn"], da["mx"], db["mn"], db["mx"]
            if kind[0] == "f":
                # min skips NaN unless every valid value is NaN; max is
                # NaN as soon as any side saw a NaN (mm_pick semantics)
                nana, nanb = jnp.isnan(mna), jnp.isnan(mnb)
                mn_both = jnp.where(
                    nana, mnb, jnp.where(nanb, mna,
                                         jnp.minimum(mna, mnb)))
                mx_both = jnp.where(jnp.isnan(mxa) | jnp.isnan(mxb),
                                    jnp.array(jnp.nan, mxa.dtype),
                                    jnp.maximum(mxa, mxb))
            else:
                mn_both = jnp.minimum(mna, mnb)
                mx_both = jnp.maximum(mxa, mxb)
            d["mn"] = jnp.where(~va, mnb, jnp.where(~vb, mna, mn_both))
            d["mx"] = jnp.where(~va, mxb, jnp.where(~vb, mxa, mx_both))
        out.append(d)
    return cnt_a + cnt_b, tuple(out)


@functools.partial(jax.jit, static_argnames=("kplan", "aplan", "g_total",
                                             "n_occ"))
def _bin_finalize(kplan, aplan, g_total, n_occ, cnt_all, cols, kmins,
                  vmins):
    """Decode occupied bins into key values and aggregate outputs.

    aplan: per AggSpec (op, col_idx, kind, out_jax_name) — static.
    """
    occupied = cnt_all > 0
    sel = jnp.nonzero(occupied, size=n_occ, fill_value=0)[0] \
        .astype(jnp.int64)
    key_out = []
    stride = g_total
    for (nullable, base), kmin in zip(kplan, kmins):
        stride //= base
        digit = (sel // stride) % base
        if nullable:
            isnull = digit == 0
            digit = jnp.where(isnull, jnp.int64(1), digit) - 1
            mask = ~isnull
        else:
            mask = None
        if jnp.issubdtype(kmin.dtype, jnp.unsignedinteger):
            vals = digit.astype(jnp.uint64) + kmin.astype(jnp.uint64)
        else:
            vals = digit + kmin.astype(jnp.int64)
        key_out.append((vals, mask))

    agg_out = []
    for op, ci, kind, out_name in aplan:
        if op == "count_all":
            agg_out.append((cnt_all[sel], None))
            continue
        d = cols[ci]
        if op == "count":
            agg_out.append((d["validcnt"][sel], None))
            continue
        vc = d["validcnt"][sel]
        gvalid = vc > 0
        vmin = vmins[ci]
        out_jax = np.dtype(out_name)
        if op in ("sum", "mean"):
            if "fsum" in d:
                total = d["fsum"][sel]
                s_out = total.astype(out_jax) if op == "sum" else None
            else:
                esum = d["esum"][sel]
                if kind == "o64":
                    total = esum - vc.astype(jnp.uint64) \
                        * jnp.uint64(1 << 63)
                elif kind == "o64u":
                    total = esum
                else:
                    if jnp.issubdtype(vmin.dtype, jnp.unsignedinteger):
                        off = vmin.astype(jnp.uint64)
                    else:
                        off = jax.lax.bitcast_convert_type(
                            vmin.astype(jnp.int64), jnp.uint64)
                    total = esum + vc.astype(jnp.uint64) * off
                if op == "sum":
                    if jnp.issubdtype(out_jax, jnp.unsignedinteger):
                        s_out = total.astype(out_jax)
                    else:
                        s_out = jax.lax.bitcast_convert_type(
                            total, jnp.int64).astype(out_jax)
                else:
                    total = jax.lax.bitcast_convert_type(
                        total, jnp.int64)
            if op == "mean":
                s_out = (total.astype(jnp.float64)
                         / jnp.maximum(vc, 1).astype(jnp.float64))
            agg_out.append((s_out, gvalid))
        else:
            enc = (d["mn"] if op == "min" else d["mx"])[sel]
            vals = _bin_decode_val(enc, kind, vmin, out_jax)
            agg_out.append((vals, gvalid))
    return key_out, agg_out


# ---------------------------------------------------------------------------
# Packed-sort path: HIGH-cardinality integer keys.
#
# When the combined key domain exceeds the perfect-binning cap, group
# discovery + aggregation still avoid the general two-operand discovery
# sort: the rebased mixed-radix key code and the (class, value) bits of
# each min/max column pack into ONE u64 sort operand per column
# (class orders valid < NaN < null inside a group, like the bin path).
# One unstable single-operand sort orders rows by (group, class, value);
# run starts come from one lax.top_k over an (is_start | ~packed) plane
# (k bucketed to powers of two so cardinality changes don't recompile);
# every aggregate is then a couple of narrow gathers at the run starts:
#   min   = packed value at the run start
#   max   = packed value at start + nonnull_count - 1
#   sum   = diff of the exclusive cumsum of contributions
#   count = diff of start positions (or of a validity cumsum plane)
# Composes the
# run-discovery idea of /root/reference/arrow-ord/src/partition.rs:127
# with /root/reference/arrow-arith/src/aggregate.rs:98's whole-array
# reductions (the reference has no grouped aggregation).

_PACKED_CHUNK = 125_000_000   # beyond this group_by re-chunks; a bound
                              # inherited from a 16 GB device, not
                              # measured on the GPU
_PACKED_BITS = 63             # the u64 top bit carries the is_start flag


def _order32(v):
    """Monotone f32 -> u32 totalOrder map (sign-flip trick).  Only
    f16/f32 pack: an f64 value leaves no bits for the group key in the
    u64 operand."""
    b = jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.uint32)
    return jnp.where(b >> jnp.uint32(31) == 1, ~b,
                     b | jnp.uint32(0x80000000))


def _order32_decode(e, out_jax_dtype):
    e32 = e.astype(jnp.uint32)
    b = jnp.where(e32 >> jnp.uint32(31) == 1,
                  e32 & jnp.uint32(0x7FFFFFFF), ~e32)
    return jax.lax.bitcast_convert_type(b, jnp.float32) \
        .astype(out_jax_dtype)


def _packed_encode(values, validity, kind, vmin, vb):
    """(enc u64 in [0, 2^vb), cls i32 or None) for one mm/sum column."""
    if kind[0] == "f":
        isnan = jnp.isnan(values)
        sv = jnp.where(isnan, jnp.zeros((), values.dtype), values)
        enc = _order32(sv).astype(jnp.uint64)
        cls = isnan.astype(jnp.int32)
        if validity is not None:
            cls = jnp.where(validity, cls, jnp.int32(_CLS_NULL))
        enc = jnp.where(cls == 0, enc, jnp.uint64(0))
        return enc, cls
    if jnp.issubdtype(values.dtype, jnp.unsignedinteger):
        enc = values.astype(jnp.uint64) - vmin.astype(jnp.uint64)
    else:
        enc = (values.astype(jnp.int64)
               - vmin.astype(jnp.int64)).astype(jnp.uint64)
    cls = None
    if validity is not None:
        cls = jnp.where(validity, jnp.int32(_CLS_VALID),
                        jnp.int32(_CLS_NULL))
        enc = jnp.where(validity, enc, jnp.uint64(0))
    return enc, cls


def _packed_decode(enc, kind, vmin, out_jax_dtype):
    if kind[0] == "f":
        return _order32_decode(enc, out_jax_dtype)
    if jnp.issubdtype(out_jax_dtype, jnp.unsignedinteger):
        return (enc + vmin.astype(jnp.uint64)).astype(out_jax_dtype)
    return (jax.lax.bitcast_convert_type(enc, jnp.int64)
            + vmin.astype(jnp.int64)).astype(out_jax_dtype)


def _exc_cumsum(x):
    return jnp.cumsum(x) - x


@functools.partial(jax.jit, static_argnames=("kplan", "vplan", "kb"))
def _packed_stage1(kplan, vplan, kb, key_arrs, kmins, val_arrs, vmins):
    """Sorts + cumsum planes of the packed plan, one XLA program.

    kplan: per key (nullable, base) — static.  vplan: per value column
    (role, kind, cb, vb, nullable, want_sum) with role in
    {mm, pay, cnt}; the first mm column rides the primary sort, other
    mm columns each get their own single-operand packed sort, pay/cnt
    columns ride the primary sort as one packed u64 payload each.
    Returns (s0, ngv, topk_plane, slot_planes, col_planes) where
    col_planes[i] is a tuple whose layout depends on vplan[i] (see
    _packed_plane_spec).
    """
    n = key_arrs[0][0].shape[0]
    combined = jnp.zeros((n,), jnp.uint64)
    for (nullable, base), (v, m), kmin in zip(kplan, key_arrs, kmins):
        if jnp.issubdtype(v.dtype, jnp.unsignedinteger):
            digit = v.astype(jnp.uint64) - kmin.astype(jnp.uint64)
        else:
            digit = (v.astype(jnp.int64)
                     - kmin.astype(jnp.int64)).astype(jnp.uint64)
        if nullable:
            digit = jnp.where(m, digit + jnp.uint64(1), jnp.uint64(0))
        combined = combined * jnp.uint64(base) + digit

    # assemble sort operands
    prim_idx = next((i for i, vp in enumerate(vplan) if vp[0] == "mm"),
                    None)
    payloads = []
    pay_pos = {}
    encs = {}
    for ci, (role, kind, cb, vb, nullable, want_sum) in enumerate(vplan):
        v, m = val_arrs[ci]
        if role == "cnt":
            pay_pos[ci] = len(payloads)
            payloads.append(m.astype(jnp.uint64))
            continue
        if role == "pay64":
            pay_pos[ci] = len(payloads)
            payloads.append(v)
            if nullable:
                payloads.append(m.astype(jnp.uint8))
            continue
        enc, cls = _packed_encode(v, m, kind, vmins[ci], vb)
        encs[ci] = (enc, cls)
        if role == "pay":
            valid01 = jnp.ones(enc.shape, jnp.uint64) if m is None \
                else m.astype(jnp.uint64)
            if kind[0] == "f":
                # enc<<2 | isnan<<1 | valid (NaN-ness must survive the
                # sort: NaN rows carry enc 0)
                nan01 = (cls == 1).astype(jnp.uint64)
                p = (enc << jnp.uint64(2)) | (nan01 << jnp.uint64(1)) \
                    | valid01
            else:
                p = (enc << jnp.uint64(1)) | valid01
            pay_pos[ci] = len(payloads)
            payloads.append(p)

    if prim_idx is not None:
        role, kind, cb, vb, nullable, want_sum = vplan[prim_idx]
        enc, cls = encs[prim_idx]
        packed0 = combined << jnp.uint64(cb + vb)
        if cls is not None:
            packed0 = packed0 | (cls.astype(jnp.uint64) << jnp.uint64(vb))
        packed0 = packed0 | enc
        shift0 = cb + vb
    else:
        packed0 = combined
        shift0 = 0

    sorted0 = jax.lax.sort((packed0,) + tuple(payloads), num_keys=1,
                           is_stable=False)
    s0 = sorted0[0]
    kpart = s0 >> jnp.uint64(shift0)
    neq = kpart[1:] != kpart[:-1]
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])
    ngv = jnp.sum(run_start.astype(jnp.int64))
    topk_plane = ((run_start.astype(jnp.uint64) << jnp.uint64(63))
                  | (~s0 & jnp.uint64((1 << 63) - 1)))

    # per-extra-mm-slot sorts (same run intervals: the combined code
    # occupies the high bits of every packed operand)
    slot_planes = []
    for ci, (role, kind, cb, vb, nullable, want_sum) in enumerate(vplan):
        if role != "mm" or ci == prim_idx:
            continue
        enc, cls = encs[ci]
        p = combined << jnp.uint64(cb + vb)
        if cls is not None:
            p = p | (cls.astype(jnp.uint64) << jnp.uint64(vb))
        p = p | enc
        (sp,) = jax.lax.sort((p,), num_keys=1, is_stable=False)
        slot_planes.append(sp)

    # per-column cumsum planes, all derived from the sorted operands
    slot_it = iter(slot_planes)
    col_planes = []
    for ci, (role, kind, cb, vb, nullable, want_sum) in enumerate(vplan):
        planes = {}
        if role == "cnt":
            pm = sorted0[1 + pay_pos[ci]]
            planes["vccs"] = _exc_cumsum(pm.astype(jnp.int32))
            planes["vctot"] = jnp.sum(pm.astype(jnp.int64)) \
                .astype(jnp.int32)
            col_planes.append(planes)
            continue
        if role == "pay64":
            val = sorted0[1 + pay_pos[ci]]
            pval = sorted0[2 + pay_pos[ci]] == 1 if nullable \
                else jnp.ones(val.shape, jnp.bool_)
            ok = pval & ~jnp.isnan(val)
            fin = ok & jnp.isfinite(val)
            contrib = jnp.where(fin, val, 0.0)
            planes["fcs"] = _exc_cumsum(contrib)
            planes["ftot"] = jnp.sum(contrib)
            pinf = (ok & (val == jnp.inf)).astype(jnp.int64)
            ninf = (ok & (val == -jnp.inf)).astype(jnp.int64)
            nan = (pval & jnp.isnan(val)).astype(jnp.int64)
            mix = (pinf << 42) | (ninf << 21) | nan
            planes["mixcs"] = _exc_cumsum(mix)
            planes["mixtot"] = jnp.sum(mix)
            if nullable:
                planes["vccs"] = _exc_cumsum(pval.astype(jnp.int32))
                planes["vctot"] = jnp.sum(pval.astype(jnp.int64)) \
                    .astype(jnp.int32)
            col_planes.append(planes)
            continue
        if role == "mm":
            sp = s0 if ci == prim_idx else next(slot_it)
            scls = (sp >> jnp.uint64(vb)) & jnp.uint64(3) if cb else None
            senc = sp & jnp.uint64((1 << vb) - 1)
            if ci != prim_idx:
                planes["s"] = sp
            if cb:
                nn01 = (scls <= jnp.uint64(1)).astype(jnp.int32)
                planes["nncs"] = _exc_cumsum(nn01)
                planes["nntot"] = jnp.sum(nn01.astype(jnp.int64)) \
                    .astype(jnp.int32)
            if want_sum:
                if kind[0] == "f":
                    val = _order32_decode(senc, jnp.float64)
                    ok = (scls == 0) if cb else \
                        jnp.ones(sp.shape, jnp.bool_)
                    fin = ok & jnp.isfinite(val)
                    contrib = jnp.where(fin, val, 0.0)
                    planes["fcs"] = _exc_cumsum(contrib)
                    planes["ftot"] = jnp.sum(contrib)
                    pinf = (ok & (val == jnp.inf)).astype(jnp.int64)
                    ninf = (ok & (val == -jnp.inf)).astype(jnp.int64)
                    v0 = ok.astype(jnp.int64)
                    mix = (pinf << 42) | (ninf << 21) | v0
                    planes["mixcs"] = _exc_cumsum(mix)
                    planes["mixtot"] = jnp.sum(mix)
                else:
                    contrib = jnp.where(scls == 0, senc, jnp.uint64(0)) \
                        if cb else senc
                    planes["ecs"] = _exc_cumsum(contrib)
                    planes["etot"] = jnp.sum(contrib)
            col_planes.append(planes)
            continue
        # pay: one packed payload (enc << shift | flags)
        p = sorted0[1 + pay_pos[ci]]
        if kind[0] == "f":
            penc = p >> jnp.uint64(2)
            pnan = ((p >> jnp.uint64(1)) & jnp.uint64(1)) == 1
            pval = (p & jnp.uint64(1)) == 1
            val = _order32_decode(penc, jnp.float64)
            ok = pval & ~pnan
            fin = ok & jnp.isfinite(val)
            contrib = jnp.where(fin, val, 0.0)
            planes["fcs"] = _exc_cumsum(contrib)
            planes["ftot"] = jnp.sum(contrib)
            pinf = (ok & (val == jnp.inf)).astype(jnp.int64)
            ninf = (ok & (val == -jnp.inf)).astype(jnp.int64)
            nan = (pval & pnan).astype(jnp.int64)
            mix = (pinf << 42) | (ninf << 21) | nan
            planes["mixcs"] = _exc_cumsum(mix)
            planes["mixtot"] = jnp.sum(mix)
            if nullable:
                planes["vccs"] = _exc_cumsum(pval.astype(jnp.int32))
                planes["vctot"] = jnp.sum(pval.astype(jnp.int64)) \
                    .astype(jnp.int32)
        else:
            penc = p >> jnp.uint64(1)
            pval = (p & jnp.uint64(1)) == 1
            contrib = jnp.where(pval, penc, jnp.uint64(0))
            planes["ecs"] = _exc_cumsum(contrib)
            planes["etot"] = jnp.sum(contrib)
            if nullable:
                planes["vccs"] = _exc_cumsum(pval.astype(jnp.int32))
                planes["vctot"] = jnp.sum(pval.astype(jnp.int64)) \
                    .astype(jnp.int32)
        col_planes.append(planes)

    return s0, ngv, topk_plane, tuple(slot_planes), tuple(col_planes)


@functools.partial(jax.jit, static_argnames=("kplan", "vplan", "aplan",
                                             "kb", "shift0", "k_b",
                                             "g_total"))
def _packed_stage2(kplan, vplan, aplan, kb, shift0, k_b, g_total,
                   s0, topk_plane, slot_planes, col_planes, ng,
                   kmins, vmins):
    """top_k run discovery + gathers at run starts + decode, one XLA
    program with k padded to k_b (a power of two) so varying group
    cardinality reuses the compiled program; callers slice [:ng]."""
    n = s0.shape[0]
    cp = col_planes
    tvals, st = jax.lax.top_k(topk_plane, k_b)
    st = st.astype(jnp.int32)
    inv = ~tvals & jnp.uint64((1 << 63) - 1)
    s_start = inv                       # == s0[st] for the first ng rows
    gidx = jnp.arange(k_b, dtype=jnp.int64)
    last = gidx == (ng - 1)
    pad = gidx >= ng
    st_next = jnp.where(
        last | pad, jnp.int32(n),
        jnp.concatenate([st[1:], jnp.full((1,), n, jnp.int32)]))
    cnt_all = (st_next - st).astype(jnp.int64)
    cnt_all = jnp.where(pad, jnp.int64(0), cnt_all)

    # decode keys from the combined code (mixed radix, matches
    # _bin_finalize: null digit 0 sorts first)
    key_out = _decode_packed_keys(kplan, kmins, g_total,
                                  s_start >> jnp.uint64(shift0))

    def seg_diff(plane, tot):
        """Per-group diff of an exclusive-cumsum plane."""
        at = jnp.take(plane, st, mode="clip")
        nxt = jnp.where(
            last | pad, tot.astype(plane.dtype),
            jnp.concatenate([at[1:], at[:1]]))
        d = nxt - at
        return jnp.where(pad, jnp.zeros((), d.dtype), d)

    prim_idx = next((i for i, vp in enumerate(vplan) if vp[0] == "mm"),
                    None)
    slot_it = iter(slot_planes)
    slot_of = {}
    for ci, vp in enumerate(vplan):
        if vp[0] == "mm":
            slot_of[ci] = s0 if ci == prim_idx else next(slot_it)

    col_cache = {}

    def col_stats(ci):
        """Per-column (validcnt, min_enc/cls, max_enc/cls, sums...)."""
        if ci in col_cache:
            return col_cache[ci]
        role, kind, cb, vb, nullable, want_sum = vplan[ci]
        d = cp[ci]
        out = {}
        if role == "cnt":
            out["vc"] = seg_diff(d["vccs"], d["vctot"]).astype(jnp.int64)
            col_cache[ci] = out
            return out
        if role == "mm":
            sp = slot_of[ci]
            if cb:
                nn = seg_diff(d["nncs"], d["nntot"]).astype(jnp.int64)
            else:
                nn = cnt_all
            out["vc"] = nn
            mn_packed = s_start if ci == prim_idx \
                else jnp.take(sp, st, mode="clip")
            mx_pos = jnp.clip(st.astype(jnp.int64) + nn - 1, 0, n - 1)
            mx_packed = jnp.take(sp, mx_pos.astype(jnp.int32),
                                 mode="clip")
            vmask = jnp.uint64((1 << vb) - 1)
            out["mn_enc"] = mn_packed & vmask
            out["mx_enc"] = mx_packed & vmask
            if cb:
                out["mn_cls"] = (mn_packed >> jnp.uint64(vb)) \
                    & jnp.uint64(3)
                out["mx_cls"] = (mx_packed >> jnp.uint64(vb)) \
                    & jnp.uint64(3)
        else:
            if nullable:
                out["vc"] = seg_diff(d["vccs"], d["vctot"]) \
                    .astype(jnp.int64)
            else:
                out["vc"] = cnt_all
        if want_sum:
            if kind[0] == "f":
                out["fsum"] = seg_diff(d["fcs"], d["ftot"])
                mix = seg_diff(d["mixcs"], d["mixtot"])
                mask21 = jnp.int64((1 << 21) - 1)
                out["pinf"] = (mix >> 42) & mask21
                out["ninf"] = (mix >> 21) & mask21
                low = mix & mask21
                if role == "mm":
                    # low lane counted cls==0 rows; NaNs = nonnull - that
                    out["nan"] = out["vc"] - low
                else:
                    out["nan"] = low
            else:
                out["esum"] = seg_diff(d["ecs"], d["etot"])
        col_cache[ci] = out
        return out

    agg_out, flags = _emit_packed_aggs(vplan, aplan, vmins, col_stats,
                                       cnt_all, pad)
    return key_out, agg_out, flags


def _decode_packed_keys(kplan, kmins, g_total, combined):
    """Mixed-radix decode of group key columns from the combined code
    (matches _bin_finalize: null digit 0 sorts first).  Traced helper
    of _packed_stage2."""
    key_out = []
    stride = g_total
    for (nullable, base), kmin in zip(kplan, kmins):
        stride //= base
        digit = (combined // jnp.uint64(stride)) % jnp.uint64(base)
        if nullable:
            isnull = digit == 0
            digit = jnp.where(isnull, jnp.uint64(1), digit) \
                - jnp.uint64(1)
            mask = ~isnull
        else:
            mask = None
        if jnp.issubdtype(kmin.dtype, jnp.unsignedinteger):
            vals = digit + kmin.astype(jnp.uint64)
        else:
            vals = jax.lax.bitcast_convert_type(digit, jnp.int64) \
                + kmin.astype(jnp.int64)
        key_out.append((vals.astype(kmin.dtype), mask))
    return key_out


def _emit_packed_aggs(vplan, aplan, vmins, col_stats, cnt_all, pad):
    """Aggregate emission over per-column stats (traced helper of
    _packed_stage2).  col_stats(ci) supplies vc and the op-specific
    fields (esum/fsum/mn_enc/mx_enc/...)."""
    agg_out = []
    mask_flags = []           # per-agg: True when every group is valid
    for op, ci, kind, out_name in aplan:
        if op == "count_all":
            agg_out.append((cnt_all, None))
            continue
        st_c = col_stats(ci)
        if op == "count":
            agg_out.append((st_c["vc"], None))
            continue
        role, _, cb, vb, nullable, want_sum = vplan[ci]
        vc = st_c["vc"]
        if nullable or kind[0] == "f":
            gvalid = vc > 0
            mask_flags.append(jnp.all(jnp.where(pad, True, gvalid)))
        else:
            # non-nullable source: every group has >= 1 valid row, no
            # device round-trip needed for the output mask
            gvalid = None
        out_jax = np.dtype(out_name)
        vmin = vmins[ci]
        if op in ("sum", "mean"):
            if kind[0] == "f":
                total = st_c["fsum"]
                total = jnp.where(st_c["pinf"] > 0, jnp.inf, total)
                total = jnp.where(st_c["ninf"] > 0, -jnp.inf, total)
                total = jnp.where(
                    (st_c["nan"] > 0)
                    | ((st_c["pinf"] > 0) & (st_c["ninf"] > 0)),
                    jnp.nan, total)
                s_out = total.astype(out_jax) if op == "sum" else \
                    total / jnp.maximum(vc, 1).astype(jnp.float64)
            else:
                esum = st_c["esum"]
                if jnp.issubdtype(vmin.dtype, jnp.unsignedinteger):
                    off = vmin.astype(jnp.uint64)
                else:
                    off = jax.lax.bitcast_convert_type(
                        vmin.astype(jnp.int64), jnp.uint64)
                total = esum + vc.astype(jnp.uint64) * off
                if op == "mean":
                    s_out = jax.lax.bitcast_convert_type(
                        total, jnp.int64).astype(jnp.float64) \
                        / jnp.maximum(vc, 1).astype(jnp.float64)
                elif jnp.issubdtype(out_jax, jnp.unsignedinteger):
                    s_out = total.astype(out_jax)
                else:
                    s_out = jax.lax.bitcast_convert_type(
                        total, jnp.int64).astype(out_jax)
            agg_out.append((s_out, gvalid))
        else:
            enc = st_c["mn_enc" if op == "min" else "mx_enc"]
            vals = _packed_decode(enc, kind, vmin, out_jax)
            if kind[0] == "f":
                cls = st_c["mn_cls" if op == "min" else "mx_cls"]
                vals = jnp.where(cls == 1,
                                 jnp.array(jnp.nan, vals.dtype), vals)
            agg_out.append((vals, gvalid))
    flags = jnp.stack(mask_flags) if mask_flags \
        else jnp.ones((1,), jnp.bool_)
    return agg_out, flags


def _kb_bucket(x: int, n: int) -> int:
    """k_b padding buckets {2^i, 3*2^(i-1)} (<= 33% padding) so varying
    cardinality reuses compiled programs while gathers stay lean."""
    b = max(0, x - 1).bit_length()
    k = 1 << b
    if b >= 2 and 3 << (b - 2) >= x:
        k = 3 << (b - 2)
    return int(min(max(k, 1), n))


def _packed_sort_path(table: Table, key_cols, keys, aggs, sc, int_scan,
                      val_cols, col_idx, needs) -> Optional[Table]:
    """High-cardinality integer-key fast path (see block comment above).
    Returns None when the plan doesn't fit (f64 min/max, key/value bits
    over budget, rows beyond the chunk bound) — callers fall through to
    the general discovery sort."""
    from ..core.column import NullColumn
    n = table.num_rows
    if n > _PACKED_CHUNK or n >= (1 << 31):
        return None

    kplan = []
    g_total = 1
    for i, c in enumerate(key_cols):
        kmin, kmax, nullable = sc[i]
        if kmin > kmax:
            kmin, kmax = 0, 0
        base = (kmax - kmin + 1) + (1 if nullable else 0)
        g_total *= base
        if (g_total - 1).bit_length() > _PACKED_BITS:
            return None
        kplan.append((nullable, base, kmin))
    kb = (g_total - 1).bit_length()

    # value plan
    vplan = []
    vmins_host = []
    for ci, c in enumerate(val_cols):
        cname = [k for k, v in col_idx.items() if v == ci][0]
        ops_c = needs[cname]
        nullable = (not isinstance(c, PrimitiveColumn)
                    or isinstance(c, NullColumn)
                    or c.validity is not None)
        if not (ops_c - {"count"}):
            vplan.append(("cnt", "", 0, 0, True, False))
            vmins_host.append(0)
            continue
        want_sum = bool(ops_c & {"sum", "mean"})
        has_mm = bool(ops_c & {"min", "max"})
        if c.dtype.is_floating:
            if c.dtype.name == "float64":
                if has_mm:
                    return None   # 64 value bits leave none for the key
                # f64 SUM rides the primary sort as a raw f64 payload
                vplan.append(("pay64", "f64", 0, 0, nullable, True))
                vmins_host.append(0)
                continue
            kind = "f" + c.dtype.name[5:]
            vmin = 0
            vb = 32
            cb = 2
        else:
            vmin, vmax, _ = int_scan[ci]
            if vmin > vmax:
                vmin = vmax = 0
            kind = _bin_val_kind(c, vmin, vmax)
            vb = (vmax - vmin).bit_length()
            cb = 2 if nullable else 0
        if has_mm:
            if kb + cb + vb > _PACKED_BITS:
                return None
            role = "mm"
        else:
            if vb + 2 > 64:
                return None
            role = "pay"
            cb = 0
        vplan.append((role, kind, cb, vb, nullable, want_sum))
        vmins_host.append(vmin)

    prim_idx = next((i for i, vp in enumerate(vplan) if vp[0] == "mm"),
                    None)
    if prim_idx is not None:
        _, _, cb0, vb0, _, _ = vplan[prim_idx]
        shift0 = cb0 + vb0
    else:
        shift0 = 0

    aplan = []
    for a in aggs:
        if a.op == "count_all":
            aplan.append(("count_all", -1, "", ""))
            continue
        ci = col_idx[a.column]
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        aplan.append((a.op, ci, vplan[ci][1],
                      np.dtype(out_dt.to_jax()).name))

    kplan_s = tuple((nu, b) for nu, b, _ in kplan)
    kmins = tuple(jnp.asarray(km, key_cols[i].values.dtype)
                  for i, (_, _, km) in enumerate(kplan))
    vplan_s = tuple(vplan)
    vmins = tuple(jnp.asarray(
        vm, val_cols[i].values.dtype
        if isinstance(val_cols[i], PrimitiveColumn)
        and not isinstance(val_cols[i], NullColumn)
        and val_cols[i].dtype.is_integer else jnp.int64)
        for i, vm in enumerate(vmins_host))

    key_arrs = tuple((c.values, c.validity) for c in key_cols)
    val_arrs = []
    for (role, kind, cb, vb, nullable, want_sum), c in zip(vplan_s,
                                                           val_cols):
        if role == "cnt":
            m = c.is_valid_mask()
            if isinstance(c, NullColumn):
                m = jnp.zeros((len(c),), jnp.bool_)
            val_arrs.append((None, m))
        else:
            val_arrs.append((c.values, c.validity))
    val_arrs = tuple(val_arrs)

    aplan_s = tuple(aplan)
    s0, ngv, topk_plane, slot_planes, col_planes = _packed_stage1(
        kplan_s, vplan_s, kb, key_arrs, kmins, val_arrs, vmins)
    ng = int(ngv)                       # ONE round trip
    k_b = _kb_bucket(ng, n)
    key_out, agg_out, flags = _packed_stage2(
        kplan_s, vplan_s, aplan_s, kb, shift0, k_b, g_total,
        s0, topk_plane, slot_planes, col_planes,
        jnp.asarray(ng, jnp.int64), kmins, vmins)
    flags_host = np.asarray(flags)      # ONE device round-trip

    out_cols: List[Column] = []
    fields = []
    for (vals, mask), c, kname in zip(key_out, key_cols, keys):
        vals = vals[:ng]
        mask = None if mask is None else mask[:ng]
        out_cols.append(PrimitiveColumn(vals, c.dtype, mask,
                                        _canonical=True))
        fields.append(table.schema.field(kname))
    fi = 0
    for a, (vals, gvalid) in zip(aggs, agg_out):
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        if out_dt.is_null:
            out_dt = dt.int64
        nullable = a.op not in ("count", "count_all")
        vals = vals[:ng]
        mask = None
        if nullable and gvalid is not None:
            if not bool(flags_host[fi]):
                mask = gvalid[:ng]
            fi += 1
        out_cols.append(PrimitiveColumn(vals, out_dt, mask,
                                        _canonical=True))
        fields.append(dt.Field(a.out_name, out_dt, nullable=nullable))
    return Table(tuple(out_cols), dt.Schema(tuple(fields)))


def _int_range_fast_path(table: Table, key_cols, keys, aggs
                         ) -> Optional[Table]:
    from ..core.column import NullColumn
    n = table.num_rows
    for c in key_cols:
        if not isinstance(c, PrimitiveColumn) or isinstance(c, NullColumn):
            return None
        if not c.dtype.is_integer:
            return None
    # value columns: primitive int/float for value aggs; anything for count
    val_cols: List = []
    col_idx = {}
    needs = {}
    for a in aggs:
        if a.op == "count_all":
            continue
        src = table.column(a.column)
        if a.column not in col_idx:
            col_idx[a.column] = len(val_cols)
            val_cols.append(src)
            needs[a.column] = set()
        needs[a.column].add(a.op)
        if a.op == "count":
            continue
        if isinstance(src, NullColumn):
            return None       # all-null value aggs: rare; general path
        if not isinstance(src, PrimitiveColumn):
            return None
        if not (src.dtype.is_integer or src.dtype.is_floating):
            return None

    # one fused range scan: key columns + integer value columns
    scan_items = [(c.values, c.validity) for c in key_cols]
    int_val_pos = []
    for ci, c in enumerate(val_cols):
        ops_c = needs[[k for k, v in col_idx.items() if v == ci][0]]
        if ops_c - {"count"} and isinstance(c, PrimitiveColumn) \
                and c.dtype.is_integer:
            int_val_pos.append(ci)
            scan_items.append((c.values, c.validity))
    scan = np.asarray(_bin_range_scan(tuple(scan_items)))  # one fetch
    sc = []
    for (v, _), row in zip(scan_items, scan):
        mn, mx = int(row[0]), int(row[1])
        if jnp.issubdtype(v.dtype, jnp.unsignedinteger):
            mn &= (1 << 64) - 1
            mx &= (1 << 64) - 1
        sc.append((mn, mx, bool(row[2])))

    # key plan
    int_scan = dict(zip(int_val_pos, sc[len(key_cols):]))
    kplan = []
    g_total = 1
    cap = min(_BIN_CAP, max(1024, 4 * n))
    for i, c in enumerate(key_cols):
        kmin, kmax, nullable = sc[i]
        if kmin > kmax:      # no valid keys at all
            kmin, kmax = 0, 0
        size = kmax - kmin + 1
        base = size + (1 if nullable else 0)
        g_total *= base
        if g_total > cap:
            # domain too large for perfect binning: high-cardinality
            # packed-sort plan (may itself bail to the general path)
            return _packed_sort_path(table, key_cols, keys, aggs, sc,
                                     int_scan, val_cols, col_idx, needs)
        kplan.append((nullable, base, kmin))
    if g_total <= 0:
        return None

    # value plan
    vplan = []
    vmins_host = []
    aplan = []
    sort_count = 1
    first_mm_taken = False
    for ci, c in enumerate(val_cols):
        cname = [k for k, v in col_idx.items() if v == ci][0]
        ops_c = needs[cname]
        if not (ops_c - {"count"}):
            vplan.append(("cnt", c.validity is not None, False, 0))
            vmins_host.append(0)
            continue
        if isinstance(c, PrimitiveColumn) and c.dtype.is_integer:
            vmin, vmax, _ = int_scan[ci]
            if vmin > vmax:
                vmin = vmax = 0
            kind = _bin_val_kind(c, vmin, vmax)
        else:
            vmin = 0
            kind = "f" + c.dtype.name[5:]
        has_mm = bool(ops_c & {"min", "max"})
        if has_mm:
            if not first_mm_taken:
                sort_idx = 0
                first_mm_taken = True
            else:
                sort_idx = sort_count
                sort_count += 1
        else:
            sort_idx = 0
        nullable = c.validity is not None
        vplan.append((kind, nullable, has_mm, sort_idx))
        vmins_host.append(vmin)
    # re-number extra sorts densely after the primary
    # (sort_idx values are already dense by construction)

    for a in aggs:
        if a.op == "count_all":
            aplan.append(("count_all", -1, "", ""))
            continue
        ci = col_idx[a.column]
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        aplan.append((a.op, ci, vplan[ci][0],
                      np.dtype(out_dt.to_jax()).name))

    kplan_s = tuple((nu, b) for nu, b, _ in kplan)
    kmins = tuple(jnp.asarray(km, key_cols[i].values.dtype)
                  for i, (_, _, km) in enumerate(kplan))
    vplan_s = tuple(vplan)
    vmins = tuple(jnp.asarray(vm,
                              val_cols[i].values.dtype
                              if isinstance(val_cols[i], PrimitiveColumn)
                              and not isinstance(val_cols[i], NullColumn)
                              and val_cols[i].dtype.is_integer
                              else jnp.int64)
                  for i, vm in enumerate(vmins_host))

    def col_slices(s, e):
        karrs = tuple((c.values[s:e],
                       None if c.validity is None else c.validity[s:e])
                      for c in key_cols)
        varrs = []
        for (kind, *_), c in zip(vplan_s, val_cols):
            if kind == "cnt":
                m = c.validity
                varrs.append((jnp.zeros((e - s,), jnp.int8)
                              if not isinstance(c, PrimitiveColumn)
                              or isinstance(c, NullColumn)
                              else c.values[s:e],
                              None if m is None else m[s:e]))
            else:
                varrs.append((c.values[s:e],
                              None if c.validity is None
                              else c.validity[s:e]))
        return karrs, tuple(varrs)

    import math
    nchunks = max(1, math.ceil(n / _BIN_CHUNK))
    q = math.ceil(n / nchunks) if n else 1
    acc = None
    for i in range(nchunks):
        s, e = i * q, min(n, (i + 1) * q)
        karrs, varrs = col_slices(s, e)
        part = _bin_chunk_stage(kplan_s, vplan_s, g_total, karrs,
                                kmins, varrs, vmins)
        acc = part if acc is None else _bin_merge(vplan_s, acc, part)
    cnt_all, cols = acc

    n_occ = int(np.asarray(jnp.sum(cnt_all > 0)))
    aplan_s = tuple(aplan)
    key_out, agg_out = _bin_finalize(kplan_s, aplan_s, g_total, n_occ,
                                     cnt_all, cols, kmins, vmins)

    out_cols: List[Column] = []
    fields = []
    for (vals, mask), c, kname in zip(key_out, key_cols, keys):
        out_cols.append(PrimitiveColumn(vals.astype(c.values.dtype),
                                        c.dtype, mask, _canonical=True))
        fields.append(table.schema.field(kname))
    for a, (vals, gvalid) in zip(aggs, agg_out):
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        nullable = a.op not in ("count", "count_all")
        mask = None
        if nullable and gvalid is not None and not bool(jnp.all(gvalid)):
            mask = gvalid
        out_cols.append(PrimitiveColumn(vals, out_dt, mask,
                                        _canonical=True))
        fields.append(dt.Field(a.out_name, out_dt, nullable=nullable))
    return Table(tuple(out_cols), dt.Schema(tuple(fields)))


@jax.jit
def _bin_range_scan(items):
    """Masked (min, max, has_null) per (values, validity) column as ONE
    (ncols, 3) i64 tensor — a single host fetch instead of one per
    scalar (u64 extremes ride bitcast)."""
    rows = []
    for v, m in items:
        info = jnp.iinfo(v.dtype)
        lo_id = jnp.array(info.max, v.dtype)
        hi_id = jnp.array(info.min, v.dtype)
        vv = v if m is None else jnp.where(m, v, lo_id)
        ww = v if m is None else jnp.where(m, v, hi_id)
        mn, mx = jnp.min(vv), jnp.max(ww)
        if jnp.issubdtype(v.dtype, jnp.unsignedinteger):
            mn64 = jax.lax.bitcast_convert_type(
                mn.astype(jnp.uint64), jnp.int64)
            mx64 = jax.lax.bitcast_convert_type(
                mx.astype(jnp.uint64), jnp.int64)
        else:
            mn64, mx64 = mn.astype(jnp.int64), mx.astype(jnp.int64)
        nul = jnp.zeros((), jnp.int64) if m is None \
            else jnp.any(~m).astype(jnp.int64)
        rows.append(jnp.stack([mn64, mx64, nul]))
    return jnp.stack(rows)


def _group_by_string_minmax(table: Table, keys, aggs, str_mm) -> Table:
    """MIN/MAX over string/dictionary sources: aggregate the
    order-preserving u64 rank key (row_format.encode_value_key — rank
    order == byte order), then decode each group's winning rank back to
    a dictionary code and take the value.  The recursive group_by sees
    only primitive sources, so every fast path (binning, packing,
    chunking) still applies."""
    from .row_format import dictionary_value_ranks, encode_value_key
    from .strings import dictionary_encode

    proxies = {}        # source column name -> (proxy name, dict col)
    new_cols = list(table.columns)
    new_fields = list(table.schema.fields)
    new_aggs = list(aggs)
    for i in str_mm:
        a = aggs[i]
        if a.column not in proxies:
            src = table.column(a.column)
            dcol = src if isinstance(src, DictionaryColumn) \
                else dictionary_encode(src)
            key, eff_valid = encode_value_key(dcol)
            pname = f"__strmm_{a.column}"
            new_cols.append(PrimitiveColumn(key, dt.uint64, eff_valid))
            new_fields.append(dt.Field(pname, dt.uint64))
            proxies[a.column] = (pname, dcol)
        pname, _ = proxies[a.column]
        new_aggs[i] = AggSpec(pname, a.op, name=a.out_name)
    res = group_by(Table(tuple(new_cols),
                         dt.Schema(tuple(new_fields))), keys, new_aggs)

    out_cols = list(res.columns)
    out_fields = list(res.schema.fields)
    nkeys = len(keys)
    for i in str_mm:
        a = aggs[i]
        pname, dcol = proxies[a.column]
        rank_col = res.columns[nkeys + i]
        ranks_np, dict_null = dictionary_value_ranks(dcol.values)
        valid_codes = np.nonzero(~dict_null)[0]
        nranks = int(ranks_np[~dict_null].max()) + 1 \
            if (~dict_null).any() else 0
        rank_to_code = np.zeros(max(nranks, 1), np.int64)
        for c in valid_codes[::-1]:
            rank_to_code[int(ranks_np[c])] = c
        won = jnp.clip(rank_col.values.astype(jnp.int64), 0,
                       max(nranks - 1, 0))
        codes = jnp.take(jnp.asarray(rank_to_code), won, mode="clip")
        out = take_kernel(dcol.values, PrimitiveColumn(codes, dt.int64))
        out = out.with_validity(rank_col.validity)
        src_dt = table.column(a.column).dtype
        if isinstance(table.column(a.column), DictionaryColumn):
            out_dt = src_dt.value_type
        else:
            out_dt = src_dt
        out_cols[nkeys + i] = out
        out_fields[nkeys + i] = dt.Field(a.out_name, out_dt)
    return Table(tuple(out_cols), dt.Schema(tuple(out_fields)))


def _empty_agg(table: Table, a: AggSpec):
    src = table.column(a.column)
    out_dt = _agg_dtype(src.dtype, a.op)
    if out_dt.is_string or out_dt.is_dictionary:
        d = out_dt.value_type if out_dt.is_dictionary else out_dt
        return (StringColumn.from_pylist([], d), dt.Field(a.out_name, d))
    return (PrimitiveColumn(jnp.zeros((0,), out_dt.to_jax()), out_dt),
            dt.Field(a.out_name, out_dt))


# sort-path memory budget: the discover sort + agg stage hold several
# n-sized operands (keys, order, gid, per-column sorts); past this many
# rows, run two-level partial/final aggregation instead.  A bound
# inherited from a 16 GB device, not measured on the GPU.
_SORT_AGG_CHUNK = 125_000_000


class GroupByAccumulator:
    """STREAMING two-level grouped aggregation (the DataFusion
    partial/final AggregateMode shape; reference composition
    arrow-ord/src/partition.rs + arrow-arith/src/aggregate.rs:98): feed
    row chunks with update(), each aggregates locally with DECOMPOSED
    aggregates (mean -> sum + count), the small per-chunk group tables
    accumulate (re-compacting by a partial merge when they grow), and
    finalize() runs one final merge (sum/count -> sum, min -> min,
    max -> max).

    Integer sums stay exact (wrapping addition is associative mod 2^w);
    float sums compose chunk prefix-sum differences — the same
    deterministic-semantics class as the unchunked path.

    This is the out-of-device-memory path: a 500M-row x 10M-group
    aggregate never materializes the input — chunks stream through while
    only the per-chunk group tables stay resident."""

    # accumulated partial rows beyond this re-compact via partial merge
    # (a bound inherited from a 16 GB device, not measured on the GPU)
    COMPACT_ROWS = 150_000_000

    def __init__(self, keys: Sequence[str], aggs: Sequence[AggSpec]):
        self.keys = list(keys)
        self.aggs = list(aggs)
        self._parts: list = []
        self._part_rows = 0
        self._plan = None       # built from the first chunk's dtypes

    def _build_plan(self, table: Table):
        partial_specs = []
        merge_plan = []   # (out_name, kind, part names...)
        seen = {}
        wide_specs = {}
        src_dtypes = {}

        def add_partial(col, op):
            key = (col, op)
            if key not in seen:
                seen[key] = f"__p{len(partial_specs)}"
                partial_specs.append(AggSpec(col, op, seen[key]))
            return seen[key]

        def mean_source(colname):
            # mean needs the TRUE sum: partial sums are emitted in the
            # SOURCE dtype, so narrow ints/bools/f32 must widen first
            # or each chunk's partial wraps/rounds before the divide
            d = table.column(colname).dtype
            if d.name in ("int64", "uint64", "float64"):
                return colname
            wname = f"__wide_{colname}"
            wide_specs[wname] = (
                colname, dt.float64 if d.is_floating else dt.int64)
            return wname

        for a in self.aggs:
            src_dtypes[a.column] = table.column(a.column).dtype
            if a.op == "mean":
                s = add_partial(mean_source(a.column), "sum")
                c = add_partial(a.column, "count")
                merge_plan.append((a.out_name, "mean", s, c))
            elif a.op in ("count", "count_all"):
                merge_plan.append((a.out_name, "recount",
                                   add_partial(a.column, a.op)))
            else:
                merge_plan.append((a.out_name, a.op,
                                   add_partial(a.column, a.op)))
        self._plan = (partial_specs, merge_plan, wide_specs, src_dtypes)

    def _merge_specs(self):
        """Partial-to-partial merge (keeps partial names): sums/counts
        add, min/min max/max."""
        partial_specs = self._plan[0]
        return [AggSpec(p.out_name,
                        "sum" if p.op in ("sum", "count", "count_all")
                        else p.op, p.out_name)
                for p in partial_specs]

    def _widen(self, table: Table) -> Table:
        wide_specs = self._plan[2]
        if not wide_specs:
            return table
        from .cast import cast as _cast
        extra = {nm: _cast(table.column(src), d)
                 for nm, (src, d) in wide_specs.items()}
        return Table(
            tuple(table.columns) + tuple(extra.values()),
            dt.Schema(tuple(table.schema.fields)
                      + tuple(dt.Field(nm, c.dtype)
                              for nm, c in extra.items())))

    def update(self, chunk: Table) -> None:
        if self._plan is None:
            self._build_plan(chunk)
        part = group_by(self._widen(chunk), self.keys, self._plan[0])
        self._parts.append(part)
        self._part_rows += part.num_rows
        if self._part_rows > self.COMPACT_ROWS and len(self._parts) > 1:
            from .concat import concat_tables
            merged = group_by(concat_tables(self._parts), self.keys,
                              self._merge_specs())
            self._parts = [merged]
            self._part_rows = merged.num_rows

    # ---- double-buffered streaming (SURVEY §2.4: collectives/exchange
    # overlapping compute; here the host-loop analogue) ----------------
    #
    # update() blocks the host ~3x per chunk (range-scan fetch, group
    # count, validity flags), each a device round trip that leaves the
    # caller unable to enqueue the NEXT chunk's device work.
    # update_async() runs update() on one worker thread so chunk i+1's
    # generation/upload dispatches while chunk i's syncs are in flight.
    # Depth is capped at 2 chunks so at most one extra chunk's arrays
    # occupy device memory.  Partial-table order does not affect the
    # final merge.

    _MAX_IN_FLIGHT = 2

    def update_async(self, chunk: Table) -> None:
        if self._plan is None:
            # plan building inspects dtypes only; do it synchronously so
            # later submissions race-free read self._plan
            self._build_plan(chunk)
        if getattr(self, "_pool", None) is None:
            import concurrent.futures
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
            self._futs = []
        while len([f for f in self._futs if not f.done()]) \
                >= self._MAX_IN_FLIGHT:
            self._futs[0].result()
            self._futs = [f for f in self._futs if not f.done()]
        for f in self._futs:
            if f.done():
                f.result()          # surface worker exceptions eagerly
        self._futs = [f for f in self._futs if not f.done()]
        self._futs.append(self._pool.submit(self.update, chunk))

    def flush(self) -> None:
        """Wait for all pending async updates (re-raises their errors)."""
        for f in getattr(self, "_futs", []):
            f.result()
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._futs = []

    def finalize(self) -> Table:
        self.flush()
        if self._plan is None:
            raise ArrowInvalid("GroupByAccumulator saw no chunks")
        from .concat import concat_tables
        partial_specs, merge_plan, _, src_dtypes = self._plan
        merged = self._parts[0] if len(self._parts) == 1 \
            else concat_tables(self._parts)

        final_specs = []
        for name, kind, *pnames in merge_plan:
            if kind == "mean":
                final_specs.append(AggSpec(pnames[0], "sum", name + "#s"))
                final_specs.append(AggSpec(pnames[1], "sum", name + "#c"))
            elif kind == "recount":
                final_specs.append(AggSpec(pnames[0], "sum", name))
            else:
                final_specs.append(AggSpec(pnames[0], kind, name))
        out = group_by(merged, self.keys, final_specs)

        out_cols = list(out.columns[:len(self.keys)])
        fields = [out.schema.field(kname) for kname in self.keys]
        for a, (name, kind, *pnames) in zip(self.aggs, merge_plan):
            out_dt = _agg_dtype(src_dtypes[a.column], a.op)
            if kind == "mean":
                s_col = out.column(name + "#s")
                c_col = out.column(name + "#c")
                m = s_col.values.astype(jnp.float64) / \
                    jnp.maximum(c_col.values, 1).astype(jnp.float64)
                gvalid = c_col.values > 0
                mask = None if bool(jnp.all(gvalid)) else gvalid
                out_cols.append(PrimitiveColumn(m, dt.float64, mask))
                fields.append(dt.Field(name, dt.float64))
            elif kind == "recount":
                c = out.column(name)
                out_cols.append(PrimitiveColumn(
                    vd.canonicalize(c.values, c.validity), dt.int64,
                    _canonical=True))
                fields.append(dt.Field(name, dt.int64, nullable=False))
            else:
                c = out.column(name)
                out_cols.append(PrimitiveColumn(
                    c.values.astype(out_dt.to_jax()), out_dt, c.validity,
                    _canonical=True))
                fields.append(dt.Field(name, out_dt))
        return Table(tuple(out_cols), dt.Schema(tuple(fields)))


def _group_by_chunked(table: Table, keys, aggs, n: int) -> Table:
    """Out-of-device-memory grouped aggregation over a materialized
    input: slice into chunks and stream them through
    GroupByAccumulator."""
    import math
    k = math.ceil(n / _SORT_AGG_CHUNK)
    q = math.ceil(n / k)
    acc = GroupByAccumulator(keys, aggs)
    for i in range(k):
        acc.update(table.slice(i * q, min(q, n - i * q)))
    return acc.finalize()


def _agg_dtype(src: dt.DataType, op: str) -> dt.DataType:
    if op in ("count", "count_all"):
        return dt.int64
    if op == "mean":
        return dt.float64
    return src


@functools.partial(jax.jit, static_argnames=("plan", "num_groups",
                                             "presorted"))
def _agg_stage(plan, num_groups, order, gid, run_start, starts_raw,
               arrays, presorted=False):
    """All aggregates of one group_by in a single XLA program.

    plan: static tuple of (op, slot, kind) per aggregate; arrays: per
    slot (values, valid) in ORIGINAL row order.  Strategy (scatter-free,
    so every result is deterministic):
      1. cumsum + boundary diff      sums/counts, any cardinality
                                     (exact for ints: wrapping arithmetic
                                     is associative mod 2^64; floats get
                                     one fixed prefix-sum order)
      2. secondary (gid, value) sort min/max, any dtype, any cardinality
    Returns ([(values, group_valid)] per agg, first_idx).
    """
    n = gid.shape[0]
    starts = starts_raw[:num_groups]
    first_idx = order[starts]
    nxt = jnp.concatenate([starts[1:], jnp.array([n], starts.dtype)])
    counts_all = (nxt - starts).astype(jnp.int64)

    def diff_sums(contrib):
        cs = jnp.cumsum(contrib)
        end_cs = cs[nxt - 1]
        start_cs = jnp.concatenate([jnp.zeros((1,), cs.dtype),
                                    end_cs[:-1]])
        return end_cs - start_cs

    sorted_cache = {}

    def sorted_col(slot):
        """(sorted values, sorted validity-or-None)."""
        if slot not in sorted_cache:
            v, m = arrays[slot]
            if presorted:
                sorted_cache[slot] = (v, m)
            else:
                sorted_cache[slot] = (v[order],
                                      None if m is None else m[order])
        return sorted_cache[slot]

    counts_cache = {}

    def valid_counts(slot):
        if slot not in counts_cache:
            _, ms = sorted_col(slot)
            counts_cache[slot] = counts_all if ms is None \
                else diff_sums(ms.astype(jnp.int64))
        return counts_cache[slot]

    mm_cache = {}

    def minmax_sorted(slot):
        """Values re-ordered by (gid, valid-first, value) so each
        group's min sits at its run start and max at
        start + valid_count - 1.  Operand diet (multi-operand sorts
        move every byte through every merge pass):
          * the VALUE is its own sort key: lax.sort orders native ints
            and floats directly (floats: NaN slots zero out of the
            value and ride the class key);
          * the 2-bit class (0 valid, 1 NaN, 2 null; nulls last within
            the group) packs into the gid key's low bits while
            n < 2^29, collapsing to TWO sort operands total."""
        if slot not in mm_cache:
            vs, ms = sorted_col(slot)
            gid32 = gid
            isfloat = bool(jnp.issubdtype(vs.dtype, jnp.floating))
            if isfloat:
                isnan = jnp.isnan(vs)
                vals = jnp.where(isnan, jnp.zeros((), vs.dtype), vs)
                cls = isnan.astype(jnp.int32) if ms is None else \
                    jnp.where(ms, isnan.astype(jnp.int32), 2)
            else:
                vals = vs
                cls = None if ms is None else (~ms).astype(jnp.int32)
            if cls is None:
                s = jax.lax.sort((gid32, vals), num_keys=2,
                                 is_stable=False)
                mm_cache[slot] = (s[1], None, False, isfloat)
            elif n < 2 ** 29:
                packed = (gid32 << 2) | cls
                s = jax.lax.sort((packed, vals), num_keys=2,
                                 is_stable=False)
                mm_cache[slot] = (s[1], s[0], True, isfloat)
            else:
                s = jax.lax.sort((gid32, cls.astype(jnp.uint8), vals),
                                 num_keys=3, is_stable=False)
                mm_cache[slot] = (s[2], s[1], False, isfloat)
        return mm_cache[slot]

    def mm_pick(slot, idx):
        svals, csrc, packed, isfloat = minmax_sorted(slot)
        v = svals[idx]
        if isfloat:
            c = (csrc[idx] & 3) if packed else csrc[idx].astype(jnp.int32)
            v = jnp.where(c == 1, jnp.array(jnp.nan, v.dtype), v)
        return v

    outs = []
    for op, slot, kind in plan:
        if op == "count_all":
            outs.append((counts_all,
                         jnp.ones((num_groups,), jnp.bool_)))
            continue
        if op == "count":
            outs.append((valid_counts(slot),
                         jnp.ones((num_groups,), jnp.bool_)))
            continue
        nonnull = valid_counts(slot)
        gvalid = nonnull > 0
        vs, ms = sorted_col(slot)
        if op in ("sum", "mean"):
            contrib = vs if ms is None \
                else jnp.where(ms, vs, jnp.zeros((), vs.dtype))
            if kind == "float":
                # floats also use cumsum + boundary differences: the
                # engine's float-sum order is the prefix-sum difference,
                # deterministic where atomic segment sums are not.
                # Non-finite inputs take the float_group_sums fixup so a
                # NaN/inf in one group cannot poison later groups.
                s_wide = float_group_sums(contrib.astype(jnp.float64),
                                          diff_sums)
            else:
                s_wide = diff_sums(contrib.astype(jnp.int64))
            if op == "mean":
                # divide the WIDE sum: narrowing first wraps int8/16/32
                # group sums (mean of [100,100] int8 came out -28)
                m = s_wide.astype(jnp.float64) \
                    / jnp.maximum(nonnull, 1).astype(jnp.float64)
                outs.append((m, gvalid))
            else:
                outs.append((s_wide.astype(vs.dtype), gvalid))
            continue
        if op == "min":
            outs.append((mm_pick(slot, starts), gvalid))
        else:
            pos = starts + jnp.maximum(nonnull, 1) - 1
            outs.append((mm_pick(slot, pos), gvalid))
    return tuple(outs), first_idx


def _identity(dtype, is_min: bool):
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf if is_min else -jnp.inf, dtype)
    info = jnp.iinfo(dtype)
    return jnp.array(info.max if is_min else info.min, dtype)


def segment_aggregate(values: jnp.ndarray, valid: jnp.ndarray,
                      gid: jnp.ndarray, num_groups: int, op: str):
    """Static-shape building block for the distributed aggregate: segment
    reduction with a compile-time group capacity (no host sync) — used by
    parallel.dist_agg under jit/shard_map."""
    if op in ("count", "count_all"):
        w = valid.astype(jnp.int64) if op == "count" \
            else jnp.ones_like(gid, dtype=jnp.int64)
        return jax.ops.segment_sum(w, gid, num_segments=num_groups)
    if op == "sum":
        contrib = jnp.where(valid, values, jnp.zeros((), values.dtype))
        return jax.ops.segment_sum(contrib, gid, num_segments=num_groups)
    if op == "min":
        contrib = jnp.where(valid, values, _identity(values.dtype, True))
        return jax.ops.segment_min(contrib, gid, num_segments=num_groups)
    if op == "max":
        contrib = jnp.where(valid, values, _identity(values.dtype, False))
        return jax.ops.segment_max(contrib, gid, num_segments=num_groups)
    raise ArrowInvalid(f"unknown segment aggregate {op}")
