"""Sort kernels: sort_to_indices / sort / lexsort / rank / partition.

Re-design of arrow-ord/src/sort.rs.  The reference's comparison sort over
(index, value) pairs (sort.rs:478) becomes: order-preserving uint64 key
transform (ops.row_format, the arrow-row encoding idea) + stable radix-style
argsort on device — the path the reference itself recommends for
multi-column sorts (arrow-row/src/lib.rs:103-121).

Parity notes:
  - Output indices are uint32 like the reference.
  - Stability: the reference uses sort_unstable for single columns; this
    engine is always stable (deterministic), which agrees with the
    reference wherever outputs are observably defined, and with pyarrow's
    stable sort_indices goldens.
  - Floats sort by IEEE totalOrder (reference total_cmp): -NaN < -inf,
    NaN > +inf.
  - `limit` (sort.rs partial_sort:853) takes the prefix of the stable
    order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core.column import Column, PrimitiveColumn
from ..core.table import Table
from ..errors import ArrowInvalid
from .row_format import (SortOptions, encode_keys, encode_value_key,
                         lexsort_indices_from_keys,
                         lexsort_indices_fused)
from .take import take as take_kernel, take_table

__all__ = ["SortOptions", "SortColumn", "sort_to_indices", "sort",
           "lexsort_to_indices", "lexsort", "sort_table", "rank",
           "partition", "Partitions"]


@dataclass
class SortColumn:
    """arrow-ord SortColumn (sort.rs:709)."""
    column: Column
    options: SortOptions = SortOptions()


def sort_to_indices(col: Column, options: SortOptions = SortOptions(),
                    limit: Optional[int] = None) -> PrimitiveColumn:
    """Indices that sort `col` (sort.rs:219) — key encode + stable sort
    fused into one XLA program (row_format.lexsort_indices_fused)."""
    idx = lexsort_indices_fused([col], [options], limit)
    return PrimitiveColumn(idx, dt.uint32)


def _decodable(col: Column) -> bool:
    """Whether a column's sorted key bits decode straight back to the
    column (sort output needs no gather; see _sort_decode_stage)."""
    from ..core.column import DictionaryColumn
    if isinstance(col, DictionaryColumn):
        return True
    return isinstance(col, PrimitiveColumn) and (
        col.dtype.is_numeric or col.dtype.is_boolean
        or col.dtype.is_temporal) and col.dtype.name != "interval"


def _decode_sort(cols, opts, limit, need_idx, payloads=()):
    """Shared driver for the key-decode sort: returns
    ([(values, validity)] per column, idx-or-None, sorted payloads)."""
    from .row_format import key_kind, key_parts, group_has_null_key
    from ..core.column import DictionaryColumn
    kinds, kopts, parts, invs, metas = [], [], [], [], []
    for col, opt in zip(cols, opts):
        kinds.append(key_kind(col))
        kopts.append((opt.descending, opt.nulls_first))
        p = key_parts(col, opt)
        parts.append(p)
        if kinds[-1] == "dict":
            ranks, entry_valid = p[1], p[2]
            if ranks is None:
                # value-sorted dictionary (key_parts fast path):
                # rank == slot, the inverse is the identity
                nslots = len(col.values)
                invs.append(jnp.arange(max(nslots, 1), dtype=jnp.int32))
                metas.append(np.dtype(col.codes.dtype).name)
                continue
            # rank -> FIRST valid slot holding it (row_format._decode_key
            # does the same): argsort(ranks) is wrong when dictionary
            # values repeat — dense ranks are non-unique, and the
            # misaligned inverse decoded the wrong slot's value
            r_np = np.asarray(ranks).astype(np.int64)
            nslots = len(r_np)
            inv_np = np.zeros(max(nslots, 1), np.int32)
            valid_idx = np.arange(nslots) if entry_valid is None \
                else np.nonzero(np.asarray(entry_valid))[0]
            inv_np[r_np[valid_idx][::-1]] = \
                valid_idx[::-1].astype(np.int32)
            invs.append(jnp.asarray(inv_np))
            metas.append(np.dtype(col.codes.dtype).name)
        else:
            invs.append(None)
            # part values, not col.values: host-ranked nested keys
            # (row_format._host_rank_parts) carry u32 ranks — their
            # decoded group is discarded, the column rides the gather
            metas.append(np.dtype(p[0].dtype).name)
    has_nulls = tuple(group_has_null_key(k, p)
                      for k, p in zip(kinds, parts))
    return _sort_decode_stage(
        tuple(kinds), tuple(kopts), has_nulls, tuple(metas), need_idx,
        limit, tuple(parts), tuple(invs), tuple(payloads))


def _rebuild_sorted(col: Column, vals, validity) -> Column:
    from ..core.column import DictionaryColumn
    if isinstance(col, DictionaryColumn):
        return DictionaryColumn(vals, col.values, validity,
                                _canonical=True)
    return PrimitiveColumn(vals, col.dtype, validity, _canonical=True)


def sort(col: Column, options: SortOptions = SortOptions(),
         limit: Optional[int] = None) -> Column:
    """sort kernel (sort.rs:57): decode from the sorted key bits when
    the column supports it (no gather), else take by sorted indices."""
    if _decodable(col):
        groups, _, _ = _decode_sort([col], [options], limit, False)
        return _rebuild_sorted(col, *groups[0])
    return take_kernel(col, sort_to_indices(col, options, limit))


def lexsort_to_indices(columns: Sequence[SortColumn],
                       limit: Optional[int] = None) -> PrimitiveColumn:
    """Multi-column sort indices (sort.rs:779): first column is the
    primary key."""
    if not columns:
        raise ArrowInvalid("lexsort of zero columns")
    lens = {len(c.column) for c in columns}
    if len(lens) != 1:
        raise ArrowInvalid("lexsort column length mismatch")
    idx = lexsort_indices_fused([c.column for c in columns],
                                [c.options for c in columns], limit)
    return PrimitiveColumn(idx, dt.uint32)


def lexsort(columns: Sequence[SortColumn],
            limit: Optional[int] = None) -> List[Column]:
    if all(_decodable(c.column) for c in columns):
        groups, _, _ = _decode_sort([c.column for c in columns],
                                    [c.options for c in columns],
                                    limit, False)
        return [_rebuild_sorted(c.column, *g)
                for c, g in zip(columns, groups)]
    idx = lexsort_to_indices(columns, limit)
    return [take_kernel(c.column, idx) for c in columns]


def sort_table(table: Table, by: Sequence[Tuple[str, SortOptions]],
               limit: Optional[int] = None) -> Table:
    """Sort a batch.

    Key columns are DECODED from the sorted key bits themselves — the
    order keys in row_format are invertible, so a key column's output
    costs zero gathers.  Only non-key (or non-decodable) columns ride a
    fused take_table gather.  This matters at scale: a row-sized random
    gather per column is replaced by an elementwise pass fused into the
    sort program, so the all-keys sort_table (BASELINE config 3) costs
    the sort alone.  NOTE: carrying payloads as extra lax.sort operands was
    measured 4.7x SLOWER at 10M x 3 columns (3610 vs 775 ms) — the
    sort moves payload bytes through every merge pass."""
    by = list(by)
    decode_pos = {}              # table column name -> by position
    for pos, (name, opt) in enumerate(by):
        if name not in decode_pos and _decodable(table.column(name)):
            decode_pos[name] = pos
    if not decode_pos:
        cols = [SortColumn(table.column(name), opt) for name, opt in by]
        return take_table(table, lexsort_to_indices(cols, limit))

    other_names = [n for n in table.schema.names if n not in decode_pos]
    n_rows = table.num_rows
    # at scale, primitive non-key columns ride the sort as payload
    # operands instead of a post-sort random gather (see
    # _sort_decode_stage); small batches keep the gather (4.7x cheaper
    # at 10M, measured)
    payload_names = []
    if n_rows >= _PAYLOAD_CROSSOVER:
        payload_names = [nm for nm in other_names
                         if isinstance(table.column(nm),
                                       PrimitiveColumn)]
    gather_names = [nm for nm in other_names if nm not in payload_names]
    payload_tensors = []
    payload_map = {}
    for nm in payload_names:
        c = table.column(nm)
        vi = len(payload_tensors)
        payload_tensors.append(c.values)
        mi = None
        if c.validity is not None:
            mi = len(payload_tensors)
            payload_tensors.append(c.validity)
        payload_map[nm] = (vi, mi)
    need_idx = bool(gather_names)
    sorted_groups, idx, sorted_payloads = _decode_sort(
        [table.column(name) for name, _ in by],
        [opt for _, opt in by], limit, need_idx, payload_tensors)

    out_cols, fields = [], []
    gathered = None
    if need_idx:
        sub = table.select(gather_names)
        gathered = dict(zip(gather_names, take_table(
            sub, PrimitiveColumn(idx, dt.uint32)).columns))
    for name in table.schema.names:
        fields.append(table.schema.field(name))
        if name in decode_pos:
            out_cols.append(_rebuild_sorted(
                table.column(name), *sorted_groups[decode_pos[name]]))
        elif name in payload_map:
            c = table.column(name)
            vi, mi = payload_map[name]
            out_cols.append(PrimitiveColumn(
                sorted_payloads[vi], c.dtype,
                None if mi is None else sorted_payloads[mi],
                _canonical=True))
        else:
            out_cols.append(gathered[name])
    return Table(tuple(out_cols), dt.Schema(tuple(fields)))


_PAYLOAD_CROSSOVER = 50_000_000


@functools.partial(jax.jit, static_argnames=(
    "kinds", "opts", "has_nulls", "metas", "need_idx", "limit"))
def _sort_decode_stage(kinds, opts, has_nulls, metas, need_idx, limit,
                       parts, invs, payloads=()):
    """One XLA program: encode keys, ONE multi-key sort, decode every
    key group back to values/codes/validity, optional row indices for
    the non-key gather.  `payloads` ride the same sort as extra
    operands instead of a post-sort random gather."""
    from .row_format import (encode_key_groups_traced,
                             decode_sorted_group)
    groups = encode_key_groups_traced(kinds, opts, parts)
    flat = [k for g in groups for k in g]
    n = flat[0].shape[0]
    if limit is not None and len(flat) == 1 and 0 < limit < n:
        # true partial sort (sort.rs partial_sort:853): ONE u64 key ->
        # lax.top_k of the complemented key gives the smallest `limit`
        # keys; top_k tie-break is ascending index = stable order
        topv, topi = jax.lax.top_k(~flat[0], limit)
        skey = ~topv
        idx = topi.astype(jnp.uint32) if need_idx else None
        sorted_payloads = tuple(p[topi] for p in payloads)
        vals, validity = decode_sorted_group(
            kinds[0], opts[0], has_nulls[0], [skey],
            out_dtype=np.dtype(metas[0]), inv_slots=invs[0])
        return [(vals, validity)], idx, sorted_payloads
    ops_ = tuple(flat)
    if need_idx:
        ops_ = ops_ + (jnp.arange(n, dtype=jnp.uint32),)
    ops_ = ops_ + tuple(payloads)
    s = jax.lax.sort(ops_, num_keys=len(flat), is_stable=True)
    sorted_payloads = s[len(ops_) - len(payloads):] if payloads else ()
    if limit is not None and payloads:
        sorted_payloads = tuple(p[:limit] for p in sorted_payloads)
    idx = s[len(flat)] if need_idx else None
    outs = []
    i = 0
    for kind, opt, hn, meta, g, inv in zip(kinds, opts, has_nulls,
                                           metas, groups, invs):
        sg = s[i:i + len(g)]
        i += len(g)
        vals, validity = decode_sorted_group(
            kind, opt, hn, list(sg), out_dtype=np.dtype(meta),
            inv_slots=inv)
        if limit is not None:
            vals = vals[:limit]
            validity = None if validity is None else validity[:limit]
        outs.append((vals, validity))
    if need_idx and limit is not None:
        idx = idx[:limit]
    return outs, idx, sorted_payloads


def rank(col: Column, options: SortOptions = SortOptions()
         ) -> jnp.ndarray:
    """'max'-method 1-based rank, nulls ranked by their sort position
    (arrow-ord/src/rank.rs:54: equal values get the highest of their
    ranks).  Returns a uint32 tensor.  One jitted scatter-free stage."""
    from .row_format import key_kind, key_parts
    if len(col) == 0:
        return jnp.zeros((0,), jnp.uint32)
    return _rank_stage((key_kind(col),),
                       ((options.descending, options.nulls_first),),
                       (key_parts(col, options),))


@functools.partial(jax.jit, static_argnames=("kinds", "opts"))
def _rank_stage(kinds, opts, parts):
    from .row_format import encode_keys_traced
    keys = encode_keys_traced(kinds, opts, parts)
    n = keys[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = jax.lax.sort(tuple(keys) + (iota,), num_keys=len(keys),
                              is_stable=True)
    idx = sorted_ops[-1]
    eq_prev = jnp.ones((n - 1,), jnp.bool_)
    for k in sorted_ops[:-1]:
        eq_prev = jnp.logical_and(eq_prev, k[1:] == k[:-1])
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), ~eq_prev])
    run_id = (jnp.cumsum(run_start.astype(jnp.int32)) - 1)
    # run-start positions via partition-sort; next start = run's max rank
    _, starts_raw = jax.lax.sort((~run_start, iota), num_keys=1,
                                 is_stable=True)
    num_runs = jnp.sum(run_start, dtype=jnp.int32)
    slots = jnp.arange(n, dtype=jnp.int32)
    starts_ext = jnp.where(slots < num_runs, starts_raw, jnp.int32(n))
    rank_sorted = starts_ext[jnp.minimum(run_id + 1, n - 1)]
    rank_sorted = jnp.where(run_id + 1 >= num_runs, jnp.int32(n),
                            rank_sorted)
    # inverse permutation: sort ranks by original index.  The payload
    # stays i32 like the key: XLA's GPU pipeline turns a sort by a
    # permutation into a scatter and fails to verify it when the two
    # dtypes differ.
    _, rank_orig = jax.lax.sort((idx, rank_sorted), num_keys=1,
                                is_stable=True)
    return rank_orig.astype(jnp.uint32)


@dataclass
class Partitions:
    """Consecutive equal-row ranges (arrow-ord/src/partition.rs:127),
    the reference's group-by building block."""
    boundaries: np.ndarray  # sorted boundary positions incl. 0 and n

    def ranges(self) -> List[Tuple[int, int]]:
        b = self.boundaries
        return [(int(b[i]), int(b[i + 1])) for i in range(len(b) - 1)]

    def __len__(self):
        return len(self.boundaries) - 1


def partition_mask(columns: Sequence[Column]) -> jnp.ndarray:
    """Device-side run-start mask: out[i] is True iff row i differs from
    row i-1 (out[0] = True).  The fuse-friendly core of `partition` —
    stays on device, no host sync, usable inside jitted pipelines
    (group-by run detection, streaming dedup).  partition.rs:156 computes
    the same shifted-neq; nulls compare equal (`distinct` semantics)."""
    if not columns:
        raise ArrowInvalid("partition of zero columns")
    n = len(columns[0])
    if n == 0:
        return jnp.zeros((0,), jnp.bool_)
    change = _partition_change(columns)
    return jnp.concatenate([jnp.ones((1,), jnp.bool_), change])


def partition(columns: Sequence[Column]) -> Partitions:
    """Boundaries between consecutive distinct rows (partition.rs:156:
    computed via neq of shifted columns; nulls compare equal —
    `distinct` semantics)."""
    if not columns:
        raise ArrowInvalid("partition of zero columns")
    n = len(columns[0])
    if n == 0:
        return Partitions(np.array([0]))
    change = _partition_change(columns)
    (pos,) = np.nonzero(np.asarray(change))
    boundaries = np.concatenate([[0], pos + 1, [n]])
    return Partitions(boundaries)


def _partition_change(columns: Sequence[Column]) -> jnp.ndarray:
    """Shifted-neq change mask of length n-1 (True where row i+1 != row i)."""
    n = len(columns[0])
    change = jnp.zeros((n - 1,), jnp.bool_)
    for col in columns:
        if isinstance(col, PrimitiveColumn) and col.dtype.is_floating:
            # native float equality with a NaN class; NaNs compare
            # equal
            v64 = col.values.astype(jnp.float64)
            isnan = jnp.isnan(v64)
            vclean = jnp.where(isnan, jnp.float64(0.0), v64)
            vneq = (vclean[1:] != vclean[:-1]) | (isnan[1:] != isnan[:-1])
            validity = col.validity
        else:
            vkey, validity = encode_value_key(col)
            vneq = vkey[1:] != vkey[:-1]
        if validity is None:
            neq = vneq
        else:
            v = validity
            both_valid = v[1:] & v[:-1]
            neq = jnp.where(both_valid, vneq, v[1:] != v[:-1])
        change = jnp.logical_or(change, neq)
    return change
