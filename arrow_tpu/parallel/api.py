"""Table-level distributed operators (eager wrappers over parallel.dist).

The dist bodies (`parallel/dist.py`) are shard_map programs over raw u64
key arrays + numeric payload arrays, static-shape and capacity-padded.
These wrappers give them the engine's Table surface:

  * multi-key / string / dictionary key columns encode into ONE u64 via
    the order-preserving value keys of `ops/row_format.py`
    (reference role: arrow-row lib.rs:413 — a comparable fixed-width key
    per row), bit-packed most-significant-field-first so lexicographic
    order and group identity survive the packing;
  * payload columns ride the shuffle as raw value tensors (+ validity
    planes); string payloads ride as dictionary codes;
  * outputs are trimmed of capacity padding and decoded back into
    columns eagerly.

Packing needs the per-field key ranges, which an eager wrapper can fetch
(one tiny device round-trip); fields whose combined width exceeds 63
bits raise ArrowNotImplementedError rather than silently colliding.

SURVEY.md §2.4 north star: hash-partitioned *tables* across hosts; this
module is that surface on a jax.sharding.Mesh.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import make_mesh, shard_axis
from . import dist
from .partition import hash_u64
from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..ops.groupby import AggSpec, _agg_dtype
from ..ops.row_format import encode_value_key, _decode_key
from ..ops.sort import SortOptions

__all__ = ["dist_table_group_by", "dist_table_sort", "dist_table_join",
           "pack_key_columns"]


# ---------------------------------------------------------------------------
# key packing

class _KeyPlan:
    """Per-field (bits, vmin, nullable, src_column, opts) for one packed
    u64."""

    def __init__(self, fields):
        self.fields = fields     # list of (bits, vmin, nullable, src, opt)
        self.total_bits = sum(b + (1 if nu else 0)
                              for b, _, nu, _, _ in fields)


def _as_dict_src(col: Column) -> Column:
    """The column whose type `_decode_key` can invert (strings decode
    through their on-the-fly dictionary)."""
    if isinstance(col, StringColumn):
        from ..ops.strings import dictionary_encode
        return dictionary_encode(col)
    return col


def pack_key_columns(cols: Sequence[Column],
                     opts: Optional[Sequence[SortOptions]] = None
                     ) -> Tuple[jnp.ndarray, _KeyPlan]:
    """Encode key columns into ONE order-preserving u64 per row.

    Each column contributes an (optional null bit, rebased value-key)
    field, most-significant column first; with `opts`, descending fields
    invert within their width and nulls_first controls the null bit's
    polarity — so u64 `<` IS the requested lexicographic order, and
    equality IS row equality.  Null keys are real values here (they form
    their own group / sort position), unlike the dist bodies' `valid`
    mask, which marks padding only.
    """
    if opts is None:
        opts = [SortOptions()] * len(cols)
    fields = []
    vkeys = []
    for col, opt in zip(cols, opts):
        src = _as_dict_src(col)
        vkey, validity = encode_value_key(src)
        if validity is not None and bool(jnp.all(validity)):
            validity = None
        if validity is None:
            vmin = int(jnp.min(vkey)) if vkey.shape[0] else 0
            vmax = int(jnp.max(vkey)) if vkey.shape[0] else 0
        else:
            anyv = bool(jnp.any(validity)) if vkey.shape[0] else False
            if anyv:
                big = jnp.uint64(0xFFFFFFFFFFFFFFFF)
                vmin = int(jnp.min(jnp.where(validity, vkey, big)))
                vmax = int(jnp.max(jnp.where(validity, vkey,
                                             jnp.uint64(0))))
            else:
                vmin = vmax = 0
        bits = max(int(vmax - vmin).bit_length(), 1)
        fields.append((bits, vmin, validity is not None, src, opt))
        vkeys.append((vkey, validity))
    total = sum(b + (1 if nu else 0) for b, _, nu, _, _ in fields)
    if total > 63:
        raise ArrowNotImplementedError(
            f"distributed key too wide: {total} bits packed (>63); "
            "reduce key columns or cardinality")

    packed = jnp.zeros((cols[0].values.shape[0]
                        if isinstance(cols[0], PrimitiveColumn)
                        else len(cols[0]),), jnp.uint64)
    for (bits, vmin, nullable, _, opt), (vkey, validity) in zip(fields,
                                                                vkeys):
        digit = (vkey - jnp.uint64(vmin)) & jnp.uint64((1 << bits) - 1)
        if opt.descending:
            digit = jnp.uint64((1 << bits) - 1) - digit
        if nullable:
            null_bit = (validity if opt.nulls_first else ~validity) \
                .astype(jnp.uint64)
            digit = jnp.where(validity, digit, jnp.uint64(0))
            packed = (packed << jnp.uint64(bits + 1)) \
                | (null_bit << jnp.uint64(bits)) | digit
        else:
            packed = (packed << jnp.uint64(bits)) | digit
    plan = _KeyPlan([(b, v, nu, s, o) for b, v, nu, s, o in fields])
    return packed, plan


def _unpack_keys(packed: jnp.ndarray, plan: _KeyPlan,
                 names: Sequence[str], schema_fields) -> List[Column]:
    """Invert pack_key_columns over (trimmed) group keys."""
    out = []
    shift = 0
    pieces = []
    for bits, vmin, nullable, src, opt in reversed(plan.fields):
        w = bits + (1 if nullable else 0)
        pieces.append((packed >> jnp.uint64(shift))
                      & jnp.uint64((1 << w) - 1))
        shift += w
    pieces = list(reversed(pieces))
    for (bits, vmin, nullable, src, opt), field in zip(plan.fields,
                                                       pieces):
        digit = field & jnp.uint64((1 << bits) - 1)
        if opt.descending:
            digit = jnp.uint64((1 << bits) - 1) - digit
        vkey = digit + jnp.uint64(vmin)
        if nullable:
            null_bit = (field >> jnp.uint64(bits)) & jnp.uint64(1)
            validity = (null_bit == 1) if opt.nulls_first \
                else (null_bit == 0)
        else:
            validity = jnp.ones(field.shape, jnp.bool_)
        out.append(_decode_key(vkey, validity, src))
    return out


# ---------------------------------------------------------------------------
# payload packing

def _payload_arrays(col: Column):
    """(arrays, rebuild) — raw tensors that ride the shuffle, and a
    closure turning the shuffled tensors back into a Column."""
    if isinstance(col, StringColumn):
        from ..ops.strings import dictionary_encode
        col = dictionary_encode(col)
        inner_string = True
    else:
        inner_string = False
    if isinstance(col, DictionaryColumn):
        values = col.values
        arrs = [col.codes]
        has_mask = col.validity is not None
        if has_mask:
            arrs.append(col.validity)

        def rebuild(arrs_out):
            codes = arrs_out[0]
            mask = arrs_out[1] if has_mask else None
            d = DictionaryColumn(codes, values, mask)
            if inner_string:
                from ..ops.cast import cast
                return cast(d, values.dtype)
            return d
        return arrs, rebuild
    if isinstance(col, PrimitiveColumn):
        arrs = [col.values]
        has_mask = col.validity is not None
        dtype = col.dtype
        if has_mask:
            arrs.append(col.validity)

        def rebuild(arrs_out):
            mask = arrs_out[1] if has_mask else None
            return PrimitiveColumn(arrs_out[0], dtype, mask)
        return arrs, rebuild
    raise ArrowNotImplementedError(
        f"distributed payload of {type(col).__name__}")


def _pad(arr: jnp.ndarray, n: int) -> jnp.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = jnp.zeros((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return jnp.concatenate([arr, pad])


def _mesh_or_default(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else make_mesh()


@functools.partial(jax.jit, static_argnums=(2,))
def _hash_route_counts(packed, valid, n_shards: int):
    """(n_shards, n_shards) rows each shard sends each shard under the
    hash shuffle (rows are split into n_shards equal blocks)."""
    per = packed.shape[0] // n_shards
    dest = (hash_u64(packed) % jnp.uint64(n_shards)).astype(jnp.int32)
    src = jnp.arange(packed.shape[0], dtype=jnp.int32) // per
    cell = jnp.where(valid, src * n_shards + dest, n_shards * n_shards)
    counts = jnp.bincount(cell, length=n_shards * n_shards + 1)
    return counts[:-1].reshape(n_shards, n_shards)


def _trim(mask: np.ndarray, *arrays: np.ndarray):
    keep = np.nonzero(mask)[0]
    return tuple(a[keep] for a in arrays)


# ---------------------------------------------------------------------------
# operators

def dist_table_group_by(table: Table, keys: Sequence[str],
                        aggs: Sequence[AggSpec],
                        mesh: Optional[Mesh] = None,
                        group_cap: Optional[int] = None) -> Table:
    """Distributed GROUP BY over a mesh: hash-shuffle rows by the packed
    key, aggregate per shard (`dist.dist_group_by`), trim the padding,
    decode keys, and return one engine Table (rows in packed-key order).

    Aggregate source columns must be non-nullable primitives (the dist
    bodies carry raw value tensors); key columns may be any packable
    combination of int/string/dictionary, nulls included (a null key is
    its own group, Arrow semantics).
    """
    mesh = _mesh_or_default(mesh)
    axis = shard_axis(mesh)
    n_shards = mesh.devices.size
    key_cols = [table.column(k) for k in keys]
    packed, plan = pack_key_columns(key_cols)

    specs = []
    for a in aggs:
        if a.op not in ("sum", "count", "min", "max"):
            raise ArrowNotImplementedError(
                f"distributed aggregate {a.op}")
        c = table.column(a.column)
        if not isinstance(c, PrimitiveColumn) or c.validity is not None:
            raise ArrowNotImplementedError(
                "distributed aggregate sources must be non-nullable "
                f"primitives; {a.column} is "
                f"{type(c).__name__}{' (nullable)' if getattr(c, 'validity', None) is not None else ''}")
        specs.append((a.op, c.values))

    n = table.num_rows
    per = max(math.ceil(n / n_shards), 1)
    n_pad = per * n_shards
    valid = _pad(jnp.ones((n,), jnp.bool_), n_pad)
    packed_p = _pad(packed, n_pad)
    vals_p = [_pad(v, n_pad) for _, v in specs]
    # exact capacities: the most rows one shard sends another, and (as
    # the lossless group bound) the most rows one shard receives
    routed = np.asarray(_hash_route_counts(packed_p, valid, n_shards))
    shuffle_cap = max(int(routed.max()), 1)
    if group_cap is None:
        group_cap = max(int(routed.sum(axis=0).max()), 1)

    in_specs = (P(axis),) * (2 + len(vals_p))

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=in_specs,
                   out_specs=(P(axis), P(axis),
                              tuple(P(axis) for _ in specs), P()))
    def step(k, ok, *vs):
        sp = [(op, v) for (op, _), v in zip(specs, vs)]
        gk, gv, outs, over = dist.dist_group_by(axis, k, ok,
                                                shuffle_cap, group_cap,
                                                sp)
        return gk, gv, tuple(outs), over

    gk, gv, outs, over = step(packed_p, valid, *vals_p)
    if bool(np.asarray(over)):
        raise ArrowInvalid("distributed group_by capacity overflow")
    gk_h = np.asarray(gk)
    gv_h = np.asarray(gv)
    outs_h = [np.asarray(o) for o in outs]
    trimmed = _trim(gv_h, gk_h, *outs_h)
    gk_t, outs_t = trimmed[0], trimmed[1:]
    order = np.argsort(gk_t, kind="stable")
    gk_t = gk_t[order]

    key_out = _unpack_keys(jnp.asarray(gk_t.astype(np.uint64)), plan,
                           keys, table.schema)
    cols = list(key_out)
    fields = [dt.Field(k, c.dtype,
                       nullable=table.schema.field(k).nullable)
              for k, c in zip(keys, key_out)]
    for a, o in zip(aggs, outs_t):
        src_dt = table.column(a.column).dtype
        out_dt = _agg_dtype(src_dt, a.op)
        cols.append(PrimitiveColumn(
            jnp.asarray(o[order]).astype(out_dt.to_jax()), out_dt))
        fields.append(dt.Field(a.out_name, out_dt, nullable=False))
    return Table(tuple(cols), dt.Schema(tuple(fields)))


def dist_table_sort(table: Table, keys: Sequence[str],
                    options: Optional[Sequence[SortOptions]] = None,
                    mesh: Optional[Mesh] = None) -> Table:
    """Distributed multi-key sort: pack the sort key (descending /
    nulls_first folded into the packing), range-partition + locally sort
    over the mesh (`dist.dist_sort`), then reassemble the globally
    sorted Table (shard i's rows all precede shard i+1's)."""
    mesh = _mesh_or_default(mesh)
    axis = shard_axis(mesh)
    n_shards = mesh.devices.size
    key_cols = [table.column(k) for k in keys]
    if options is None:
        options = [SortOptions()] * len(keys)
    packed, _plan = pack_key_columns(key_cols, options)

    pay_arrays = []
    rebuilds = []
    counts = []
    for c in table.columns:
        arrs, rb = _payload_arrays(c)
        pay_arrays.extend(arrs)
        rebuilds.append(rb)
        counts.append(len(arrs))

    n = table.num_rows
    per = max(math.ceil(n / n_shards), 1)
    n_pad = per * n_shards
    valid = _pad(jnp.ones((n,), jnp.bool_), n_pad)
    packed_p = _pad(packed, n_pad)
    pays_p = [_pad(a, n_pad) for a in pay_arrays]
    capacity = per                   # lossless (skew-safe) capacity

    @jax.jit
    @jax.shard_map(mesh=mesh,
                   in_specs=(P(axis),) * (2 + len(pays_p)),
                   out_specs=(P(axis), P(axis),
                              tuple(P(axis) for _ in pays_p), P()))
    def step(k, ok, *pays):
        sk, svalid, spays, over = dist.dist_sort(axis, k, ok, capacity,
                                                 pays)
        return sk, svalid, spays, over

    sk, svalid, spays, over = step(packed_p, valid, *pays_p)
    if bool(np.asarray(over)):
        raise ArrowInvalid("distributed sort capacity overflow")
    mask = np.asarray(svalid)
    spays_h = [np.asarray(p) for p in spays]
    trimmed = _trim(mask, *spays_h)

    cols = []
    i = 0
    for rb, cnt in zip(rebuilds, counts):
        cols.append(rb([jnp.asarray(t) for t in trimmed[i:i + cnt]]))
        i += cnt
    return Table(tuple(cols), table.schema)


def dist_table_join(left: Table, right: Table, keys: Sequence[str],
                    mesh: Optional[Mesh] = None) -> Table:
    """Distributed many-to-many inner join on `keys` (both sides): pack
    keys, co-shuffle both sides by key hash, expand match pairs per
    shard (`dist.dist_join`), trim, and reassemble left-columns +
    right-columns (right key columns dropped, reference join surface).

    Null keys never match (SQL inner-join semantics): rows whose packed
    key has a null field are masked out before the shuffle.
    """
    mesh = _mesh_or_default(mesh)
    axis = shard_axis(mesh)
    n_shards = mesh.devices.size

    lk_cols = [left.column(k) for k in keys]
    rk_cols = [right.column(k) for k in keys]
    # one shared packing domain: pack the CONCAT, split back (group/rank
    # encodings must agree across the two tables)
    from ..ops.concat import concat
    both = [concat([lc, rc]) for lc, rc in zip(lk_cols, rk_cols)]
    packed_all, plan = pack_key_columns(both)
    nl, nr = left.num_rows, right.num_rows
    lpacked, rpacked = packed_all[:nl], packed_all[nl:]

    def null_free(cols, m):
        ok = jnp.ones((m,), jnp.bool_)
        for c in cols:
            if getattr(c, "validity", None) is not None:
                ok = ok & c.validity
        return ok

    l_ok = null_free(lk_cols, nl)
    r_ok = null_free(rk_cols, nr)

    l_pays, l_rb, l_cnt = [], [], []
    for name, c in zip(left.schema.names, left.columns):
        arrs, rb = _payload_arrays(c)
        l_pays.extend(arrs)
        l_rb.append(rb)
        l_cnt.append(len(arrs))
    r_pays, r_rb, r_cnt, r_names = [], [], [], []
    for name, c in zip(right.schema.names, right.columns):
        if name in keys:
            continue
        arrs, rb = _payload_arrays(c)
        r_pays.extend(arrs)
        r_rb.append(rb)
        r_cnt.append(len(arrs))
        r_names.append(name)

    per_l = max(math.ceil(nl / n_shards), 1)
    per_r = max(math.ceil(nr / n_shards), 1)
    nl_pad, nr_pad = per_l * n_shards, per_r * n_shards
    lp = _pad(lpacked, nl_pad)
    rp = _pad(rpacked, nr_pad)
    l_okp = _pad(l_ok, nl_pad)
    r_okp = _pad(r_ok, nr_pad)
    l_paysp = [_pad(a, nl_pad) for a in l_pays]
    r_paysp = [_pad(a, nr_pad) for a in r_pays]
    out_cap = 2 * (nl_pad + nr_pad)  # per-shard expansion capacity

    @jax.jit
    @jax.shard_map(mesh=mesh,
                   in_specs=(P(axis), P(axis)) + (P(axis),) * len(l_paysp)
                   + (P(axis), P(axis)) + (P(axis),) * len(r_paysp),
                   out_specs=(P(axis), P(axis),
                              tuple(P(axis) for _ in l_paysp),
                              tuple(P(axis) for _ in r_paysp), P()))
    def step(lk, lok, *rest):
        lv = rest[:len(l_paysp)]
        rk, rok = rest[len(l_paysp)], rest[len(l_paysp) + 1]
        rv = rest[len(l_paysp) + 2:]
        out_valid, out_key, out_l, out_r, over = dist.dist_join(
            axis, lk, lok, lv, rk, rok, rv,
            nl_pad, nr_pad, out_cap)
        return out_valid, out_key, tuple(out_l), tuple(out_r), over

    ov, okey, outs_l, outs_r, over = step(lp, l_okp, *l_paysp, rp,
                                          r_okp, *r_paysp)
    if bool(np.asarray(over)):
        raise ArrowInvalid("distributed join capacity overflow")
    mask = np.asarray(ov)
    parts = [np.asarray(a) for a in tuple(outs_l) + tuple(outs_r)]
    trimmed = _trim(mask, *parts)

    cols, fields = [], []
    i = 0
    for rb, cnt, name, f in zip(l_rb, l_cnt, left.schema.names,
                                left.schema.fields):
        cols.append(rb([jnp.asarray(t) for t in trimmed[i:i + cnt]]))
        fields.append(f)
        i += cnt
    for rb, cnt, name in zip(r_rb, r_cnt, r_names):
        c = rb([jnp.asarray(t) for t in trimmed[i:i + cnt]])
        cols.append(c)
        fields.append(dt.Field(name, c.dtype))
        i += cnt
    return Table(tuple(cols), dt.Schema(tuple(fields)))
