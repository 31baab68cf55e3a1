"""Hash join (inner/left/semi/anti).

Not present in the reference (SURVEY.md §2: arrow-rs delegates joins to
query engines); BASELINE config-5 requires it.  Device-native plan — a
sort-probe join on order-preserving keys, every stage a dense vector
kernel:

  build:  encode build keys -> u64, stable-sort them (one-time cost)
  probe:  encode probe keys -> u64, binary-search each probe key against
          the sorted build keys (vectorized searchsorted: log2(B) rounds of
          dense gathers — the dense-vector analogue of a hash-table
          lookup, with no pointer chasing and no collisions)
  expand: match counts -> exclusive scan -> flat (probe_idx, build_idx)
          pair expansion (output size is data-dependent: one host sync)

Multi-column keys combine per-column u64 keys through a 64-bit mixer; a
post-verification compare removes mixer collisions, preserving exactness.

SQL null semantics: NULL keys match nothing (inner/semi); left-join rows
with NULL keys emit the null-extended row.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, PrimitiveColumn
from ..core.table import Table
from ..errors import ArrowInvalid
from .row_format import encode_value_key
from .take import take as take_kernel

__all__ = ["join", "join_indices", "HashJoiner"]

_MIX = jnp.uint64(0x9E3779B97F4A7C15)  # splitmix64 golden-ratio constant


def _mix64(x: jnp.ndarray) -> jnp.ndarray:
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> jnp.uint64(31))


def _co_encode(lcol: Column, rcol: Column):
    """Order keys for one key-column pair, in a SHARED domain.

    Primitive keys use the global order-preserving transform (consistent
    across tables by construction).  String/dictionary keys have
    batch-local dictionary ranks, so both sides re-rank against the merged
    distinct-value set (the same trick as ops.strings._compare_cols)."""
    from ..core.column import DictionaryColumn, StringColumn
    stringy = isinstance(lcol, (StringColumn, DictionaryColumn)) or \
        isinstance(rcol, (StringColumn, DictionaryColumn))
    if not stringy:
        lk, lv = encode_value_key(lcol)
        rk, rv = encode_value_key(rcol)
        return lk, lv, rk, rv
    from .strings import (_as_dict, _dict_slot_validity,
                          merged_string_ranks)
    from ..core.column import StringColumn
    dl, dr = _as_dict(lcol), _as_dict(rcol)
    lv, rv = dl.values, dr.values
    if not (isinstance(lv, StringColumn) and isinstance(rv, StringColumn)):
        raise ArrowInvalid("string join keys require string dictionaries")
    # merged-domain dense ranks, all native (no per-value Python)
    lrank, rrank = merged_string_ranks(lv, rv)
    lk = jnp.take(jnp.asarray(lrank), dl.codes, mode="clip")
    rk = jnp.take(jnp.asarray(rrank), dr.codes, mode="clip")
    return lk, _dict_slot_validity(dl), rk, _dict_slot_validity(dr)


def combined_keys(lcols: Sequence[Column], rcols: Sequence[Column]):
    """(lkey, lvalid, rkey, rvalid) u64 row keys over both tables' key
    columns, in a shared domain.  Single column: exact (collision-free).
    Multi-column: mixed hash (collisions possible -> callers post-verify)."""
    lkeys, rkeys = [], []
    lvalid: vd.Mask = None
    rvalid: vd.Mask = None
    for lc, rc in zip(lcols, rcols):
        lk, lv, rk, rv = _co_encode(lc, rc)
        lkeys.append(lk)
        rkeys.append(rk)
        lvalid = vd.union(lvalid, lv)
        rvalid = vd.union(rvalid, rv)

    def fold(keys):
        if len(keys) == 1:
            return keys[0]
        key = jnp.zeros_like(keys[0])
        for k in keys:
            key = _mix64(key ^ (k + _MIX + (key << jnp.uint64(6))
                                + (key >> jnp.uint64(2))))
        return key

    lkey, rkey = fold(lkeys), fold(rkeys)
    return (lkey, vd.make_mask(lkey.shape[0], lvalid),
            rkey, vd.make_mask(rkey.shape[0], rvalid),
            lkeys, rkeys)


import functools

_U64_MAX = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def _prim_encode_tag(col: Column):
    """Static encode tag for the fused single-primitive-key plan, or
    None when the column needs the general (materialized) encode."""
    from ..core.column import PrimitiveColumn
    if not isinstance(col, PrimitiveColumn):
        return None
    d = col.dtype
    if d.is_floating or (d.name == "interval" and d.unit == "day_time"):
        return None
    if d.is_boolean or d.is_unsigned_integer:
        return "unsigned"
    if d.is_signed_integer or d.is_temporal:
        return "signed"
    return None


def _enc_raw(vals, tag: str):
    if tag == "unsigned":
        return vals.astype(jnp.uint64)
    from .row_format import jax_bitcast_u64, _SIGN64
    return jax_bitcast_u64(vals.astype(jnp.int64)) ^ _SIGN64


@functools.partial(jax.jit, static_argnames=("ltag", "rtag"))
def _key_range_scan_raw(lvals, lvalid, rvals, rvalid, ltag, rtag):
    """_key_range_scan with the order-key encode FUSED in (no 0.8 GB/
    100M-row key buffer materializes; the encode is elementwise and
    rides the reduction's read)."""
    return _key_range_scan(_enc_raw(lvals, ltag), lvalid,
                           _enc_raw(rvals, rtag), rvalid)


@functools.partial(jax.jit, static_argnames=("R", "rtag"))
def _index_build_raw(rvals, rvalid, kmin, R, rtag):
    return _index_build_stage(_enc_raw(rvals, rtag), rvalid, kmin, R)


@functools.partial(jax.jit, static_argnames=("ltag",))
def _index_probe_raw(lvals, lvalid, table, kmin, ltag):
    return _index_probe_stage(_enc_raw(lvals, ltag), lvalid, table,
                              kmin)


@jax.jit
def _key_range_scan(lkey, lvalid, rkey, rvalid):
    """(combined min, combined max, build min, build max) over VALID
    encoded keys, one fetch — the combined range gates the packed merge
    plan, the BUILD range alone gates the perfect-index plan (probe
    outliers don't need table slots; they just miss)."""
    top = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    lo_r = jnp.min(jnp.where(rvalid, rkey, top))
    hi_r = jnp.max(jnp.where(rvalid, rkey, jnp.uint64(0)))
    lo = jnp.minimum(jnp.min(jnp.where(lvalid, lkey, top)), lo_r)
    hi = jnp.maximum(jnp.max(jnp.where(lvalid, lkey, jnp.uint64(0))),
                     hi_r)
    return jnp.stack([lo, hi, lo_r, hi_r])


@functools.partial(jax.jit, static_argnames=("R",))
def _index_build_stage(rkey, rvalid, kmin, R):
    """Dense key->row lookup table WITHOUT scatter (deterministic, with
    duplicate detection for free): one stable sort of
    [build keys (packed 2k), slot markers (packed 2k+1)] makes each
    slot's PREDECESSOR its key's build row; a second small sort peels
    the R slots back out in key order.  Also reports whether build
    keys repeat (the caller falls back to the merge plan if so)."""
    n_r = rkey.shape[0]
    # invalid build rows get UNIQUE sentinels past every slot (a shared
    # sentinel would false-trigger the duplicate-key detector)
    pb = jnp.where(rvalid, (rkey - kmin) * jnp.uint64(2),
                   jnp.uint64(2 * R)
                   + jnp.arange(n_r, dtype=jnp.uint64))
    packed = jnp.concatenate([
        pb,
        jnp.arange(R, dtype=jnp.uint64) * jnp.uint64(2)
        + jnp.uint64(1)])
    payload = jnp.concatenate([jnp.arange(n_r, dtype=jnp.int32),
                               jnp.full(R, -1, jnp.int32)])
    ps, pay = jax.lax.sort((packed, payload), num_keys=1,
                           is_stable=False)
    dup = jnp.any(ps[1:] == ps[:-1])
    prev_p = jnp.concatenate([ps[-1:] + jnp.uint64(1), ps[:-1]])
    prev_pay = jnp.concatenate([jnp.full(1, -1, jnp.int32), pay[:-1]])
    is_slot = (ps & jnp.uint64(1)) == jnp.uint64(1)
    hit = is_slot & (prev_p + jnp.uint64(1) == ps)
    tv = jnp.where(hit, prev_pay, jnp.int32(-1))
    # slots first (key 0), in key order (stable)
    _, tv_s = jax.lax.sort(((~is_slot).astype(jnp.uint8), tv),
                           num_keys=1, is_stable=True)
    return tv_s[:R], dup


@functools.partial(jax.jit, static_argnames=())
def _index_probe_stage(lkey, lvalid, table, kmin):
    """ri per probe row (-1 = no match) by ONE gather into the dense
    table — the perfect-hash probe; exact by construction (table[s]
    holds only the build row whose key IS s)."""
    R = table.shape[0]
    idx = jnp.where(lvalid, lkey - kmin, jnp.uint64(R))
    inr = lvalid & (idx < jnp.uint64(R))
    ri = jnp.where(inr, table[jnp.minimum(
        idx, jnp.uint64(max(R - 1, 0))).astype(jnp.int64)],
        jnp.int32(-1))
    return ri, jnp.sum((ri >= 0).astype(jnp.int64))


@jax.jit
def _probe_stage_packed(lkey, lvalid, rkey, rvalid, kmin):
    """_probe_stage with (key-kmin, invalid, side) PACKED into one u64
    (requires key range < 2^61, checked by the caller).  Operand bytes
    are the sort-cost lever on this chip: one u64 key + one i32 payload
    replaces the 3-key (u64,u8,u8,i32) sort.  Tie order among equal
    packed keys is irrelevant (any build order within a run works), so
    the sort can be unstable single-key."""
    n_r = rkey.shape[0]
    n_l = lkey.shape[0]
    key_cat = jnp.concatenate([
        jnp.where(rvalid, rkey, kmin) - kmin,
        jnp.where(lvalid, lkey, kmin) - kmin])
    inv = jnp.concatenate([~rvalid, ~lvalid])
    side01 = jnp.concatenate([jnp.zeros(n_r, jnp.uint64),
                              jnp.ones(n_l, jnp.uint64)])
    packed = (key_cat << jnp.uint64(2)) \
        | (inv.astype(jnp.uint64) << jnp.uint64(1)) | side01
    iota = jnp.concatenate([jnp.arange(n_r, dtype=jnp.int32),
                            jnp.arange(n_l, dtype=jnp.int32)])
    pks, idxs = jax.lax.sort((packed, iota), num_keys=1,
                             is_stable=False)
    n = n_r + n_l
    pos = jnp.arange(n, dtype=jnp.int32)
    keyinv = pks >> jnp.uint64(1)           # (key, invalid) run id
    run_start = jnp.concatenate([
        jnp.ones(1, jnp.bool_), keyinv[1:] != keyinv[:-1]])
    start_pos = jax.lax.cummax(jnp.where(run_start, pos, 0))
    invs = (pks >> jnp.uint64(1)) & jnp.uint64(1) == jnp.uint64(1)
    sides1 = pks & jnp.uint64(1) == jnp.uint64(1)
    is_build = ~sides1 & ~invs
    pb = jnp.cumsum(is_build.astype(jnp.int32))          # inclusive
    pb_excl = pb - is_build.astype(jnp.int32)
    builds_in_run = pb - pb_excl[start_pos]
    is_probe = sides1 & ~invs
    counts = jnp.where(is_probe, builds_in_run, 0)
    row_key = jnp.where(sides1, idxs.astype(jnp.uint32),
                        jnp.uint32(0xFFFFFFFF))
    _, counts_o, start_o = jax.lax.sort(
        (row_key, counts, start_pos), num_keys=1, is_stable=True)
    counts_orig = counts_o[:n_l]
    start_orig = start_o[:n_l]
    total = jnp.sum(counts_orig.astype(jnp.int64))
    return counts_orig, start_orig, idxs, total


def _probe_stage(lkey, lvalid, rkey, rvalid):
    """Device half of the hash join, one XLA program — sort-merge plan.

    ONE fused multi-operand sort of build+probe keys replaces the r1
    binary searches (searchsorted = ~21 rounds of random gathers each;
    multi-key lax.sort measured ~10x cheaper at 10M, CLAUDE.md):

      sort (key, invalid, side, row): equal valid keys form runs with
      build rows FIRST, probe rows after; invalid rows of either side
      land in separate runs (second key) so NULL never matches.  Each
      probe slot's match count = builds in its run via one cumsum; a
      second cheap sort maps (count, run start) back to ORIGINAL probe
      order so the expansion emits probe-ordered pairs directly (no
      output re-sort).
    """
    n_r = rkey.shape[0]
    n_l = lkey.shape[0]
    key_cat = jnp.concatenate([rkey, lkey])
    inv = jnp.concatenate([~rvalid, ~lvalid])
    side = jnp.concatenate([jnp.zeros(n_r, jnp.uint8),
                            jnp.ones(n_l, jnp.uint8)])
    iota = jnp.concatenate([jnp.arange(n_r, dtype=jnp.int32),
                            jnp.arange(n_l, dtype=jnp.int32)])
    ks, invs, sides, idxs = jax.lax.sort(
        (key_cat, inv, side, iota), num_keys=3, is_stable=False)
    n = n_r + n_l
    pos = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.concatenate([
        jnp.ones(1, jnp.bool_),
        (ks[1:] != ks[:-1]) | (invs[1:] != invs[:-1])])
    start_pos = jax.lax.cummax(jnp.where(run_start, pos, 0))
    is_build = (sides == 0) & ~invs
    pb = jnp.cumsum(is_build.astype(jnp.int32))          # inclusive
    pb_excl = pb - is_build.astype(jnp.int32)
    builds_in_run = pb - pb_excl[start_pos]
    is_probe = (sides == 1) & ~invs
    counts = jnp.where(is_probe, builds_in_run, 0)
    # back to ORIGINAL probe order (invalid probes keep count 0)
    row_key = jnp.where(sides == 1, idxs.astype(jnp.uint32),
                        jnp.uint32(0xFFFFFFFF))
    _, counts_o, start_o = jax.lax.sort(
        (row_key, counts, start_pos), num_keys=1, is_stable=True)
    counts_orig = counts_o[:n_l]
    start_orig = start_o[:n_l]
    total = jnp.sum(counts_orig.astype(jnp.int64))
    return counts_orig, start_orig, idxs, total


@functools.partial(jax.jit, static_argnames=("n_out",))
def _expand_stage(counts_orig, start_orig, idxs, n_out):
    """Capacity-padded device pair expansion in probe order.

    searchsorted over the count prefix sums is log2(n) rounds of RANDOM
    gathers and gathers cost ~5 s per 50M at the 100M cliff (measured:
    26 s of a 37 s join).  Both sides are sorted, so the merge computes
    BY SORT + SCAN instead:

      concat (prefix sums, tag A) with (output positions, tag B) and
      stable-sort by (value, tag).  Each A element carries its probe
      row and run start PACKED into monotone i64 payloads
      (probe_id << 32 | field), so a plain cummax fills every B slot
      with its probe's info — no gathers.  A second partition sort
      peels the B slots back out in output order.  The only remaining
      gather is the unavoidable one materializing build row ids.

    Packing limits: probe rows < 2^31 and run starts < 2^32 (single-
    chip sizes are far below both)."""
    n_l = counts_orig.shape[0]
    incl = jnp.cumsum(counts_orig.astype(jnp.int64))
    out_i = jnp.arange(n_out, dtype=jnp.int64)
    v = jnp.concatenate([incl, out_i])
    tag = jnp.concatenate([jnp.zeros(n_l, jnp.uint8),
                           jnp.ones(n_out, jnp.uint8)])
    # output position o belongs to probe p = #(incl <= o); the LAST A
    # element before o in the merge has aid == p, carries the NEXT
    # probe's run start, and its own incl IS that probe's exclusive
    # prefix.  B slots seed the fill for outputs before any A
    # (probe 0): aid 0, start_orig[0], excl 0.
    aid = jnp.arange(1, n_l + 1, dtype=jnp.int64)
    start64 = start_orig.astype(jnp.int64)
    start_next = jnp.concatenate([start64[1:], jnp.zeros(1, jnp.int64)])
    p_start = jnp.concatenate([
        (aid << 32) | start_next,
        jnp.full(n_out, start64[0], jnp.int64)])
    p_excl = jnp.concatenate([(aid << 32) | incl,
                              jnp.zeros(n_out, jnp.int64)])
    # pack the tag into the merge key's low bit (v < 2^62: out sizes
    # are far below) — ONE i64 key instead of a 2-key stable sort; ties
    # among equal-v A entries don't matter (cummax takes the max
    # payload, and payloads rise with probe id).  The tag comes back
    # out of the sorted key's low bit for the peel-out sort.
    v2 = (v << 1) | tag.astype(jnp.int64)
    v2_s, ps_s, pe_s = jax.lax.sort(
        (v2, p_start, p_excl), num_keys=1, is_stable=False)
    ps_f = jax.lax.cummax(ps_s)
    pe_f = jax.lax.cummax(pe_s)
    tag_s = (v2_s & 1).astype(jnp.uint8)
    _, ps_b, pe_b = jax.lax.sort((tag_s, ps_f, pe_f), num_keys=1,
                                 is_stable=True)
    ps_b = ps_b[n_l:]
    pe_b = pe_b[n_l:]
    mask32 = jnp.int64(0xFFFFFFFF)
    probe_idx = jnp.minimum(ps_b >> 32, n_l - 1).astype(jnp.int32)
    start_b = ps_b & mask32
    excl_b = pe_b & mask32
    within = out_i - excl_b
    build_pos = jnp.minimum(start_b + within, idxs.shape[0] - 1)
    build_idx = idxs[build_pos]
    return probe_idx, build_idx


def _finish_index_join(ri32, cnt_dev, n_l: int, how: str):
    """Assemble join outputs from the perfect-index probe result
    (m:1 by construction — every probe row has at most one match)."""
    matched = ri32 >= 0
    if how == "semi":
        idx = _indices_of_mask(matched)
        return idx.astype(jnp.int64), jnp.full(idx.shape, -1,
                                               jnp.int64)
    if how == "anti":
        idx = _indices_of_mask(~matched)
        return idx.astype(jnp.int64), jnp.full(idx.shape, -1,
                                               jnp.int64)
    if how == "left":
        # one row per probe row, already probe-ordered
        return (jnp.arange(n_l, dtype=jnp.int64),
                ri32.astype(jnp.int64))
    if how == "inner":
        from .filter import compact_by_mask
        cnt = int(cnt_dev)
        if n_l < (1 << 31):
            # compact at i32 width: halves the partition-sort operand
            # bytes (measured on-chip r5: 0.457 s vs 0.85 s at 100M
            # probe / 50M matches — the finish was 43% of the probe);
            # the widening casts fuse into the output copy for free
            li = jnp.arange(n_l, dtype=jnp.int32)
            lo, ro = compact_by_mask(matched, cnt, li, ri32)
            return lo.astype(jnp.int64), ro.astype(jnp.int64)
        li = jnp.arange(n_l, dtype=jnp.int64)
        lo, ro = compact_by_mask(matched, cnt, li,
                                 ri32.astype(jnp.int64))
        return lo, ro
    raise ArrowInvalid(f"unknown join type {how}")


def _round_capacity(n: int) -> int:
    """Round up to 1/8-geometric buckets so expansion shapes (and their
    compiles) are reused across nearby output sizes."""
    if n <= 1024:
        return 1024
    k = max((n - 1).bit_length() - 4, 0)
    step = 1 << k
    return ((n + step - 1) // step) * step


def _indices_of_mask(mask: jnp.ndarray) -> jnp.ndarray:
    from .filter import _nonzero_indices
    count = int(jnp.sum(mask))
    return _nonzero_indices(mask, count)


def join_indices(left: Table, right: Table, on: Sequence[str],
                 how: str = "inner",
                 right_on: Optional[Sequence[str]] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Compute (left_indices, right_indices) row pairs; -1 marks the
    null-extended side (left joins).  Device-resident end to end: the
    only host syncs are output-size scalars (arrow-select take.rs:86 /
    interleave.rs:70 are the reassembly primitives this feeds)."""
    right_on = right_on or on
    if left.num_rows == 0 or right.num_rows == 0:
        # the range scan reduces over valid keys; empty inputs are
        # routine (a filter that matched nothing feeding a join)
        if left.num_rows and how in ("left", "anti"):
            # no right rows: every left row is unmatched
            li = jnp.arange(left.num_rows, dtype=jnp.int64)
            return li, jnp.full((left.num_rows,), -1, jnp.int64)
        empty = jnp.zeros((0,), jnp.int64)
        return empty, empty
    on_cols = [left.column(c) for c in on]
    r_cols = [right.column(c) for c in right_on]
    multi = len(on) > 1

    def _index_fits(span):
        return 0 < span <= min(1 << 27,
                               max(1 << 22, 4 * right.num_rows))

    # single-primitive-key FUSED plan (r5): the order-key encode rides
    # inside the scan/build/probe programs — no 8B/row key buffer
    # materializes and the two eager encode dispatches disappear
    # (CLAUDE.md: eager ops at large shapes cost ~100x jitted)
    ltag = rtag = None
    if not multi:
        ltag = _prim_encode_tag(on_cols[0])
        rtag = _prim_encode_tag(r_cols[0])
    if ltag is not None and rtag is not None:
        lcol, rcol = on_cols[0], r_cols[0]
        lvals, rvals = lcol.values, rcol.values
        lvalid = vd.make_mask(left.num_rows, lcol.validity)
        rvalid = vd.make_mask(right.num_rows, rcol.validity)
        rng = np.asarray(_key_range_scan_raw(lvals, lvalid, rvals,
                                             rvalid, ltag, rtag))
        kmin, kmax = int(rng[0]), int(rng[1])
        bmin, bmax = int(rng[2]), int(rng[3])
        span = bmax - bmin + 1 if bmin <= bmax else 0
        if right.num_rows > 0 and _index_fits(span):
            table, dup = _index_build_raw(rvals, rvalid,
                                          jnp.uint64(bmin), span, rtag)
            if not bool(dup):
                ri32, cnt_dev = _index_probe_raw(lvals, lvalid, table,
                                                 jnp.uint64(bmin), ltag)
                return _finish_index_join(ri32, cnt_dev, left.num_rows,
                                          how)
        # fall through to the sort plans: materialize the keys once
        lkey, _lv = encode_value_key(lcol)
        rkey, _rv = encode_value_key(rcol)
        lkeys, rkeys = [lkey], [rkey]
    else:
        lkey, lvalid, rkey, rvalid, lkeys, rkeys = combined_keys(
            on_cols, r_cols)

        # packed plan when the combined key range fits 61 bits (common:
        # rebased int keys, string ranks) — single-key sorts, fewer
        # operand streams
        rng = np.asarray(_key_range_scan(lkey, lvalid, rkey, rvalid))
        kmin, kmax = int(rng[0]), int(rng[1])
        bmin, bmax = int(rng[2]), int(rng[3])
        span = bmax - bmin + 1 if bmin <= bmax else 0

        # perfect-index plan: single exact key whose BUILD range is
        # comparable to the build size — a dense table replaces every
        # merge sort with one build sort + one probe gather (requires
        # unique build keys, detected on device; DuckDB's perfect-hash
        # join re-designed for gather-friendly hardware).  Probe keys
        # outside the build range simply miss.
        if not multi and right.num_rows > 0 and _index_fits(span):
            table, dup = _index_build_stage(rkey, rvalid,
                                            jnp.uint64(bmin), span)
            if not bool(dup):
                ri32, cnt_dev = _index_probe_stage(lkey, lvalid, table,
                                                   jnp.uint64(bmin))
                return _finish_index_join(ri32, cnt_dev, left.num_rows,
                                          how)

    if kmin <= kmax and (kmax - kmin) < (1 << 61):
        counts_orig, start_orig, idxs, total_dev = _probe_stage_packed(
            lkey, lvalid, rkey, rvalid, jnp.uint64(kmin))
    else:
        counts_orig, start_orig, idxs, total_dev = _probe_stage(
            lkey, lvalid, rkey, rvalid)

    if how in ("semi", "anti") and not multi:
        matched = counts_orig > 0
        mask = matched if how == "semi" else ~matched
        idx = _indices_of_mask(mask)
        return idx.astype(jnp.int64), jnp.full(idx.shape, -1, jnp.int64)
    # multi-key semi/anti fall through: the match set must survive the
    # same mixer-collision verification inner/left get (a 64-bit hash
    # collision would otherwise fake a membership hit)

    total = int(total_dev)
    n_pad = _round_capacity(total)
    probe_idx, build_idx = _expand_stage(counts_orig, start_orig, idxs,
                                         n_pad)
    probe_idx, build_idx = probe_idx[:total], build_idx[:total]

    collisions_removed = False
    if multi and total:
        # verify against mixer collisions with exact per-column compare
        ok = jnp.ones(total, jnp.bool_)
        for lk, rk in zip(lkeys, rkeys):
            ok &= lk[probe_idx] == rk[build_idx]
        n_ok = int(jnp.sum(ok))
        if n_ok != total:
            from .filter import compact_by_mask
            probe_idx, build_idx = compact_by_mask(ok, n_ok, probe_idx,
                                                   build_idx)
            total = n_ok
            collisions_removed = True

    probe_idx = probe_idx.astype(jnp.int64)
    build_idx = build_idx.astype(jnp.int64)
    if how in ("semi", "anti"):
        matched = jnp.zeros(left.num_rows, jnp.bool_) \
            .at[probe_idx].set(True)
        mask = matched if how == "semi" else ~matched
        idx = _indices_of_mask(mask)
        return idx.astype(jnp.int64), jnp.full(idx.shape, -1, jnp.int64)
    if how == "inner":
        # expansion already emits probe order
        return probe_idx, build_idx
    if how == "left":
        if multi and collisions_removed:
            # rare path: some probe rows lost every match to collision
            # verification; rebuild the mask from the surviving pairs
            matched = jnp.zeros(left.num_rows, jnp.bool_) \
                .at[probe_idx].set(True)
        else:
            # counts>0 is exact, no scatter needed
            matched = counts_orig > 0
        unmatched = _indices_of_mask(~matched).astype(jnp.int64)
        li = jnp.concatenate([probe_idx, unmatched])
        ri = jnp.concatenate([build_idx,
                              jnp.full(unmatched.shape, -1, jnp.int64)])
        order = jnp.argsort(li, stable=True)
        return li[order], ri[order]
    raise ArrowInvalid(f"unknown join type {how}")


class HashJoiner:
    """Build once, probe many: the streaming half of the hash join.

    For probe sides larger than device memory (BASELINE config 5 runs
    1B probe rows against a 100M build side), the build side
    is prepared ONCE and probe chunks stream through `probe_indices`.
    Mirrors the build/probe split of arrow's ecosystem engines (the
    reference delegates joins to them, SURVEY.md §2); the build
    structure here is the gather-friendly perfect index of
    join_indices, with a per-chunk merge fallback for duplicate or
    wide-range build keys."""

    # dense-table span cap: i32[2^28] = 1 GiB, sized for a 100M build
    # side with 2x key spread
    _SPAN_CAP = 1 << 28

    def __init__(self, right: Table, on: Sequence[str],
                 right_on: Optional[Sequence[str]] = None):
        self.right = right
        self.on = list(on)
        self.right_on = list(right_on or on)
        self.multi = len(self.on) > 1
        self._plan = "merge"               # until proven index-able
        self.table = None
        if right.num_rows == 0:
            self._plan = "empty"
            return
        rcols = [right.column(c) for c in self.right_on]
        from ..core.column import DictionaryColumn, StringColumn
        stringy = any(isinstance(c, (StringColumn, DictionaryColumn))
                      for c in rcols)
        if not self.multi and not stringy:
            c0 = rcols[0]
            if not c0.dtype.is_floating:
                # ONE fused program + ONE fetch instead of an eager
                # encode/scan chain of ~6 row-sized dispatches
                rkey, rvalid, lh = _build_encode_scan(c0)
                lh_h = np.asarray(lh)
                lo, hi = int(lh_h[0]), int(lh_h[1])
            else:
                # float keys: the eager encode path (not fused into
                # one program yet)
                rkey, rvalid = encode_value_key(c0)
                rvalid = vd.make_mask(rkey.shape[0], rvalid)
                top = jnp.uint64(0xFFFFFFFFFFFFFFFF)
                lo = int(jnp.min(jnp.where(rvalid, rkey, top)))
                hi = int(jnp.max(jnp.where(rvalid, rkey,
                                           jnp.uint64(0))))
            span = hi - lo + 1 if lo <= hi else 0
            if 0 < span <= self._SPAN_CAP:
                table, dup = _index_build_stage(rkey, rvalid,
                                                jnp.uint64(lo), span)
                if not bool(dup):
                    self.table = table
                    self.kmin = lo
                    self._plan = "index"
                    return

    def probe_indices(self, left: Table, how: str = "inner"
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(left_indices, right_indices) for one probe chunk; row ids
        are chunk-local (caller offsets by its chunk start)."""
        if self._plan == "empty" or left.num_rows == 0:
            if left.num_rows and how in ("left", "anti"):
                li = jnp.arange(left.num_rows, dtype=jnp.int64)
                return li, jnp.full((left.num_rows,), -1, jnp.int64)
            empty = jnp.zeros((0,), jnp.int64)
            return empty, empty
        if self._plan == "merge":
            # correct for every key type; re-runs the two-sided merge
            # per chunk (build sort cost repeats — the index plan is
            # the streaming fast path)
            return join_indices(left, self.right, self.on, how,
                                self.right_on)
        lkey, lvalid = self._probe_key(left)
        ri32, cnt_dev = _index_probe_stage(lkey, lvalid, self.table,
                                           jnp.uint64(self.kmin))
        return _finish_index_join(ri32, cnt_dev, left.num_rows, how)

    def _probe_key(self, left: Table):
        """Fused probe-key encode (one program, no eager chain) for
        non-float keys; float keys keep the eager encode path."""
        c = left.column(self.on[0])
        if not c.dtype.is_floating:
            k, v, _ = _build_encode_scan(c)
            return k, v
        lkey, lvalid = encode_value_key(c)
        return lkey, vd.make_mask(lkey.shape[0], lvalid)

    def probe_count(self, left: Table) -> Tuple[int, int]:
        """(matched pair count, checksum of matched build row ids) —
        one fused device pass, no pair materialization (the streaming
        aggregate consumers' path)."""
        if self._plan != "index" or left.num_rows == 0:
            li, ri = self.probe_indices(left, "inner")
            return int(li.shape[0]), int(jnp.sum(ri)) if ri.shape[0] \
                else 0
        lkey, lvalid = self._probe_key(left)
        cnt, chk = _index_probe_count(lkey, lvalid, self.table,
                                      jnp.uint64(self.kmin))
        return int(cnt), int(chk)

    def probe_count_device(self, left: Table):
        """probe_count WITHOUT the host sync: returns DEVICE scalars
        (cnt, chk) so a streaming caller can accumulate on device and
        fetch once — the double-buffered form of the 1B-probe loop
        (SURVEY §2.4 overlap; a per-chunk int() fetch serializes the
        pipeline on device round trips)."""
        if self._plan != "index" or left.num_rows == 0:
            c, k = self.probe_count(left)
            return jnp.int64(c), jnp.int64(k)
        lkey, lvalid = self._probe_key(left)
        return _index_probe_count(lkey, lvalid, self.table,
                                  jnp.uint64(self.kmin))


@jax.jit
def _build_encode_scan(col):
    """encode_value_key + validity + min/max scan fused into ONE device
    program (non-float dtypes only: the f64 order map needs a host
    bitcast on this backend).  Returns (key u64, valid mask,
    [lo, hi])."""
    rkey, rvalid = encode_value_key(col)
    rvalid = vd.make_mask(rkey.shape[0], rvalid)
    top = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    lo = jnp.min(jnp.where(rvalid, rkey, top))
    hi = jnp.max(jnp.where(rvalid, rkey, jnp.uint64(0)))
    return rkey, rvalid, jnp.stack([lo, hi])


@jax.jit
def _index_probe_count(lkey, lvalid, table, kmin):
    """Fused probe + reduce: match count and build-id checksum, no
    intermediate pair arrays (keeps a 1B-row streamed probe inside
    device memory)."""
    R = table.shape[0]
    idx = jnp.where(lvalid, lkey - kmin, jnp.uint64(R))
    inr = lvalid & (idx < jnp.uint64(R))
    ri = jnp.where(inr, table[jnp.minimum(
        idx, jnp.uint64(max(R - 1, 0))).astype(jnp.int64)],
        jnp.int32(-1))
    m = ri >= 0
    return (jnp.sum(m.astype(jnp.int64)),
            jnp.sum(jnp.where(m, ri.astype(jnp.int64), 0)))


def join(left: Table, right: Table, on: Sequence[str], how: str = "inner",
         right_on: Optional[Sequence[str]] = None,
         suffix: str = "_right") -> Table:
    """Join two tables; output = left columns + right non-key columns
    (keys taken from the left side, SQL USING semantics)."""
    right_on_l = list(right_on or on)
    li, ri = join_indices(left, right, on, how, right_on)
    l_idx = PrimitiveColumn(li, dt.int64)
    cols: List[Column] = [take_kernel(c, l_idx) for c in left.columns]
    fields = list(left.schema.fields)
    if how in ("semi", "anti"):
        return Table(tuple(cols), dt.Schema(tuple(fields)), _validated=True)

    null_ext = ri < 0
    any_null = how == "left" and bool(jnp.any(null_ext))
    r_idx = PrimitiveColumn(jnp.where(null_ext, 0, ri), dt.int64,
                            ~null_ext if any_null else None)
    taken_names = set(left.schema.names)
    for f, c in zip(right.schema.fields, right.columns):
        if f.name in right_on_l:
            continue
        name = f.name if f.name not in taken_names else f.name + suffix
        cols.append(take_kernel(c, r_idx))
        fields.append(dt.Field(name, f.dtype, nullable=True))
    return Table(tuple(cols), dt.Schema(tuple(fields)), _validated=True)
