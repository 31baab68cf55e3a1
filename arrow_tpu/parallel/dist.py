"""Distributed operators: group-by, join, sort over the shard mesh.

These are the BASELINE configs 3-5 at scale: each operator is a shard_map
program = local vector kernels + one hash/range repartition (all_to_all) —
the "shuffle" that arrow-flight performs over gRPC in the reference's
ecosystem (SURVEY.md §2.4), here fused into the XLA program.

Everything is static-shape / jit-safe: outputs are capacity-padded with
validity masks (the engine's batch idiom, SURVEY.md §7).  Eager wrappers
that trim padding live in parallel.api.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import shard_axis
from .partition import bucketize, exchange, hash_u64, repartition_arrays
from ..ops.groupby import float_group_sums

__all__ = ["local_group_aggregate", "dist_group_by",
           "dist_group_by_stream", "dist_join_unique",
           "dist_join", "dist_join_stream", "dist_join_skew",
           "dist_sort", "dist_sum"]

_U64_MAX = jnp.uint64(0xFFFFFFFFFFFFFFFF)


# ---- local building blocks (run inside shard_map, static shapes) -----------

def local_group_aggregate(key: jnp.ndarray, valid: jnp.ndarray,
                          group_cap: int,
                          specs: Sequence[Tuple[str, jnp.ndarray]]):
    """Sort-based grouped aggregation with a static group capacity.

    Returns (group_keys (cap,), group_valid (cap,), [agg results (cap,)],
    overflow).  Groups beyond `group_cap` cannot fit the static output --
    `overflow` goes True instead of silently returning wrong aggregates
    (callers size the capacity from cardinality knowledge; the distributed
    wrapper psums the flag so every shard agrees).
    """
    n = key.shape[0]
    k = jnp.where(valid, key, _U64_MAX)
    # ONE payload-carrying sort: the aggregate source tensors ride as
    # extra operands instead of a post-sort random gather.
    # ~valid is a SECOND sort key so a valid group whose key equals the
    # invalid-row sentinel (u64::MAX / i64::MAX) sorts BEFORE the
    # invalid rows of its run — else its run start is an invalid row,
    # eligible misses it, and its rows silently merge into the
    # previous group (the dist_join two-key sort is the same fix)
    uniq_arrays = []
    uniq_pos = {}
    for _, arr in specs:
        if id(arr) not in uniq_pos:
            uniq_pos[id(arr)] = len(uniq_arrays)
            uniq_arrays.append(arr)
    sorted_ops = jax.lax.sort(
        (k, ~valid, valid) + tuple(uniq_arrays), num_keys=2,
        is_stable=True)
    ks = sorted_ops[0]
    vs = sorted_ops[2]
    sorted_arrays = sorted_ops[3:]
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 ks[1:] != ks[:-1]])
    gid_all = jnp.cumsum(run_start.astype(jnp.int32)) - 1
    # invalid rows -> overflow segment
    gid = jnp.where(vs, jnp.minimum(gid_all, group_cap), group_cap)

    # scatter-free (so deterministic) segment machinery: run starts via a
    # partition-sort, counts/sums via cumsum + boundary diff, min/max
    # via a secondary (gid, value-key) sort — same strategy ladder as
    # ops.groupby._agg_stage, in static-shape shard_map form.
    iota = jnp.arange(n, dtype=jnp.int32)
    eligible = run_start & vs & (gid_all < group_cap)
    _, starts_raw = jax.lax.sort((~eligible, iota), num_keys=1,
                                 is_stable=True)
    # extend with n-sentinels so slicing is safe when n < group_cap + 1
    starts_all = jnp.concatenate(
        [starts_raw, jnp.full((group_cap + 1,), n, jnp.int32)])
    slots = jnp.arange(group_cap, dtype=jnp.int32)
    n_groups = jnp.sum(eligible, dtype=jnp.int32)
    starts = jnp.where(slots < n_groups,
                       starts_all[:group_cap], jnp.int32(n))
    starts_c = jnp.minimum(starts, n - 1)

    group_keys = jnp.where(slots < n_groups, ks[starts_c],
                           jnp.zeros((), key.dtype))

    def diff_sums(contrib):
        cs = jnp.cumsum(contrib)
        nxt = jnp.where(slots + 1 <= n_groups - 1,
                        starts_all[1:group_cap + 1], jnp.int32(n))
        # rows beyond the last real group (overflow/invalid) are excluded
        # by zeroed contributions
        end_cs = cs[jnp.maximum(nxt - 1, 0)]
        start_cs = jnp.where(starts_c > 0, cs[starts_c - 1],
                             jnp.zeros((), cs.dtype))
        return jnp.where(slots < n_groups, end_cs - start_cs,
                         jnp.zeros((), cs.dtype))

    in_cap = vs & (gid_all < group_cap)
    counts = diff_sums(in_cap.astype(jnp.int64))
    group_valid = counts > 0
    outs = []
    mm_cache = {}
    for op, arr in specs:
        a = sorted_arrays[uniq_pos[id(arr)]]
        if op == "count":
            outs.append(counts)
            continue
        if op == "sum":
            contrib = jnp.where(in_cap, a, jnp.zeros((), a.dtype))
            if jnp.issubdtype(a.dtype, jnp.floating):
                outs.append(float_group_sums(contrib.astype(jnp.float64),
                                             diff_sums).astype(a.dtype))
            else:
                outs.append(diff_sums(contrib.astype(jnp.int64))
                            .astype(a.dtype))
            continue
        if op in ("min", "max"):
            cache_key = id(arr)
            if cache_key not in mm_cache:
                # operand diet (same design as groupby.minmax_sorted):
                # the native value is its own sort key and the 2-bit
                # class (0 valid, 1 NaN, 2 null) packs into the gid
                # key's low bits (gid < n rows; shard sizes beyond
                # 2^29 rows would need the 3-operand fallback).
                # (associative_scan segmented min/max SIGKILLed the
                # remote AOT compiler at 100M; sort stays.)
                assert n < 2 ** 29, "shard too large for packed gid|cls"
                if jnp.issubdtype(a.dtype, jnp.floating):
                    isnan = jnp.isnan(a)
                    vals = jnp.where(isnan, jnp.zeros((), a.dtype), a)
                    cls = jnp.where(in_cap, isnan.astype(jnp.int32), 2)
                    isfloat = True
                else:
                    vals = a
                    cls = (~in_cap).astype(jnp.int32)
                    isfloat = False
                packed = (gid.astype(jnp.int32) << 2) | cls
                srt = jax.lax.sort((packed, vals), num_keys=2,
                                   is_stable=False)
                nonnull = diff_sums(in_cap.astype(jnp.int64))
                mm_cache[cache_key] = (srt[1], srt[0], nonnull, isfloat)
            v_final, ckey, nonnull, isfloat = mm_cache[cache_key]

            def pick(idx):
                v = v_final[idx]
                if isfloat:
                    v = jnp.where((ckey[idx] & 3) == 1,
                                  jnp.array(jnp.nan, v.dtype), v)
                return v

            if op == "min":
                outs.append(pick(starts_c))
            else:
                pos = jnp.minimum(starts_c + jnp.maximum(nonnull, 1) - 1,
                                  n - 1).astype(jnp.int32)
                outs.append(pick(pos))
            continue
        raise ValueError(f"unknown aggregate {op}")
    # count ALL distinct valid keys (not the capped eligible set) so an
    # undersized capacity is reported, never silently dropped
    total_groups = jnp.sum(run_start & vs, dtype=jnp.int32)
    overflow = total_groups > group_cap
    return group_keys, group_valid, outs, overflow


def _sort_build_side(build_key, build_valid,
                     build_vals: Sequence[jnp.ndarray]):
    """Sort the build side ONCE for repeated lookups: returns
    (sorted keys, sorted invalid flags, [build values in key order])."""
    bk = jnp.where(build_valid, build_key, _U64_MAX)
    # ~valid as a tiebreak key: probe keys equal to the sentinel must
    # land on the VALID build row, not an invalid one that ties it
    iota = jnp.arange(bk.shape[0], dtype=jnp.int32)
    bks, inv_s, order = jax.lax.sort((bk, ~build_valid, iota),
                                     num_keys=2, is_stable=True)
    return bks, inv_s, [bv[order] for bv in build_vals]


def _lookup_sorted(probe_key, probe_valid, bks, inv_s, bvals_sorted):
    """Probe a pre-sorted unique-key build side."""
    pos = jnp.searchsorted(bks, probe_key)
    pos_c = jnp.clip(pos, 0, bks.shape[0] - 1)
    hit = (bks[pos_c] == probe_key) & probe_valid & ~inv_s[pos_c]
    gathered = [bv[pos_c] for bv in bvals_sorted]
    return hit, gathered


def _local_lookup_unique(probe_key, probe_valid, build_key, build_valid,
                         build_vals: Sequence[jnp.ndarray]):
    """For each probe row find the (unique) matching build row.
    Returns (match_valid, [gathered build values])."""
    bks, inv_s, bvals_sorted = _sort_build_side(build_key, build_valid,
                                                build_vals)
    return _lookup_sorted(probe_key, probe_valid, bks, inv_s,
                          bvals_sorted)


# ---- distributed operators ---------------------------------------------------

def dist_group_by(axis: str, key: jnp.ndarray, valid: jnp.ndarray,
                  shuffle_cap: int, group_cap: int,
                  specs: Sequence[Tuple[str, jnp.ndarray]]):
    """shard_map body: hash-shuffle rows by key, then local grouped
    aggregation.  Output groups are disjoint across shards (sharded by
    hash(key) % n_shards)."""
    arrays = (key,) + tuple(a for _, a in specs)
    sh = repartition_arrays(axis, key, valid, shuffle_cap, *arrays)
    k2 = sh.arrays[0]
    specs2 = [(op, arr) for (op, _), arr in zip(specs, sh.arrays[1:])]
    gk, gv, outs, g_over = local_group_aggregate(k2, sh.valid, group_cap,
                                                 specs2)
    overflow = sh.overflow | (jax.lax.psum(g_over.astype(jnp.int32),
                                           axis) > 0)
    return gk, gv, outs, overflow


_MERGE_OP = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def dist_group_by_stream(axis: str, key_chunks: jnp.ndarray,
                         valid_chunks: jnp.ndarray, shuffle_cap: int,
                         group_cap: int, ops: Sequence[str],
                         val_chunks: Sequence[jnp.ndarray]):
    """CHUNKED distributed group-by with software-pipelined exchange
    (SURVEY §2.4 "double-buffered async collectives overlapping
    compute").

    Inputs are (C, n)-shaped per-shard chunk stacks.  Each lax.scan
    iteration issues chunk i+1's all_to_all shuffle AND aggregates the
    already-shuffled chunk i — the two are data-independent inside one
    program, so XLA's latency-hiding scheduler runs the exchange
    concurrently with the local sort/segment work (the in-program form
    of the reference ecosystem's streamed Flight DoExchange).  Chunk
    partials stack up and one final local merge (sum/count->sum,
    min->min, max->max) reduces them; output groups are disjoint across
    shards (hash-partitioned), padded to group_cap.

    Returns (group_keys, group_valid, [agg results], overflow).
    """
    C = key_chunks.shape[0]

    def shuffle(k, ok, vs):
        sh = repartition_arrays(axis, k, ok, shuffle_cap, k, *vs)
        return sh.arrays[0], sh.valid, tuple(sh.arrays[1:]), sh.overflow

    def agg(k, ok, vs):
        return local_group_aggregate(k, ok, group_cap,
                                     list(zip(ops, vs)))

    cur = shuffle(key_chunks[0], valid_chunks[0],
                  tuple(v[0] for v in val_chunks))

    def body(carry, xs):
        cur_k, cur_ok, cur_vs, over = carry
        nk, nok = xs[0], xs[1]
        nvs = xs[2:]
        nxt = shuffle(nk, nok, nvs)          # chunk i+1 exchange ...
        gk, gv, outs, g_over = agg(cur_k, cur_ok, cur_vs)  # ... overlaps
        over = over | nxt[3] | g_over        # chunk i's aggregation
        return (nxt[0], nxt[1], nxt[2], over), \
            (gk, gv, tuple(outs))

    if C > 1:
        xs = (key_chunks[1:], valid_chunks[1:]) \
            + tuple(v[1:] for v in val_chunks)
        # the psum'd overflow flag is replicated while the body's agg
        # overflow is axis-varying: promote the initial carry so scan's
        # carry types match (shard_map vma rule)
        over0 = jax.lax.pcast(cur[3], (axis,), to="varying")
        (lk, lok, lvs, over), partials = jax.lax.scan(
            body, (cur[0], cur[1], cur[2], over0), xs)
    else:
        lk, lok, lvs, over = cur
        partials = None
    gk_l, gv_l, outs_l, g_over = agg(lk, lok, lvs)
    over = over | g_over

    if partials is None:
        over = jax.lax.psum(over.astype(jnp.int32), axis) > 0
        return gk_l, gv_l, list(outs_l), over
    pk, pv, pouts = partials
    all_k = jnp.concatenate([pk.reshape(-1), gk_l])
    all_v = jnp.concatenate([pv.reshape(-1), gv_l])
    merged_vals = []
    merge_ops = [_MERGE_OP[o] for o in ops]
    for po, lo in zip(pouts, outs_l):
        merged_vals.append(jnp.concatenate([po.reshape(-1), lo]))
    mk, mv, mouts, m_over = local_group_aggregate(
        all_k, all_v, group_cap, list(zip(merge_ops, merged_vals)))
    # mesh-agree the accumulated (axis-varying) flags -> replicated
    over = jax.lax.psum((over | m_over).astype(jnp.int32), axis) > 0
    return mk, mv, mouts, over


def dist_sum(axis: str, values: jnp.ndarray, valid: jnp.ndarray):
    """Global masked sum: local reduce + psum (the low-cardinality
    aggregate fast path: no shuffle at all)."""
    local = jnp.sum(jnp.where(valid, values, jnp.zeros((), values.dtype)))
    return jax.lax.psum(local, axis)


def dist_join_unique(axis: str,
                     probe_key, probe_valid, probe_vals: Sequence,
                     build_key, build_valid, build_vals: Sequence,
                     probe_cap: int, build_cap: int):
    """FK join (unique build keys): co-shuffle both sides by key hash, then
    local sorted lookup.  Returns
    (probe_key', probe_valid', probe_vals', match_valid, build_vals').

    Probe rows stay row-aligned with their shuffled slab (static shapes);
    `match_valid` marks rows with a build-side match; unmatched rows carry
    zeros (left-join semantics are match_valid; inner = probe_valid' &
    match_valid).  The trailing `overflow` flag reports shuffle capacity
    loss on either side (mesh-agreed; never silent)."""
    psh = repartition_arrays(axis, probe_key, probe_valid, probe_cap,
                             probe_key, *probe_vals)
    bsh = repartition_arrays(axis, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    pk = psh.arrays[0]
    bk = bsh.arrays[0]
    hit, gathered = _local_lookup_unique(pk, psh.valid, bk, bsh.valid,
                                         bsh.arrays[1:])
    return pk, psh.valid, psh.arrays[1:], hit, gathered, \
        psh.overflow | bsh.overflow


def dist_join_stream(axis: str,
                     probe_key_chunks: jnp.ndarray,
                     probe_valid_chunks: jnp.ndarray,
                     probe_val_chunks: Sequence[jnp.ndarray],
                     build_key, build_valid,
                     build_vals: Sequence[jnp.ndarray],
                     probe_cap: int, build_cap: int):
    """CHUNKED FK join with software-pipelined exchange (the streamed
    analog of dist_join_unique; SURVEY §2.4 double-buffered
    collectives).

    The build side co-shuffles and SORTS once; probe chunk stacks
    ((C, n)-shaped) stream through lax.scan, each iteration issuing
    chunk i+1's all_to_all beside chunk i's local sorted lookup — the
    exchange rides under the probe compute.  Returns per-chunk
    stacked (probe_key', probe_valid', [probe vals'], match_valid,
    [build vals']) plus a mesh-agreed overflow flag.
    """
    bsh = repartition_arrays(axis, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    bks, inv_s, bvals_sorted = _sort_build_side(
        bsh.arrays[0], bsh.valid, list(bsh.arrays[1:]))

    def shuffle(k, ok, vs):
        sh = repartition_arrays(axis, k, ok, probe_cap, k, *vs)
        return sh.arrays[0], sh.valid, tuple(sh.arrays[1:]), sh.overflow

    def probe(k, ok, vs):
        hit, got = _lookup_sorted(k, ok, bks, inv_s, bvals_sorted)
        return k, ok, tuple(vs), hit, tuple(got)

    C = probe_key_chunks.shape[0]
    cur = shuffle(probe_key_chunks[0], probe_valid_chunks[0],
                  tuple(v[0] for v in probe_val_chunks))

    def body(carry, xs):
        cur_k, cur_ok, cur_vs, over = carry
        nxt = shuffle(xs[0], xs[1], xs[2:])     # chunk i+1 exchange ...
        out = probe(cur_k, cur_ok, cur_vs)      # ... rides under chunk
        over = over | nxt[3]                    # i's lookup
        return (nxt[0], nxt[1], nxt[2], over), out

    if C > 1:
        xs = (probe_key_chunks[1:], probe_valid_chunks[1:]) \
            + tuple(v[1:] for v in probe_val_chunks)
        over0 = jax.lax.pcast(cur[3], (axis,), to="varying") \
            if not isinstance(cur[3], bool) else cur[3]
        (lk, lok, lvs, over), outs = jax.lax.scan(
            body, (cur[0], cur[1], cur[2], over0), xs)
    else:
        lk, lok, lvs, over = cur
        outs = None
    last = probe(lk, lok, lvs)
    over = (jax.lax.psum(over.astype(jnp.int32), axis) > 0) \
        | bsh.overflow
    if outs is None:
        k1, ok1, vs1, hit1, got1 = last
        stack = (k1[None], ok1[None], tuple(v[None] for v in vs1),
                 hit1[None], tuple(g[None] for g in got1))
        return stack + (over,)
    ks, oks, vss, hits, gots = outs
    k1, ok1, vs1, hit1, got1 = last
    ks = jnp.concatenate([ks, k1[None]])
    oks = jnp.concatenate([oks, ok1[None]])
    vss = tuple(jnp.concatenate([a, b[None]])
                for a, b in zip(vss, vs1))
    hits = jnp.concatenate([hits, hit1[None]])
    gots = tuple(jnp.concatenate([a, b[None]])
                 for a, b in zip(gots, got1))
    return ks, oks, vss, hits, gots, over


def dist_join(axis: str,
              probe_key, probe_valid, probe_vals: Sequence,
              build_key, build_valid, build_vals: Sequence,
              probe_cap: int, build_cap: int, out_cap: int):
    """General many-to-many distributed inner join, shard_map body.

    Co-shuffles both sides by key hash, then expands ALL (probe, build)
    match pairs locally with the same capacity-padded searchsorted-over-
    cumsum expansion as ops.join._expand_stage — static shapes, no host
    syncs.  Returns (out_valid (out_cap,), probe_key', [probe vals'],
    [build vals'], overflow); overflow covers both shuffle capacity loss
    and expansion beyond out_cap, psum-agreed across the mesh.

    Composition targets: arrow-select take.rs:86 / interleave.rs:70 as
    the reassembly primitives; BASELINE config 5 is this operator plus
    the skew split (dist_join_skew) for Zipf keys.
    """
    psh = repartition_arrays(axis, probe_key, probe_valid, probe_cap,
                             probe_key, *probe_vals)
    bsh = repartition_arrays(axis, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    pk, pvalid = psh.arrays[0], psh.valid
    bk, bvalid = bsh.arrays[0], bsh.valid

    # local sort-probe (ops.join._probe_stage, shard-local static form)
    n_b = bk.shape[0]
    iota = jnp.arange(n_b, dtype=jnp.int32)
    bk_adj = jnp.where(bvalid, bk, _U64_MAX)
    bk_sorted, _, b_order = jax.lax.sort((bk_adj, ~bvalid, iota),
                                         num_keys=2, is_stable=False)
    nvalid = jnp.sum(bvalid, dtype=jnp.int32)
    lo = jnp.searchsorted(bk_sorted, pk, side="left").astype(jnp.int32)
    hi = jnp.minimum(jnp.searchsorted(bk_sorted, pk, side="right")
                     .astype(jnp.int32), nvalid)
    counts = jnp.where(pvalid, jnp.maximum(hi - lo, 0), 0) \
        .astype(jnp.int64)

    # capacity-padded expansion
    incl = jnp.cumsum(counts)
    total = incl[-1]
    out_i = jnp.arange(out_cap, dtype=jnp.int64)
    probe_pos = jnp.searchsorted(incl, out_i, side="right") \
        .astype(jnp.int32)
    probe_pos_c = jnp.minimum(probe_pos, pk.shape[0] - 1)
    excl = (incl - counts)[probe_pos_c]
    within = out_i - excl
    build_pos = jnp.clip(lo[probe_pos_c].astype(jnp.int64) + within,
                         0, n_b - 1)
    build_idx = b_order[build_pos]
    out_valid = out_i < total

    out_probe_key = pk[probe_pos_c]
    out_pvals = [v[probe_pos_c] for v in psh.arrays[1:]]
    out_bvals = [v[build_idx] for v in bsh.arrays[1:]]
    expand_over = jax.lax.psum((total > out_cap).astype(jnp.int32),
                               axis) > 0
    overflow = psh.overflow | bsh.overflow | expand_over
    return out_valid, out_probe_key, out_pvals, out_bvals, overflow


def dist_sort(axis: str, key: jnp.ndarray, valid: jnp.ndarray,
              capacity: int, payloads: Sequence[jnp.ndarray] = (),
              oversample: int = 32):
    """Distributed sort by sample-based range partitioning:

      1. local sample -> all_gather  (splitter estimation)
      2. route rows to their key range's shard (all_to_all)
      3. local stable sort

    Afterwards shard i holds keys <= shard i+1's keys: globally sorted
    across the mesh (the multi-host BASELINE config-3 plan).  Invalid rows
    sort to the back of the last shard.
    """
    n_shards = jax.lax.axis_size(axis)
    n = key.shape[0]
    k = jnp.where(valid, key, _U64_MAX)

    # 1: deterministic strided sample of the locally sorted keys
    ks_local = jnp.sort(k)
    n_samples = min(n, oversample * n_shards)
    stride = max(n // max(n_samples, 1), 1)
    sample = ks_local[::stride][:n_samples]
    all_samples = jnp.sort(jax.lax.all_gather(sample, axis).reshape(-1))
    m = all_samples.shape[0]
    # n_shards-1 splitters at quantile positions
    qpos = (jnp.arange(1, n_shards) * m) // n_shards
    splitters = all_samples[qpos]

    # 2: route and exchange
    target = jnp.searchsorted(splitters, k, side="right").astype(jnp.int32)
    slabs, slab_valid, b_over = bucketize(target, jnp.ones_like(valid),
                                          n_shards, capacity, k, valid,
                                          *payloads)
    sh = exchange(axis, slabs, slab_valid, b_over)
    k2, valid2 = sh.arrays[0], sh.arrays[1]
    pay2 = sh.arrays[2:]

    # 3: local stable sort; slots that are slab-padding or invalid go last
    k3 = jnp.where(sh.valid & valid2, k2, _U64_MAX)
    order = jnp.argsort(k3, stable=True)
    out_valid = (sh.valid & valid2)[order]
    return k2[order], out_valid, tuple(p[order] for p in pay2), \
        sh.overflow


# ---- skew-aware join (BASELINE config 5: Zipf keys) ---------------------------

def local_heavy_keys(key: jnp.ndarray, valid: jnp.ndarray,
                     heavy_cap: int, min_count: jnp.ndarray):
    """Top-`heavy_cap` locally heavy keys (count >= min_count), from the
    local key histogram (sort + per-row run count via two binary
    searches).  Padded with the u64 sentinel."""
    k = jnp.where(valid, key, _U64_MAX)
    ks = jnp.sort(k)
    cnt = (jnp.searchsorted(ks, ks, side="right")
           - jnp.searchsorted(ks, ks, side="left")).astype(jnp.int32)
    run_start = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 ks[1:] != ks[:-1]])
    cand = run_start & (ks != _U64_MAX) & (cnt >= min_count)
    # heaviest first: sort by count descending among candidates
    rank_key = jnp.where(cand, jnp.int32(-1) * cnt, jnp.int32(1))
    order = jnp.argsort(rank_key, stable=True)
    heavy = jnp.where(cand[order], ks[order], _U64_MAX)[:heavy_cap]
    return heavy


def _compact_front(mask: jnp.ndarray, cap: int, *arrays: jnp.ndarray):
    """Rows where mask, packed to the front (stable), sliced to cap;
    returns (kept_valid (cap,), arrays' (cap,))."""
    order = jnp.argsort(~mask, stable=True)
    kept = mask[order][:cap]
    return kept, tuple(a[order][:cap] for a in arrays)


def dist_join_skew(axis: str,
                   probe_key, probe_valid, probe_vals: Sequence,
                   build_key, build_valid, build_vals: Sequence,
                   probe_cap: int, build_cap: int,
                   heavy_cap: int = 64, build_heavy_cap: int = 256,
                   heavy_min_frac: float = 1.0 / 64):
    """Skew-aware FK join (unique build keys), shard_map body.

    Heavy probe keys (detected from per-shard histograms, agreed via
    all_gather) would overflow a hash-routed shard, so their build rows
    are REPLICATED to every shard and their probe rows stay local (no
    shuffle at all — the hottest keys move zero probe bytes); light keys
    take the normal co-shuffled path (dist_join_unique).  This is the
    heavy-hitter split the survey prescribes for the Zipf workload
    (SURVEY.md §7 hard-part (e)).

    Returns (light_result, heavy_result):
      light_result = dist_join_unique output over the light rows
      heavy_result = (match_valid, [build vals]) aligned with the LOCAL
                     probe rows (heavy rows only; others masked out)
    """
    n = probe_key.shape[0]
    min_count = jnp.int32(max(int(n * heavy_min_frac), 2))

    heavy_local = local_heavy_keys(probe_key, probe_valid, heavy_cap,
                                   min_count)
    heavy_all = jnp.sort(jax.lax.all_gather(heavy_local, axis)
                         .reshape(-1))

    def is_heavy(k, valid):
        pos = jnp.clip(jnp.searchsorted(heavy_all, k), 0,
                       heavy_all.shape[0] - 1)
        return valid & (heavy_all[pos] == k) & (k != _U64_MAX)

    ph = is_heavy(probe_key, probe_valid)
    bh = is_heavy(build_key, build_valid)

    # light path: the standard co-shuffled join
    light = dist_join_unique(axis, probe_key, probe_valid & ~ph,
                             probe_vals, build_key, build_valid & ~bh,
                             build_vals, probe_cap, build_cap)

    # heavy path: replicate heavy build rows everywhere, probe locally
    kept, packed = _compact_front(bh, build_heavy_cap, build_key,
                                  *build_vals)
    heavy_over = jnp.sum(bh, dtype=jnp.int32) > build_heavy_cap
    heavy_over = jax.lax.psum(heavy_over.astype(jnp.int32), axis) > 0
    rep = [jax.lax.all_gather(a, axis).reshape(-1)
           for a in (packed[0], kept) + packed[1:]]
    rep_key, rep_valid, rep_vals = rep[0], rep[1], rep[2:]
    hit_h, got_h = _local_lookup_unique(probe_key, ph, rep_key,
                                        rep_valid, rep_vals)
    return light, (hit_h, got_h, heavy_over)
