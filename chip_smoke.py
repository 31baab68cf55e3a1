#!/usr/bin/env python3
"""Smoke test: the engine's query path on a GPU, checked against numpy.

    python chip_smoke.py [--seed S]           # one GPU, every phase
    python chip_smoke.py --multi [--seed S]   # four GPUs, parallel/ only

Every phase makes its data from --seed, runs it through the entry points
a user calls (the Table/compute API, fuse, sql.execute_sql, the parquet
writer and reader, parallel.dist_*), and compares each result with a
plain numpy reference on the same data:

  * integer, count, order and index results must match bit for bit;
  * a float64 sum must agree within 1e-9 * sum(|y|) over the finite
    values of its column.  The engine's group sums are differences of
    whole-column prefix sums, so their rounding error scales with the
    column, not with the group.  Non-finite sums (NaN, +-inf) must match
    exactly.

A failed comparison raises, and the script exits non-zero.  It also
exits non-zero, before printing any result, when JAX finds no GPU.
Results are read back as numpy arrays; the path imports no pyarrow.
Each phase prints its wall time and the device's peak memory; the last
line is one JSON object naming the device.  The phase functions take
their sizes as arguments, so tests can run them small on the CPU.
"""

from __future__ import annotations

import argparse
import calendar
import datetime
import decimal
import io
import json
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

FLOAT_SUM_RTOL = 1e-9
_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_MIX = np.uint64(0x9E3779B97F4A7C15)


@dataclass(frozen=True)
class Sizes:
    """Row counts of one run.  The defaults are the single-card sizes:
    configs 3 and 5 hold about 4 GB of fact table on the device."""
    fact: int = 100_000_000        # fact table rows
    dim: int = 10_000_000          # dimension (join build) rows
    parquet: int = 10_000_000      # rows written to and read from parquet
    small: int = 10_000_000        # config1 / config2 / float sort / sql
    k1_groups: int = 10_000_000    # distinct k1 keys (wide domain)
    k2_groups: int = 1_000         # dictionary entries of k2


@dataclass(frozen=True)
class MultiSizes:
    rows: int = 200_000_000        # rows of the distributed tables
    keys: int = 10_000_000         # key domain of the group-bys
    build: int = 20_000_000        # join build side rows
    dict_size: int = 1_000         # second sort key's dictionary


class SmokeFailure(AssertionError):
    pass


def _check(cond, what: str) -> None:
    if not bool(cond):
        raise SmokeFailure(what)


def _equal(got, want, what: str) -> None:
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    _check(got.shape == want.shape,
           f"{what}: shape {got.shape} != {want.shape}")
    if got.dtype.kind == "f":      # bit for bit, NaN payloads included
        got = got.view(f"u{got.dtype.itemsize}")
        want = want.astype(got.dtype.str.replace("u", "f")) \
            .view(got.dtype)
    bad = np.flatnonzero(got != want)
    _check(bad.size == 0,
           f"{what}: {bad.size} mismatches, first at {bad[:3]}: "
           f"{got[bad[:3]]} != {want[bad[:3]]}")


def _float_sums_close(got, want, col, what: str) -> None:
    """Float sums: non-finite classes exact, finite values within
    FLOAT_SUM_RTOL * sum(|finite values of the column|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _check(got.shape == want.shape, f"{what}: shape mismatch")
    fin = np.isfinite(want)
    _equal(np.isnan(got), np.isnan(want), f"{what} NaN")
    _equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)],
           f"{what} inf")
    col = np.asarray(col, np.float64)
    bound = FLOAT_SUM_RTOL * np.abs(col[np.isfinite(col)]).sum()
    err = np.abs(got[fin] - want[fin])
    _check(err.size == 0 or err.max() <= bound,
           f"{what}: max error {err.max() if err.size else 0} > {bound}")


def _check_stable_order(composite, idx, what: str) -> None:
    """`idx` is THE stable ascending argsort of `composite`: it is a
    permutation, keys never decrease along it, and equal keys keep their
    original row order."""
    idx = np.asarray(idx).astype(np.int64)
    n = composite.shape[0]
    _check(idx.shape == (n,), f"{what}: {idx.shape} indices for {n} rows")
    _check(np.bincount(idx, minlength=n).max(initial=1) == 1
           and (idx.min(initial=0) >= 0) and (idx.max(initial=0) < n),
           f"{what}: not a permutation")
    k = composite[idx]
    step = np.diff(k)
    _check((step >= 0).all(), f"{what}: keys decrease")
    _check((np.diff(idx)[step == 0] > 0).all(),
           f"{what}: ties out of row order")


def _host(x):
    return np.asarray(x)


def _valid(col):
    return _host(col.is_valid_mask())


# ---------------------------------------------------------------------------
# data

def make_fact(sizes: Sizes, seed: int) -> dict:
    """Host arrays of the fact table, its dimension table and the join's
    Zipf probe keys."""
    rng = np.random.default_rng(seed)
    n = sizes.fact
    kid = rng.integers(0, sizes.k1_groups, n)
    words = [f"key-{p:05d}" for p in rng.permutation(sizes.k2_groups)]
    y = rng.normal(0.0, 1000.0, n)
    m = max(4, n // 2_000_000)
    for special in (np.nan, np.inf, -np.inf, 0.0, -0.0):
        y[rng.integers(0, n, m)] = special
    perm = rng.permutation(sizes.dim)
    zipf = rng.zipf(1.2, n)
    return {
        "kid": kid,
        "k1": kid * 1_000_003 + 17,              # wide key domain
        "k2": rng.integers(0, sizes.k2_groups, n).astype(np.int32),
        "words": words,
        "v": rng.integers(-10**9, 10**9, n),
        "v_ok": rng.random(n) >= 0.1,            # 10% nulls
        "y": y,
        "ts": rng.integers(1_500_000_000_000_000, 1_800_000_000_000_000,
                           n),
        "perm": perm,
        "dk": perm.astype(np.int64) * 2 + 1,     # unique, odd
        "dw": rng.integers(-10**6, 10**6, sizes.dim),
        # Zipf ranks: rank r <= dim hits build key 2(r-1)+1, others miss
        "pk": np.where(zipf <= sizes.dim, 2 * (zipf - 1) + 1,
                       2 * zipf).astype(np.int64),
    }


def _rank_of(words):
    """Code -> rank of its string in sorted order."""
    rank = np.empty(len(words), np.int64)
    rank[np.argsort(np.array(words))] = np.arange(len(words))
    return rank


# ---------------------------------------------------------------------------
# phases (one card)

def phase_ingest(sizes: Sizes, seed: int) -> dict:
    """Build the fact and dimension tables on the device; round-trip a
    slice through the native parquet writer and reader (snappy)."""
    import arrow_tpu as at
    from arrow_tpu.io.parquet_io import (WriterProperties, read_parquet,
                                         write_parquet)
    h = make_fact(sizes, seed)
    fact = at.Table.from_pydict({
        "k1": at.column(h["k1"]),
        "k2": at.DictionaryColumn(at.column(h["k2"]).values,
                                  at.column(h["words"])),
        "v": at.column(h["v"], validity=h["v_ok"]),
        "y": at.column(h["y"]),
        "ts": at.column(h["ts"], dtype=at.timestamp("us")),
    })
    dim = at.Table.from_pydict({"dk": at.column(h["dk"]),
                                "dw": at.column(h["dw"])})
    _equal(_host(fact.column("k1").values), h["k1"], "ingest k1")
    _equal(_host(fact.column("k2").codes), h["k2"], "ingest k2")
    _equal(_valid(fact.column("v")), h["v_ok"], "ingest v validity")
    _equal(np.where(h["v_ok"], _host(fact.column("v").values), 0),
           np.where(h["v_ok"], h["v"], 0), "ingest v")
    _equal(_host(fact.column("y").values), h["y"], "ingest y")
    _equal(_host(fact.column("ts").values), h["ts"], "ingest ts")
    _equal(_host(dim.column("dk").values), h["dk"], "ingest dk")

    part = fact.slice(0, sizes.parquet)
    buf = io.BytesIO()
    write_parquet(buf, part, WriterProperties(compression="snappy"))
    back = read_parquet(io.BytesIO(buf.getvalue()))
    p = sizes.parquet
    _check(back.num_rows == p, "parquet row count")
    _check([str(f.dtype) for f in back.schema.fields]
           == [str(f.dtype) for f in part.schema.fields],
           f"parquet schema {back.schema} != {part.schema}")
    _equal(_host(back.column("k1").values), h["k1"][:p], "parquet k1")
    k2 = back.column("k2")
    index = {w: i for i, w in enumerate(h["words"])}
    lut = np.array([index[w] for w in k2.values.to_pylist_host()],
                   np.int64)
    _equal(lut[_host(k2.codes)], h["k2"][:p], "parquet k2")
    _equal(_valid(back.column("v")), h["v_ok"][:p], "parquet v validity")
    ok = h["v_ok"][:p]
    _equal(_host(back.column("v").values)[ok], h["v"][:p][ok], "parquet v")
    _equal(_host(back.column("y").values), h["y"][:p], "parquet y")
    _equal(_host(back.column("ts").values), h["ts"][:p], "parquet ts")
    return {"host": h, "fact": fact, "dim": dim, "sizes": sizes,
            "seed": seed}


def phase_filter(ctx: dict) -> None:
    """config1 (WHERE x > 0: sum(y * 2 + x), count) through fuse, and
    filter_table over four columns of the fact table."""
    import jax.numpy as jnp
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    n = ctx["sizes"].small
    rng = np.random.default_rng(ctx["seed"] + 1)
    x_h = rng.integers(-1000, 1000, n)
    y_h = rng.random(n)

    @at.fuse
    def config1(x, y):
        keep = ops.gt(x, 0)
        z = ops.add(ops.mul(y, 2.0), ops.cast(x, at.float64))
        return (jnp.sum(jnp.where(keep.values, z.values, 0.0)),
                jnp.sum(keep.values, dtype=jnp.int64))

    total, count = config1(at.column(x_h), at.column(y_h))
    keep = x_h > 0
    z = y_h[keep] * 2.0 + x_h[keep]
    _equal(_host(count), keep.sum(), "config1 count")
    _float_sums_close(_host(total)[None], z.sum()[None], z,
                      "config1 sum")

    h = ctx["host"]
    t = ctx["fact"].slice(0, n)
    t = t.select(["k1", "v", "y", "ts"])
    out = ops.filter_table(t, ops.gt(t.column("v"), 0))
    keep = h["v_ok"][:n] & (h["v"][:n] > 0)
    _check(out.num_rows == keep.sum(), "filter_table row count")
    for name in ("k1", "v", "y", "ts"):
        _equal(_host(out.column(name).values), h[name][:n][keep],
               f"filter_table {name}")
    _equal(_valid(out.column("v")), np.ones(keep.sum(), bool),
           "filter_table v validity")


def phase_cast_cmp(n: int, seed: int) -> None:
    """config2: casts and comparisons over Int32 (10% nulls),
    Dictionary<Utf8> and Timestamp, eager and through fuse."""
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    rng = np.random.default_rng(seed + 2)
    i32_h = rng.integers(-2**31, 2**31, n).astype(np.int32)
    ok = rng.random(n) > 0.1
    ts_h = rng.integers(0, 2**40, n)
    codes_h = rng.integers(0, 1000, n).astype(np.int32)
    words = at.column([f"word-{i:04d}" for i in range(1000)])
    i32 = at.column(i32_h, validity=ok)
    ts = at.column(ts_h, dtype=at.timestamp("us"))
    codes = at.column(codes_h).values

    def query(i32, ts, codes):
        dc = at.DictionaryColumn(codes, words)
        a = ops.cast(i32, at.int64)
        b = ops.cast(i32, at.float64)
        c = ops.cast(ts, at.timestamp("ns"))
        return (a, b, c, ops.lt(b, ops.cast(a, at.float64)),
                ops.eq(dc, "word-0042"), ops.gt_eq(c, c))

    for how, fn in (("eager", query), ("fused", at.fuse(query))):
        a, b, c, m1, m2, m3 = fn(i32, ts, codes)
        _equal(_host(a.values)[ok], i32_h[ok].astype(np.int64),
               f"{how} cast i32->i64")
        _equal(_valid(a), ok, f"{how} cast validity")
        _equal(_host(b.values)[ok], i32_h[ok].astype(np.float64),
               f"{how} cast i32->f64")
        _equal(_host(c.values), ts_h * 1000, f"{how} cast us->ns")
        _equal(_host(m1.values)[ok], np.zeros(ok.sum(), bool),
               f"{how} lt")
        _equal(_valid(m1), ok, f"{how} lt validity")
        _equal(_host(m2.values), codes_h == 42, f"{how} dict eq")
        _equal(_host(m3.values), np.ones(n, bool), f"{how} gt_eq")


def phase_sort(ctx: dict) -> None:
    """Two-key lexsort (k1 ascending, k2 descending nulls first) over
    the fact table, and a float64 sort with NaN, +-0 and +-inf."""
    from arrow_tpu import compute as ops
    h = ctx["host"]
    fact = ctx["fact"]
    idx = ops.lexsort_to_indices([
        ops.SortColumn(fact.column("k1")),
        ops.SortColumn(fact.column("k2"),
                       ops.SortOptions(descending=True, nulls_first=True))])
    nw = len(h["words"])
    composite = h["kid"] * nw + (nw - 1 - _rank_of(h["words"])[h["k2"]])
    _check_stable_order(composite, _host(idx.values), "lexsort k1, k2")
    del idx

    n = ctx["sizes"].small
    idx = ops.sort_to_indices(fact.column("y").slice(0, n))
    # numpy orders NaN last and ties -0.0 with +0.0, like the engine
    _equal(_host(idx.values).astype(np.int64),
           np.argsort(h["y"][:n], kind="stable"), "float64 sort")


def _group_ref(gid, n_groups, v, v_ok, y):
    """Per-group count_all/count/sum/min/max of v and sum of y."""
    vz = np.where(v_ok, v, 0)
    ref = {"count_all": np.bincount(gid, minlength=n_groups),
           "count": np.bincount(gid, v_ok, minlength=n_groups)
           .astype(np.int64),
           # |partial sums| < 2^53: float64 accumulation is exact here
           "sum": np.bincount(gid, vz.astype(np.float64),
                              minlength=n_groups).astype(np.int64),
           "min": np.full(n_groups, _I64_MAX),
           "max": np.full(n_groups, _I64_MIN)}
    np.minimum.at(ref["min"], gid, np.where(v_ok, v, _I64_MAX))
    np.maximum.at(ref["max"], gid, np.where(v_ok, v, _I64_MIN))
    if y is not None:
        ref["y_sum"] = np.bincount(gid, y, minlength=n_groups)
    return ref


def _check_group_aggs(out, ref, present, what: str, y=None) -> None:
    cnt = ref["count"][present]
    _equal(_host(out.column("v_count").values), cnt, f"{what} count")
    has = cnt > 0
    for op in ("sum", "min", "max"):
        col = out.column(f"v_{op}")
        _equal(_valid(col), has, f"{what} {op} validity")
        _equal(_host(col.values)[has], ref[op][present][has],
               f"{what} {op}")
    mean = out.column("v_mean")
    _equal(_valid(mean), has, f"{what} mean validity")
    want = ref["sum"][present][has].astype(np.float64) / cnt[has]
    got = _host(mean.values)[has]
    # mean = exact integer sum / exact count: two ulps of slack for the
    # device's division
    _check(np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want))),
           f"{what} mean")
    if y is not None:
        _float_sums_close(_host(out.column("y_sum").values),
                          ref["y_sum"][present], y, f"{what} y sum")


def phase_group_by(ctx: dict) -> None:
    """GROUP BY k2 (dictionary, k2_groups groups) and k1 (wide int,
    k1_groups groups) with sum, count, min, max and mean of v, plus the
    float sum of y; then the same integer aggregates over dense keys."""
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    h = ctx["host"]
    fact = ctx["fact"]
    vaggs = [ops.AggSpec("v", op) for op in
             ("sum", "count", "min", "max", "mean")]

    nw = len(h["words"])
    rank = _rank_of(h["words"])
    ref = _group_ref(rank[h["k2"]], nw, h["v"], h["v_ok"], h["y"])
    present = np.flatnonzero(ref["count_all"])
    out = ops.group_by(fact, ["k2"], vaggs)
    _equal(rank[_host(out.column("k2").codes)], present, "group k2 keys")
    _check_group_aggs(out, ref, present, "group k2")
    out = ops.group_by(fact, ["k2"], [ops.AggSpec("y", "sum")])
    _equal(rank[_host(out.column("k2").codes)], present, "group k2 keys")
    _float_sums_close(_host(out.column("y_sum").values),
                      ref["y_sum"][present], h["y"], "group k2 y sum")
    del out

    ng = ctx["sizes"].k1_groups
    ref = _group_ref(h["kid"], ng, h["v"], h["v_ok"], h["y"])
    present = np.flatnonzero(ref["count_all"])
    out = ops.group_by(fact, ["k1"], vaggs + [ops.AggSpec("y", "sum")])
    _equal(_host(out.column("k1").values), present * 1_000_003 + 17,
           "group k1 keys")
    _check_group_aggs(out, ref, present, "group k1", h["y"])
    del out

    # config4's high-cardinality shape: dense int keys and a narrow
    # non-null value pack into one u64 sort operand (the packed plan)
    w = np.abs(h["v"]) % 1000
    t = at.Table.from_pydict({"kid": at.column(h["kid"]),
                              "v": at.column(w)})
    ref = _group_ref(h["kid"], ng, w, np.ones_like(h["v_ok"]), None)
    out = ops.group_by(t, ["kid"], vaggs)
    _equal(_host(out.column("kid").values), present, "group packed keys")
    _check_group_aggs(out, ref, present, "group packed")


def _join_checksum(pk, v, v_ok, dw) -> np.uint64:
    with np.errstate(over="ignore"):
        return (pk.astype(np.uint64) * _MIX
                + dw.astype(np.uint64) * np.uint64(31)
                + np.where(v_ok, v, 7).astype(np.uint64)).sum(
                    dtype=np.uint64)


def phase_join(ctx: dict) -> None:
    """Inner join of fact-sized Zipf probe keys against the dimension
    table: match count and an order-free checksum of the pairs."""
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    h = ctx["host"]
    probe = at.Table.from_pydict({"pk": at.column(h["pk"]),
                                  "v": ctx["fact"].column("v")})
    out = ops.join(probe, ctx["dim"], ["pk"], right_on=["dk"])
    inv = np.argsort(h["perm"])
    hit = h["pk"] % 2 == 1
    brow = inv[(h["pk"][hit] - 1) // 2]
    _check(out.num_rows == hit.sum(),
           f"join matches {out.num_rows} != {hit.sum()}")
    got = _join_checksum(_host(out.column("pk").values),
                         _host(out.column("v").values),
                         _valid(out.column("v")),
                         _host(out.column("dw").values))
    want = _join_checksum(h["pk"][hit], h["v"][hit], h["v_ok"][hit],
                          h["dw"][brow])
    _check(got == want, f"join checksum {got} != {want}")


def phase_sql(ctx: dict) -> None:
    """execute_sql of a WHERE ... GROUP BY ... ORDER BY query."""
    import arrow_tpu as at
    from arrow_tpu.sql import execute_sql
    h = ctx["host"]
    n = ctx["sizes"].small
    t = at.Table.from_pydict({
        "g": at.column(h["k2"][:n]),
        "v": ctx["fact"].column("v").slice(0, n),
        "y": ctx["fact"].column("y").slice(0, n)})
    out = execute_sql({"t": t}, "SELECT g, SUM(v) AS s, COUNT(*) AS c, "
                                "MAX(v) AS hi FROM t WHERE y > 0 "
                                "GROUP BY g ORDER BY g DESC")
    sel = h["y"][:n] > 0
    ref = _group_ref(h["k2"][:n][sel], len(h["words"]), h["v"][:n][sel],
                     h["v_ok"][:n][sel], None)
    present = np.flatnonzero(ref["count_all"])[::-1]
    _equal(_host(out.column("g").values), present, "sql keys")
    _equal(_host(out.column("c").values), ref["count_all"][present],
           "sql count")
    has = ref["count"][present] > 0
    _equal(_valid(out.column("s")), has, "sql sum validity")
    _equal(_host(out.column("s").values)[has], ref["sum"][present][has],
           "sql sum")
    _equal(_host(out.column("hi").values)[has], ref["max"][present][has],
           "sql max")


def _add_months_us(ts_us: int, months: int, days: int, nanos: int) -> int:
    d = datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=ts_us)
    y, m = divmod(d.month - 1 + months, 12)
    y, m = d.year + y, m + 1
    d = d.replace(year=y, month=m,
                  day=min(d.day, calendar.monthrange(y, m)[1]))
    d += datetime.timedelta(days=days, microseconds=nanos // 1000)
    return (d - datetime.datetime(1970, 1, 1)) // \
        datetime.timedelta(microseconds=1)


def phase_op_audit(n: int, seed: int) -> None:
    """Every op family once, each against a numpy or exact Python
    reference.  Decimal, interval and run-end inputs come from the
    engine's own builders."""
    import importlib
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    from arrow_tpu.core.builders import Decimal128Builder, Decimal256Builder
    from arrow_tpu.core.nested import IntervalMDNColumn
    mod = {m: importlib.import_module(f"arrow_tpu.ops.{m}") for m in (
        "numeric", "cmp", "boolean", "aggregate", "cast", "sort",
        "filter", "take", "concat", "select_misc", "temporal", "strings",
        "bitwise", "join", "groupby", "ree", "row_format")}
    rng = np.random.default_rng(seed + 3)
    i64_h = rng.integers(-10**9, 10**9, n)
    i64_ok = rng.random(n) > 0.1
    f64_h = rng.normal(0, 100, n)
    f64n_ok = rng.random(n) > 0.1
    b_h = rng.random(n) < 0.5
    s_h = [f"w{i % 37}" for i in range(n)]
    ts_h = rng.integers(0, 2**40, n)
    i64 = at.column(i64_h, validity=i64_ok)
    f64 = at.column(f64_h)
    f64n_h = np.where(f64n_ok, f64_h[::-1], 0.0)    # nulls hold zero
    f64n = at.column(f64n_h, validity=f64n_ok)
    b = at.column(b_h)
    s = at.column(s_h)
    ts = at.column(ts_h, dtype=at.timestamp("us"))
    days = ts_h // 86_400_000_000

    def vals(col, ok=None):
        v = _host(col.values)
        return v if ok is None else v[ok]

    numeric, cmp, cast = mod["numeric"], mod["cmp"], mod["cast"]
    _equal(vals(numeric.add(i64, i64), i64_ok), 2 * i64_h[i64_ok], "add")
    _equal(vals(numeric.mul(f64, f64)), f64_h * f64_h, "mul f64")
    both = f64n_ok
    _equal(vals(numeric.div(f64n, f64), both), (f64n_h / f64_h)[both],
           "div f64")
    _equal(vals(cmp.lt(f64, f64n), both), (f64_h < f64n_h)[both], "lt f64")
    _equal(vals(mod["strings"].compare("eq", s, s)), np.ones(n, bool),
           "eq utf8")
    _equal(vals(mod["boolean"].and_kleene(b, b)), b_h, "and_kleene")
    _float_sums_close(np.float64(mod["aggregate"].sum_(f64).value)[None],
                      f64_h.sum()[None], f64_h, "sum f64")
    lo, hi = mod["aggregate"].min_max(f64n)
    _check((lo.value, hi.value) == (f64n_h[both].min(), f64n_h[both].max()),
           "min_max f64")
    _equal(vals(cast.cast(i64, at.float64), i64_ok),
           i64_h[i64_ok].astype(np.float64), "cast i64->f64")
    _equal(vals(cast.cast(at.column(np.round(f64_h)), at.int32)),
           np.round(f64_h).astype(np.int32), "cast f64->i32")
    txt = cast.cast(i64, at.utf8).to_pylist_host()
    _check(txt == [str(x) if o else None for x, o in zip(i64_h, i64_ok)],
           "cast i64->utf8")
    back = cast.cast(at.column(["1", "2", "x"]), at.int64)
    _check(vals(back)[:2].tolist() == [1, 2]
           and _valid(back).tolist() == [True, True, False],
           "cast utf8->i64")
    _equal(vals(cast.cast(ts, at.date32)), days, "cast ts->date32")

    sortm = mod["sort"]
    desc = sortm.sort(f64n, ops.SortOptions(descending=True,
                                            nulls_first=False))
    k = int(both.sum())
    _equal(vals(desc)[:k], np.sort(f64n_h[both])[::-1], "sort f64 desc")
    _equal(_valid(desc), np.arange(n) < k, "sort f64 nulls last")
    idx = sortm.lexsort_to_indices([ops.SortColumn(i64),
                                    ops.SortColumn(f64)])
    # nulls first: (valid, value, f64) ascending
    _equal(vals(idx).astype(np.int64),
           np.lexsort((f64_h, np.where(i64_ok, i64_h, 0), i64_ok)),
           "lexsort i64, f64")
    srt = np.sort(f64n_h[both])
    rank_ref = np.where(both, (~both).sum()
                        + np.searchsorted(srt, f64n_h, side="right"),
                        (~both).sum())
    _equal(_host(sortm.rank(f64n)).astype(np.int64), rank_ref, "rank f64")
    runs = np.sort(rng.integers(0, 5, n)).astype(np.float64)
    parts = sortm.partition([at.column(runs)])
    _equal(parts.boundaries, np.r_[0, np.flatnonzero(np.diff(runs)) + 1, n],
           "partition")
    top = sortm.sort_to_indices(i64, limit=64)
    _equal(vals(top).astype(np.int64),
           np.lexsort((np.where(i64_ok, i64_h, 0), i64_ok))[:64],
           "top-k")

    kept = mod["filter"].filter(f64n, b)
    _equal(_valid(kept), f64n_ok[b_h], "filter validity")
    _equal(vals(kept, f64n_ok[b_h]), f64n_h[b_h & f64n_ok], "filter f64")
    taken = mod["take"].take(s, at.column(np.arange(100, dtype=np.int64)))
    _check(taken.to_pylist_host() == s_h[:100], "take utf8")
    cat = mod["concat"].concat([f64, f64n])
    _equal(vals(cat), np.r_[f64_h, f64n_h], "concat")
    _equal(_valid(cat), np.r_[np.ones(n, bool), f64n_ok], "concat validity")
    inter = mod["concat"].interleave([i64, i64], [(0, 1), (1, 2)])
    _equal(vals(inter), i64_h[[1, 2]], "interleave")
    sm = mod["select_misc"]
    _equal(vals(sm.zip_(b, i64, at.column(-i64_h)), i64_ok),
           np.where(b_h, i64_h, -i64_h)[i64_ok], "zip")
    sh = sm.shift(i64, 3)
    _equal(_valid(sh), np.r_[np.zeros(3, bool), i64_ok[:-3]], "shift")
    temporal = mod["temporal"]
    _equal(vals(temporal.year(ts)),
           days.astype("datetime64[D]").astype("datetime64[Y]")
           .astype(np.int64) + 1970, "year")
    # a fixed offset: named zones read the host's tzdata
    tz = at.column(ts_h, dtype=at.timestamp("us", "+05:30"))
    _equal(vals(temporal.hour(tz)),
           ((ts_h + 19_800_000_000) // 3_600_000_000) % 24, "hour +05:30")
    iso = [datetime.date.fromordinal(719163 + int(d)).isocalendar()[1]
           for d in days]
    _equal(vals(temporal.iso_week(ts)), iso, "iso_week")
    strings = mod["strings"]
    _equal(vals(strings.like(s, "w1%")), [w.startswith("w1") for w in s_h],
           "like")
    _check(strings.substring(s, 1, 2).to_pylist_host()
           == [w[1:3] for w in s_h], "substring")
    _equal(vals(mod["bitwise"].bitwise_and(i64, at.column(i64_h ^ 0xFF)),
                i64_ok), (i64_h & (i64_h ^ 0xFF))[i64_ok], "bitwise_and")
    rowf = mod["row_format"]
    conv = rowf.RowConverter([rowf.SortField()])
    rt = conv.convert_rows(conv.convert_columns([f64n]), [f64n])[0]
    _equal(vals(rt, both), f64n_h[both], "row format round trip")
    _equal(_valid(rt), f64n_ok, "row format validity")

    keys_h = rng.integers(0, 50, n)
    tl = at.Table.from_pydict({"k": at.column(keys_h), "v": f64})
    tr = at.Table.from_pydict({"k": at.column(np.arange(0, 60, 2)),
                               "w": at.column(np.arange(30) * 10)})
    j = mod["join"].join(tl, tr, ["k"])
    hit = keys_h % 2 == 0
    _check(j.num_rows == hit.sum(), "join int keys count")
    _equal(np.sort(vals(j.column("w"))), np.sort(keys_h[hit] * 5),
           "join int keys")
    tfl = at.Table.from_pydict({"k": at.column(keys_h * 1.5), "v": i64})
    tfr = at.Table.from_pydict({"k": at.column(np.arange(9) * 1.5),
                                "w": at.column(np.arange(9))})
    jf = mod["join"].join(tfl, tfr, ["k"])
    _equal(np.sort(vals(jf.column("w"))), np.sort(keys_h[keys_h < 9]),
           "join float keys")
    gbm = mod["groupby"]
    g = gbm.group_by(tl, ["k"], [gbm.AggSpec("v", "mean"),
                                 gbm.AggSpec("v", "sum")])
    ks = np.unique(keys_h)
    _equal(vals(g.column("k")), ks, "group_by f64 keys")
    ysum = np.bincount(keys_h, f64_h)[ks]
    _float_sums_close(vals(g.column("v_sum")), ysum, f64_h,
                      "group_by f64 sum")
    _float_sums_close(vals(g.column("v_mean")) * np.bincount(keys_h)[ks],
                      ysum, f64_h, "group_by f64 mean")

    d256 = Decimal256Builder(50, 2)
    for x in (125, None, 10**32):                # 1.25, null, 1e30
        d256.append(x)
    dec = d256.finish()
    d128 = Decimal128Builder(38, 1)
    for x in (13, 0, -10):                       # 1.3, 0, -1
        d128.append(x)
    dec2 = d128.finish()
    _equal(vals(sortm.sort_to_indices(dec)), [1, 0, 2], "decimal sort")
    lt = cmp.lt(dec, dec2)
    _check(_valid(lt).tolist() == [True, False, True]
           and vals(lt)[[0, 2]].tolist() == [True, False], "decimal cmp")
    _check(numeric.add(dec, dec2).to_pyints() == [255, None, 10**32 - 100],
           "decimal add")
    _check(mod["aggregate"].sum_(dec).as_py()
           == decimal.Decimal(10**32 + 125).scaleb(-2), "decimal sum")
    iv = IntervalMDNColumn(at.column(np.ones(n, np.int32)).values,
                           at.column(np.full(n, 2, np.int32)).values,
                           at.column(np.full(n, 3_600_000_000_000)).values)
    shifted = vals(temporal.add_interval(ts, iv))
    want = [_add_months_us(int(t), 1, 2, 3_600_000_000_000)
            for t in ts_h[:200]]
    _equal(shifted[:200], want, "add_interval")
    ree = mod["ree"].run_end_encode(at.column(np.array([7, 7, 3, 3, 3])))
    _equal(vals(sortm.sort_to_indices(ree)), [2, 3, 4, 0, 1], "ree sort")


# ---------------------------------------------------------------------------
# four cards

def _hash_dest(keys_u64, n_shards: int) -> np.ndarray:
    """Destination shard of each key under the shuffle's hash (the
    splitmix64 finalizer of parallel.partition.hash_u64)."""
    x = keys_u64.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return ((x ^ (x >> np.uint64(31))) % np.uint64(n_shards)) \
        .astype(np.int64)


def _pair_cap(dest, ok, n_shards: int) -> int:
    """Largest row count one source shard sends one destination."""
    src = np.arange(dest.shape[-1]) * n_shards // dest.shape[-1]
    cell = (src * n_shards + dest)[ok]
    return int(np.bincount(cell, minlength=n_shards ** 2).max()) + 1


def phase_multi(sizes: MultiSizes, seed: int, n_dev: int = 4) -> None:
    """parallel/ over a 1-D mesh of n_dev devices: dist_table_group_by,
    dist_group_by_stream, dist_join with Zipf probe keys and a two-key
    dist_table_sort, each against numpy and against the one-card API."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    from arrow_tpu import parallel as par
    from arrow_tpu.parallel import dist

    _check(len(jax.devices()) >= n_dev,
           f"need {n_dev} devices, have {len(jax.devices())}")
    mesh = par.make_mesh(n_dev)
    axis = par.shard_axis(mesh)
    rng = np.random.default_rng(seed + 10)
    n = sizes.rows - sizes.rows % (n_dev * 4)
    kid = rng.integers(0, sizes.keys, n)
    k_h = kid * 7 + 3
    v_h = rng.integers(-10**6, 10**6, n)
    words = [f"d{p:04d}" for p in rng.permutation(sizes.dict_size)]
    d_h = rng.integers(0, sizes.dict_size, n).astype(np.int32)
    t = at.Table.from_pydict({
        "k": at.column(k_h), "v": at.column(v_h),
        "d": at.DictionaryColumn(at.column(d_h).values, at.column(words)),
        "row": at.column(np.arange(n))})
    ok_all = np.ones(n, bool)
    ref = _group_ref(kid, sizes.keys, v_h, ok_all, None)
    present = np.flatnonzero(ref["count_all"])
    aggs = [ops.AggSpec("v", op) for op in ("sum", "count", "min", "max")]

    # 1. dist_table_group_by vs numpy and the one-card group_by
    kv = t.select(["k", "v"])
    g = par.dist_table_group_by(kv, ["k"], aggs, mesh=mesh)
    _equal(_host(g.column("k").values), present * 7 + 3, "dist group keys")
    for op in ("sum", "count", "min", "max"):
        _equal(_host(g.column(f"v_{op}").values), ref[op][present],
               f"dist group {op}")
    one = ops.group_by(kv, ["k"], aggs)
    for c in ("k", "v_sum", "v_count", "v_min", "v_max"):
        _equal(_host(g.column(c).values), _host(one.column(c).values),
               f"dist vs one-card group {c}")
    del g, one

    # 2. dist_group_by_stream: C chunks per shard, exchange pipelined
    C = 4
    dest = _hash_dest(k_h, n_dev)
    kc = k_h.reshape(C, n // C)
    shuffle_cap = max(_pair_cap(dest.reshape(C, -1)[c], ok_all[:n // C],
                                n_dev) for c in range(C))
    group_cap = int(np.bincount(_hash_dest(present * 7 + 3, n_dev),
                                minlength=n_dev).max()) + 1
    spec_c = P(None, axis)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(spec_c,) * 3,
                       out_specs=(P(axis),) * 6 + (P(),))
    def stream(k, okk, v):
        gk, gv, outs, over = dist.dist_group_by_stream(
            axis, k, okk, shuffle_cap, group_cap,
            ["sum", "count", "min", "max"], [v] * 4)
        return (gk, gv) + tuple(outs) + (over,)

    res = [_host(x) for x in stream(
        jnp.asarray(kc.astype(np.uint64)),
        jnp.ones(kc.shape, jnp.bool_), jnp.asarray(v_h.reshape(C, -1)))]
    _check(not res[-1].any(), "dist_group_by_stream capacity overflow")
    gv = res[1]
    order = np.argsort(res[0][gv])
    _equal(res[0][gv][order].astype(np.int64), present * 7 + 3,
           "stream group keys")
    for op, got in zip(("sum", "count", "min", "max"), res[2:6]):
        _equal(got[gv][order], ref[op][present], f"stream group {op}")
    del res

    # 3. dist_join: Zipf probe keys against a unique build side
    nb = sizes.build - sizes.build % n_dev
    perm = rng.permutation(nb)
    bk_h = perm.astype(np.int64) * 2 + 1
    bw_h = rng.integers(-10**6, 10**6, nb)
    zipf = rng.zipf(1.2, n)
    pk_h = np.where(zipf <= nb, 2 * (zipf - 1) + 1, 2 * zipf) \
        .astype(np.int64)
    hit = pk_h % 2 == 1
    brow = np.argsort(perm)[(pk_h[hit] - 1) // 2]
    pdest = _hash_dest(pk_h, n_dev)
    probe_cap = _pair_cap(pdest, ok_all, n_dev)
    build_cap = _pair_cap(_hash_dest(bk_h, n_dev), np.ones(nb, bool), n_dev)
    out_cap = int(np.bincount(pdest[hit], minlength=n_dev).max()) + 1

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(axis),) * 6,
                       out_specs=(P(axis),) * 4 + (P(),))
    def join(pk, pok, pv, bk, bok, bw):
        ov, okey, (opv,), (obw,), over = dist.dist_join(
            axis, pk, pok, (pv,), bk, bok, (bw,), probe_cap, build_cap,
            out_cap)
        return ov, okey, opv, obw, over

    ov, okey, opv, obw, over = (_host(x) for x in join(
        jnp.asarray(pk_h.astype(np.uint64)), jnp.ones(n, jnp.bool_),
        jnp.asarray(v_h), jnp.asarray(bk_h.astype(np.uint64)),
        jnp.ones(nb, jnp.bool_), jnp.asarray(bw_h)))
    _check(not over.any(), "dist_join capacity overflow")
    want = _join_checksum(pk_h[hit], v_h[hit], ok_all[hit], bw_h[brow])
    _check(ov.sum() == hit.sum(), f"dist_join matches {ov.sum()}")
    _check(_join_checksum(okey[ov], opv[ov], ok_all[:ov.sum()], obw[ov])
           == want, "dist_join checksum")
    del ov, okey, opv, obw
    one = ops.join(at.Table.from_pydict({"pk": at.column(pk_h),
                                         "v": at.column(v_h)}),
                   at.Table.from_pydict({"bk": at.column(bk_h),
                                         "bw": at.column(bw_h)}),
                   ["pk"], right_on=["bk"])
    _check(one.num_rows == hit.sum()
           and _join_checksum(_host(one.column("pk").values),
                              _host(one.column("v").values),
                              ok_all[:one.num_rows],
                              _host(one.column("bw").values)) == want,
           "one-card join vs numpy")
    del one

    # 4. two-key dist_table_sort: k ascending, d descending
    opts = [ops.SortOptions(), ops.SortOptions(descending=True)]
    srt = par.dist_table_sort(t, ["k", "d"], opts, mesh=mesh)
    composite = kid * sizes.dict_size \
        + (sizes.dict_size - 1 - _rank_of(words)[d_h])
    rows = _host(srt.column("row").values)
    _check_stable_order(composite, rows, "dist_table_sort")
    _equal(_host(srt.column("v").values), v_h[rows], "dist sort payload")
    idx = ops.lexsort_to_indices([ops.SortColumn(t.column("k"), opts[0]),
                                  ops.SortColumn(t.column("d"), opts[1])])
    _equal(_host(idx.values).astype(np.int64), rows,
           "dist sort vs one-card lexsort")


# ---------------------------------------------------------------------------

def _memory_line(dev) -> str:
    stats = dev.memory_stats()
    if not stats:
        return "peak_bytes_in_use=not reported"
    return (f"peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
            f"bytes_in_use={stats.get('bytes_in_use')}")


def _run_phase(name: str, dev, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s "
          f"{_memory_line(dev)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card parallel/ phase")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU found (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    from arrow_tpu.config import enable_compile_cache
    from arrow_tpu.utils import native
    import jaxlib

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip())           # name, power limit: one card a line
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"compile cache {cache}")
    print(f"native hostcodec loaded: {native.available()}", flush=True)
    _check(native.available(), "native hostcodec library did not load")
    devs = jax.devices()
    dev = devs[0]
    t0 = time.perf_counter()
    if args.multi:
        _run_phase("multi", dev, phase_multi, MultiSizes(), args.seed)
        count = 4
    else:
        sizes = Sizes()
        ctx = _run_phase("ingest", dev, phase_ingest, sizes, args.seed)
        _run_phase("filter", dev, phase_filter, ctx)
        _run_phase("cast_cmp", dev, phase_cast_cmp, sizes.small, args.seed)
        _run_phase("sort", dev, phase_sort, ctx)
        _run_phase("group_by", dev, phase_group_by, ctx)
        _run_phase("join", dev, phase_join, ctx)
        _run_phase("sql", dev, phase_sql, ctx)
        _run_phase("op_audit", dev, phase_op_audit, 5000, args.seed)
        count = len(devs)
    print(f"total {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
