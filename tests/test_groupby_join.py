"""Hash aggregate + hash join goldens vs pyarrow (BASELINE configs 4-5
operators; composed from engine primitives per SURVEY.md §7 M5-M6)."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow_tpu as at
from arrow_tpu import compute as ops
from arrow_tpu.utils.bench_util import (create_primitive_array,
                                        create_string_array)


def _sorted_pydict(d):
    keys = list(d.keys())
    rows = list(zip(*[d[k] for k in keys]))
    rows.sort(key=lambda r: tuple((x is not None, x) for x in r))
    return {k: [r[i] for r in rows] for i, k in enumerate(keys)}


def test_group_by_golden_int_keys():
    n = 2000
    t_pa = pa.table({
        "k": create_primitive_array(n, 0.1, np.int64, lo=0, hi=50, seed=1),
        "v": create_primitive_array(n, 0.2, np.float64, seed=2),
        "w": create_primitive_array(n, 0.0, np.int64, lo=-10, hi=10, seed=3),
    })
    t = at.Table.from_pyarrow(t_pa)
    got = ops.group_by(t, ["k"], [
        ops.AggSpec("v", "sum"), ops.AggSpec("v", "count"),
        ops.AggSpec("w", "min"), ops.AggSpec("w", "max"),
        ops.AggSpec("v", "mean"),
    ])
    exp = t_pa.group_by("k").aggregate([
        ("v", "sum"), ("v", "count"), ("w", "min"), ("w", "max"),
        ("v", "mean"),
    ])
    g = _sorted_pydict(got.to_pydict())
    e = _sorted_pydict({
        "k": exp.column("k").to_pylist(),
        "v_sum": exp.column("v_sum").to_pylist(),
        "v_count": exp.column("v_count").to_pylist(),
        "w_min": exp.column("w_min").to_pylist(),
        "w_max": exp.column("w_max").to_pylist(),
        "v_mean": exp.column("v_mean").to_pylist(),
    })
    assert g["k"] == e["k"]
    assert g["v_count"] == e["v_count"]
    assert g["w_min"] == e["w_min"]
    assert g["w_max"] == e["w_max"]
    np.testing.assert_allclose(
        np.array(g["v_sum"], float), np.array(e["v_sum"], float), rtol=1e-12)
    np.testing.assert_allclose(
        np.array(g["v_mean"], float), np.array(e["v_mean"], float),
        rtol=1e-12)


def test_group_by_string_keys():
    t_pa = pa.table({
        "k": create_string_array(500, 0.1, cardinality=10, seed=4),
        "v": create_primitive_array(500, 0.0, np.int64, lo=0, hi=9, seed=5),
    })
    t = at.Table.from_pyarrow(t_pa)
    got = ops.group_by(t, ["k"], [ops.AggSpec("v", "sum"),
                                  ops.AggSpec("v", "count_all")])
    exp = t_pa.group_by("k").aggregate([("v", "sum"), ("v", "count",
                                                       pc.CountOptions(mode="all"))])
    g = _sorted_pydict(got.to_pydict())
    e = _sorted_pydict({"k": exp.column("k").to_pylist(),
                        "v_sum": exp.column("v_sum").to_pylist(),
                        "v_count_all": exp.column("v_count").to_pylist()})
    assert g == e


def test_group_by_multi_key():
    t_pa = pa.table({
        "a": create_primitive_array(800, 0.1, np.int64, lo=0, hi=4, seed=6),
        "b": create_primitive_array(800, 0.1, np.int64, lo=0, hi=4, seed=7),
        "v": create_primitive_array(800, 0.0, np.int64, lo=0, hi=99, seed=8),
    })
    t = at.Table.from_pyarrow(t_pa)
    got = ops.group_by(t, ["a", "b"], [ops.AggSpec("v", "sum")])
    exp = t_pa.group_by(["a", "b"]).aggregate([("v", "sum")])
    g = _sorted_pydict(got.to_pydict())
    e = _sorted_pydict({"a": exp.column("a").to_pylist(),
                        "b": exp.column("b").to_pylist(),
                        "v_sum": exp.column("v_sum").to_pylist()})
    assert g == e


def test_group_by_empty():
    t = at.Table.from_pydict({"k": at.column([], at.int64),
                              "v": at.column([], at.float64)})
    got = ops.group_by(t, ["k"], [ops.AggSpec("v", "sum")])
    assert got.num_rows == 0


def test_group_by_all_null_group():
    t = at.Table.from_pydict({"k": [1, 1], "v": [None, None]})
    got = ops.group_by(t, ["k"], [ops.AggSpec("v", "sum"),
                                  ops.AggSpec("v", "count")])
    assert got.to_pydict() == {"k": [1], "v_sum": [None], "v_count": [0]}


# ---- join -------------------------------------------------------------------

def _join_golden(lt, rt, on, how_pa, how_us, n=None):
    l = at.Table.from_pyarrow(lt)
    r = at.Table.from_pyarrow(rt)
    got = ops.join(l, r, on, how=how_us)
    exp = lt.join(rt, keys=on, join_type=how_pa)
    g = _sorted_pydict(got.to_pydict())
    e = _sorted_pydict({c: exp.column(c).to_pylist()
                        for c in got.column_names})
    assert g == e


def test_inner_join_golden():
    lt = pa.table({
        "k": create_primitive_array(500, 0.05, np.int64, lo=0, hi=80,
                                    seed=1),
        "lv": create_primitive_array(500, 0.0, np.int64, seed=2)})
    rt = pa.table({
        "k": create_primitive_array(200, 0.05, np.int64, lo=0, hi=80,
                                    seed=3),
        "rv": create_primitive_array(200, 0.0, np.int64, seed=4)})
    _join_golden(lt, rt, ["k"], "inner", "inner")


def test_left_join_golden():
    lt = pa.table({"k": [1, 2, 3, None, 2], "lv": [10, 20, 30, 40, 50]})
    rt = pa.table({"k": [2, 2, 3, None], "rv": ["a", "b", "c", "d"]})
    _join_golden(lt, rt, ["k"], "left outer", "left")


def test_semi_anti_join_golden():
    lt = pa.table({"k": [1, 2, 3, None, 2], "lv": [10, 20, 30, 40, 50]})
    rt = pa.table({"k": [2, 3], "rv": [1, 2]})
    _join_golden(lt, rt, ["k"], "left semi", "semi")
    _join_golden(lt, rt, ["k"], "left anti", "anti")


def test_multi_key_join_golden():
    lt = pa.table({
        "a": create_primitive_array(300, 0.0, np.int64, lo=0, hi=9, seed=5),
        "b": create_primitive_array(300, 0.0, np.int64, lo=0, hi=9, seed=6),
        "lv": create_primitive_array(300, 0.0, np.int64, seed=7)})
    rt = pa.table({
        "a": create_primitive_array(100, 0.0, np.int64, lo=0, hi=9, seed=8),
        "b": create_primitive_array(100, 0.0, np.int64, lo=0, hi=9, seed=9),
        "rv": create_primitive_array(100, 0.0, np.int64, seed=10)})
    _join_golden(lt, rt, ["a", "b"], "inner", "inner")


def test_join_string_keys():
    lt = pa.table({"k": ["a", "b", None, "c"], "lv": [1, 2, 3, 4]})
    rt = pa.table({"k": ["b", "c", "c"], "rv": [10, 20, 30]})
    _join_golden(lt, rt, ["k"], "inner", "inner")


def test_join_zipf_skew():
    """Skewed keys (the BASELINE config-5 shape, downscaled)."""
    rng = np.random.default_rng(0)
    probe_keys = (rng.zipf(1.5, 5000) % 100).astype(np.int64)
    build_keys = np.arange(100, dtype=np.int64)
    lt = pa.table({"k": probe_keys,
                   "lv": np.arange(5000, dtype=np.int64)})
    rt = pa.table({"k": build_keys,
                   "rv": build_keys * 10})
    _join_golden(lt, rt, ["k"], "inner", "inner")


def test_group_by_minmax_at_int64_extremes(rng):
    """Nulls must not tie with genuine i64::MAX values in the min/max
    secondary sort."""
    import numpy as np
    import arrow_tpu as at
    from arrow_tpu.ops.groupby import group_by, AggSpec
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    keys = np.array([1, 1, 1, 2, 2], np.int64)
    vals = np.array([imax, 5, 0, imin, 7], np.int64)
    valid = np.array([True, True, False, True, True])
    t = at.Table.from_pydict({"k": at.column(keys),
                              "v": at.column(vals, validity=valid)})
    d = ops.group_by(t, ["k"], [ops.AggSpec("v", "min"),
                                ops.AggSpec("v", "max")]).to_pydict()
    assert d["v_max"] == [imax, 7]
    assert d["v_min"] == [5, imin]


def test_group_by_chunked_two_level(monkeypatch):
    """>150M-row inputs run partial/final two-level aggregation; the
    output matches the single-pass plan (forced via a tiny chunk)."""
    from arrow_tpu.ops import groupby as gb
    from arrow_tpu.ops.groupby import group_by, AggSpec
    from arrow_tpu.io.interop import table_from_pyarrow
    rng = np.random.default_rng(7)
    n = 5000
    rb = pa.record_batch([
        pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.1),
        pa.array(rng.integers(-100, 100, n), mask=rng.random(n) < 0.2),
        pa.array(rng.normal(size=n), pa.float64()),
    ], names=["k", "v", "f"])
    t = table_from_pyarrow(rb)
    specs = [AggSpec("v", "sum"), AggSpec("v", "count"),
             AggSpec("v", "min"), AggSpec("v", "max"),
             AggSpec("v", "mean"), AggSpec("f", "sum"),
             AggSpec("f", "min"), AggSpec("k", "count_all")]
    whole = group_by(t, ["k"], specs).to_pydict()
    monkeypatch.setattr(gb, "_SORT_AGG_CHUNK", 700)
    chunked = group_by(t, ["k"], specs).to_pydict()
    for k in whole:
        for a, b in zip(whole[k], chunked[k]):
            if isinstance(a, float):
                assert (np.isnan(a) and np.isnan(b)) or \
                    abs(a - b) <= 1e-9 * max(1, abs(a)), (k, a, b)
            else:
                assert a == b, (k, a, b)


from arrow_tpu.ops.join import join_indices


@pytest.mark.parametrize("seed", range(3))
def test_join_random_m_to_n(seed):
    """Randomized m:n join vs a numpy oracle (exercises the sort-merge
    probe + cummax-packed expansion end to end)."""
    rng = np.random.default_rng(seed)
    n_l = int(rng.integers(1, 700))
    n_r = int(rng.integers(1, 400))
    pk = rng.integers(0, 40, n_l)
    bk = rng.integers(0, 40, n_r)
    pmask = rng.random(n_l) < 0.9
    bmask = rng.random(n_r) < 0.9
    L = at.Table.from_pyarrow(pa.record_batch(
        {"k": pa.array(pk, mask=~pmask)}))
    R = at.Table.from_pyarrow(pa.record_batch(
        {"k": pa.array(bk, mask=~bmask)}))
    li, ri = join_indices(L, R, ["k"])
    got = sorted(zip(np.asarray(li).tolist(), np.asarray(ri).tolist()))
    exp = sorted((i, j)
                 for i in range(n_l) if pmask[i]
                 for j in range(n_r) if bmask[j] and pk[i] == bk[j])
    assert got == exp
    # probe-ordered output
    assert (np.diff(np.asarray(li)) >= 0).all()


# ---------------------------------------------------------------------------
# perfect-binning fast path (small-range integer keys)

from arrow_tpu.ops import groupby as _gb


def _bin_vs_general(t, keys, aggs, monkeypatch):
    """Assert the bin path triggers, then compare it to the general path."""
    got = _gb._int_range_fast_path(t, [t.column(k) for k in keys], keys,
                                   aggs)
    assert got is not None, "bin path did not trigger"
    with monkeypatch.context() as m:
        m.setattr(_gb, "_int_range_fast_path", lambda *a: None)
        exp = _gb.group_by(t, keys, aggs)
    assert got.to_pydict() == exp.to_pydict() or _cmp_float(got, exp)
    return got


def _cmp_float(a, b):
    da, db = a.to_pydict(), b.to_pydict()
    assert set(da) == set(db)
    for k in da:
        for x, y in zip(da[k], db[k]):
            if isinstance(x, float) and isinstance(y, float):
                if np.isnan(x) and np.isnan(y):
                    continue
                assert x == y or abs(x - y) <= 1e-9 * max(1.0, abs(x)), \
                    (k, x, y)
            else:
                assert x == y, (k, x, y)
    return True


@pytest.mark.parametrize("seed", range(4))
def test_bin_path_randomized(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    k1 = rng.integers(-20, 20, n)
    k2 = rng.integers(0, 7, n).astype(np.int16)
    v = rng.integers(-1000, 1000, n)
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.03] = np.inf
    f[rng.random(n) < 0.03] = -np.inf
    m1 = rng.random(n) < 0.9
    mv = rng.random(n) < 0.85
    mf = rng.random(n) < 0.9
    t = at.Table.from_pyarrow(pa.table({
        "k1": pa.array(k1, mask=~m1),
        "k2": pa.array(k2),
        "v": pa.array(v, mask=~mv),
        "f": pa.array(f, mask=~mf),
        "s": pa.array([f"x{i % 11}" if i % 13 else None
                       for i in range(n)]),
    }))
    aggs = [_gb.AggSpec("v", "sum"), _gb.AggSpec("v", "min"),
            _gb.AggSpec("v", "max"), _gb.AggSpec("v", "mean"),
            _gb.AggSpec("f", "sum"), _gb.AggSpec("f", "min"),
            _gb.AggSpec("f", "max"), _gb.AggSpec("f", "count"),
            _gb.AggSpec("s", "count"), _gb.AggSpec("k1", "count_all")]
    _bin_vs_general(t, ["k1", "k2"], aggs, monkeypatch)


def test_bin_path_extreme_ranges(monkeypatch):
    # u64 value column beyond i64, i64 value range wider than u32
    k = np.array([0, 1, 2, 0, 1, 2, 5], np.int64)
    vu = np.array([2**63 + 5, 3, 2**64 - 1, 7, 2**63, 11, 0],
                  dtype=np.uint64)
    vw = np.array([-2**62, 2**62, 0, 17, -33, 2**40, -2**40], np.int64)
    t = at.Table.from_pyarrow(pa.table({
        "k": pa.array(k), "vu": pa.array(vu), "vw": pa.array(vw)}))
    aggs = [_gb.AggSpec("vu", "min"), _gb.AggSpec("vu", "max"),
            _gb.AggSpec("vu", "sum"), _gb.AggSpec("vw", "min"),
            _gb.AggSpec("vw", "max"), _gb.AggSpec("vw", "sum")]
    got = _bin_vs_general(t, ["k"], aggs, monkeypatch)
    d = got.to_pydict()
    assert d["vu_max"][2] == 2**64 - 1
    assert d["vw_sum"][0] == -2**62 + 17


def test_bin_path_chunked(monkeypatch):
    monkeypatch.setattr(_gb, "_BIN_CHUNK", 257)
    rng = np.random.default_rng(11)
    n = 2000
    k = rng.integers(0, 40, n)
    v = rng.integers(-50, 50, n)
    f = rng.standard_normal(n)
    f[::101] = np.nan
    mv = rng.random(n) < 0.8
    t = at.Table.from_pyarrow(pa.table({
        "k": pa.array(k), "v": pa.array(v, mask=~mv), "f": pa.array(f)}))
    aggs = [_gb.AggSpec("v", "sum"), _gb.AggSpec("v", "min"),
            _gb.AggSpec("v", "max"), _gb.AggSpec("v", "count"),
            _gb.AggSpec("f", "min"), _gb.AggSpec("f", "max"),
            _gb.AggSpec("f", "sum")]
    _bin_vs_general(t, ["k"], aggs, monkeypatch)


def test_bin_path_declines_wide_range():
    # 2^40 key range: beyond perfect binning, but the packed-sort
    # high-cardinality plan covers it (r3) — answers directly
    t = at.Table.from_pydict({
        "k": np.array([0, 2**40, 7], np.int64),
        "v": np.arange(3, dtype=np.int64)})
    r = _gb._int_range_fast_path(t, [t.column("k")], ["k"],
                                 [_gb.AggSpec("v", "sum")])
    assert r is not None
    assert r.to_pydict()["v_sum"] == [0, 2, 1]
    # full 64-bit key range: even the packed plan must decline (the
    # combined code would need >63 bits) and fall to the general path
    t2 = at.Table.from_pydict({
        "k": np.array([-2**62, 2**62, 7], np.int64),
        "v": np.arange(3, dtype=np.int64)})
    r2 = _gb._int_range_fast_path(t2, [t2.column("k")], ["k"],
                                  [_gb.AggSpec("v", "sum")])
    assert r2 is None
    out = _gb.group_by(t2, ["k"], [_gb.AggSpec("v", "sum")])
    assert out.to_pydict()["v_sum"] == [0, 2, 1]


import importlib

_jn = importlib.import_module("arrow_tpu.ops.join")


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("seed", range(3))
def test_perfect_index_join_parity(how, seed, monkeypatch):
    """Unique small-range build keys route through the dense-table
    index join; outputs match the merge plan exactly (incl. NULL-key
    semantics and probe ordering)."""
    rng = np.random.default_rng(seed)
    n_l, n_r = 5000, 700
    build_keys = rng.choice(3000, n_r, replace=False).astype(np.int64)
    probe_keys = rng.integers(-50, 3200, n_l)
    lt = at.Table.from_pyarrow(pa.table({
        "k": pa.array(probe_keys, mask=rng.random(n_l) < 0.05),
        "p": pa.array(np.arange(n_l))}))
    rt = at.Table.from_pyarrow(pa.table({
        "k": pa.array(build_keys, mask=rng.random(n_r) < 0.05),
        "w": pa.array(np.arange(n_r) * 7)}))
    got = _jn.join_indices(lt, rt, ["k"], how=how)
    with monkeypatch.context() as m:
        # force the merge plan by making the index path unavailable
        m.setattr(_jn, "_index_build_stage",
                  lambda *a, **k: (None, np.bool_(True)))
        # returning dup=True declines the index plan
        import types
        exp = _jn.join_indices(lt, rt, ["k"], how=how)
    ga, gb = np.asarray(got[0]), np.asarray(got[1])
    ea, eb = np.asarray(exp[0]), np.asarray(exp[1])
    assert (ga == ea).all(), how
    assert (gb == eb).all(), how


def test_perfect_index_with_probe_outliers(monkeypatch):
    """Probe keys far outside the build range must NOT disable the
    index plan (the table is sized by the BUILD range; outliers miss)."""
    lt = at.Table.from_pydict({
        "k": np.array([5, 2**60, -2**60, 7, 6], np.int64)})
    rt = at.Table.from_pydict({
        "k": np.array([5, 6, 8], np.int64),
        "w": np.array([50, 60, 80], np.int64)})
    used = {}
    real = _jn._index_build_stage

    def spy(*a, **k):
        used["hit"] = True
        return real(*a, **k)
    monkeypatch.setattr(_jn, "_index_build_stage", spy)
    li, ri = _jn.join_indices(lt, rt, ["k"])
    assert used.get("hit")
    assert np.asarray(li).tolist() == [0, 4]
    assert np.asarray(ri).tolist() == [0, 1]
    li, ri = _jn.join_indices(lt, rt, ["k"], how="left")
    assert np.asarray(ri).tolist() == [0, -1, -1, -1, 1]


def test_perfect_index_declines_duplicate_build_keys():
    lt = at.Table.from_pydict({"k": np.array([1, 2, 3], np.int64)})
    rt = at.Table.from_pydict({"k": np.array([1, 1, 2], np.int64),
                               "w": np.array([10, 11, 20], np.int64)})
    li, ri = _jn.join_indices(lt, rt, ["k"])
    pairs = sorted(zip(np.asarray(li).tolist(),
                       np.asarray(ri).tolist()))
    assert pairs == [(0, 0), (0, 1), (1, 2)]


def test_perfect_index_many_null_build_keys(monkeypatch):
    # >1 null build key must NOT false-trigger the duplicate detector
    lt = at.Table.from_pydict({"k": np.array([5, 7, 9], np.int64)})
    rt = at.Table.from_pyarrow(pa.table({
        "k": pa.array([5, None, None, 9], type=pa.int64()),
        "w": pa.array([50, 0, 1, 90], type=pa.int64())}))
    seen = {}
    # spy OUTSIDE the jit boundary: the r5 fused plan calls
    # _index_build_raw (encode folded in), whose outputs are concrete
    real = _jn._index_build_raw

    def spy(*a, **k):
        out = real(*a, **k)
        seen["dup"] = bool(out[1])
        return out
    monkeypatch.setattr(_jn, "_index_build_raw", spy)
    li, ri = _jn.join_indices(lt, rt, ["k"])
    assert seen["dup"] is False
    assert np.asarray(li).tolist() == [0, 2]
    assert np.asarray(ri).tolist() == [0, 3]


def test_bin_path_many_value_columns(monkeypatch):
    # one bin stage carries several value columns (int with nulls, float
    # with NaN) through its primary and extra sorts; it must answer
    # exactly like the general path
    rng = np.random.default_rng(3)
    n = 1500
    k = rng.integers(0, 30, n)
    v = rng.integers(-100, 100, n)
    f = rng.standard_normal(n)
    f[::37] = np.nan
    mv = rng.random(n) < 0.85
    t = at.Table.from_pyarrow(pa.table({
        "k": pa.array(k), "v": pa.array(v, mask=~mv), "f": pa.array(f)}))
    aggs = [_gb.AggSpec("v", "sum"), _gb.AggSpec("v", "min"),
            _gb.AggSpec("v", "max"), _gb.AggSpec("f", "sum"),
            _gb.AggSpec("f", "min"), _gb.AggSpec("f", "max"),
            _gb.AggSpec("k", "count_all")]
    got = _gb._int_range_fast_path(t, [t.column("k")], ["k"], aggs)
    assert got is not None
    with monkeypatch.context() as m:
        m.setattr(_gb, "_int_range_fast_path", lambda *a: None)
        exp = _gb.group_by(t, ["k"], aggs)
    _cmp_float(got, exp)


def test_bin_path_all_null_keys(monkeypatch):
    t = at.Table.from_pyarrow(pa.table({
        "k": pa.array([None, None, None], type=pa.int32()),
        "v": pa.array([1, 2, 3], type=pa.int64())}))
    got = _bin_vs_general(
        t, ["k"], [_gb.AggSpec("v", "sum"), _gb.AggSpec("v", "mean")],
        monkeypatch)
    assert got.to_pydict()["v_sum"] == [6]


def test_group_by_nested_key():
    """Nested (list/struct) group keys ride the host-rank key encoding —
    beyond the reference (DataFusion territory), for free."""
    from arrow_tpu.ops.groupby import AggSpec
    t = at.Table.from_pydict({
        "k": at.column([[1], [2], [1], None], at.dtypes.list_(at.int64)),
        "v": [1.0, 2.0, 3.0, 4.0]})
    out = ops.group_by(t, ["k"], [ops.AggSpec("v", "sum")])
    assert out.to_pydict() == {"k": [None, [1], [2]],
                               "v_sum": [4.0, 4.0, 2.0]}


def test_mean_narrow_int_wide_sum():
    """mean divides the WIDE sum: int8 group sums past 127 must not
    wrap (was -28.0 for mean of [100, 100])."""
    t = at.Table(
        (at.column(["x", "x"]), at.column(np.array([100, 100], np.int8))),
        at.Schema((at.Field("k", at.utf8), at.Field("v", at.int8))))
    g = ops.group_by(t, ["k"], [ops.AggSpec("v", "mean")])
    assert g.column("v_mean").to_pylist() == [100.0]


def test_mean_narrow_int_chunked(monkeypatch):
    """The chunked two-level path widens mean sources before partial
    sums (per-chunk int8 partials wrapped)."""
    import arrow_tpu.ops.groupby as gb
    n = 64
    t = at.Table(
        (at.column(["x"] * n), at.column(np.full(n, 100, np.int8))),
        at.Schema((at.Field("k", at.utf8), at.Field("v", at.int8))))
    out = gb._group_by_chunked(t, ["k"], [ops.AggSpec("v", "mean")], n)
    assert out.column("v_mean").to_pylist() == [100.0]


def test_join_empty_inputs():
    """Empty left/right tables are routine (a filter that matched
    nothing feeding a join) — every join type returns, no crash."""
    from arrow_tpu.ops.join import join_indices
    L = at.Table.from_pydict({"k": [1, 2, 3]})
    E = at.Table.from_pydict({"k": np.zeros(0, np.int64)})
    li, ri = join_indices(L, E, ["k"], how="left")
    assert np.asarray(li).tolist() == [0, 1, 2]
    assert np.asarray(ri).tolist() == [-1, -1, -1]
    assert len(np.asarray(join_indices(E, L, ["k"], how="inner")[0])) == 0
    assert np.asarray(join_indices(L, E, ["k"],
                                   how="anti")[0]).tolist() == [0, 1, 2]
    assert len(np.asarray(join_indices(L, E, ["k"], how="semi")[0])) == 0


def test_multikey_semi_anti():
    """Multi-key semi/anti take the collision-verified path and stay
    exact."""
    from arrow_tpu.ops.join import join
    L = at.Table.from_pydict({"a": [1, 1, 2], "b": [1, 2, 1],
                              "v": [10, 20, 30]})
    R = at.Table.from_pydict({"a": [1, 2], "b": [2, 9]})
    s = join(L, R, ["a", "b"], how="semi")
    assert s.column("v").to_pylist() == [20]
    a = join(L, R, ["a", "b"], how="anti")
    assert a.column("v").to_pylist() == [10, 30]


def test_dictionary_fast_path_gates_null_and_dup_values(monkeypatch):
    """Dictionaries with null entries or duplicate values must produce
    the GENERAL path's answer: the fast path declines them."""
    import jax.numpy as jnp
    from arrow_tpu.core.column import DictionaryColumn, StringColumn
    for entries in (["a", None, "b"], ["a", "b", "a"]):
        key = DictionaryColumn(
            jnp.asarray(np.array([0, 1, 2, 1], np.int32)),
            StringColumn.from_pylist(entries), None)
        v = at.column([1, 2, 3, 4])
        t = at.Table((key, v), at.Schema((at.Field("k", key.dtype),
                                          at.Field("v", at.int64))))
        aggs = [ops.AggSpec("v", "sum")]
        assert _gb._dictionary_fast_path(t, [key], ["k"], aggs) is None
        got = ops.group_by(t, ["k"], aggs).to_pydict()
        with monkeypatch.context() as m:
            m.setattr(_gb, "_dictionary_fast_path", lambda *a: None)
            want = ops.group_by(t, ["k"], aggs).to_pydict()
        assert got == want
        vals = dict(zip(got["k"], got["v_sum"]))
        if None in entries:
            assert vals == {None: 6, "a": 1, "b": 3}
        else:
            assert vals == {"a": 4, "b": 6}


def test_group_by_string_min_max():
    """MIN/MAX over string and dictionary sources (grouped): aggregate
    the order-preserving rank key, decode the winning rank (pyarrow
    min/max oracle)."""
    t_pa = pa.table({
        "k": ["x", "y", "x", "y", "x", "z"],
        "s": ["bb", "a", None, "zz", "aa", None],
    })
    t = at.Table.from_pyarrow(t_pa)
    g = ops.group_by(t, ["k"], [ops.AggSpec("s", "min"),
                                ops.AggSpec("s", "max"),
                                ops.AggSpec("s", "count")])
    d = g.to_pydict()
    assert d["k"] == ["x", "y", "z"]
    assert d["s_min"] == ["aa", "a", None]
    assert d["s_max"] == ["bb", "zz", None]
    assert d["s_count"] == [2, 2, 0]
    # dictionary source
    dcol = ops.dictionary_encode(t.column("s"))
    t2 = at.Table((t.column("k"), dcol),
                  at.Schema((at.Field("k", at.utf8),
                             at.Field("s", dcol.dtype))))
    g2 = ops.group_by(t2, ["k"], [ops.AggSpec("s", "min")])
    assert g2.to_pydict()["s_min"] == ["aa", "a", None]
    # empty table with a string aggregate
    e = ops.group_by(t.slice(0, 0), ["k"], [ops.AggSpec("s", "max")])
    assert e.num_rows == 0
    # oracle cross-check via pyarrow group_by
    exp = t_pa.group_by("k").aggregate([("s", "min"), ("s", "max")])
    exp_d = {k: v for k, v in sorted(zip(exp.column("k").to_pylist(),
                                         exp.column("s_min").to_pylist()))}
    assert {k: v for k, v in zip(d["k"], d["s_min"])} == exp_d


# ---- HashJoiner: streaming build-once/probe-many (config5 spec scale) ----

def _hj():
    from arrow_tpu.ops.join import HashJoiner
    return HashJoiner


def test_hash_joiner_index_plan_chunks():
    """Chunked probes against a unique-int build side reproduce the
    one-shot join exactly (index plan)."""
    rng = np.random.default_rng(11)
    bk = np.arange(0, 4000, 2, dtype=np.int64)        # unique, span 2x
    pk = rng.integers(-100, 4100, 10_000).astype(np.int64)
    right = at.Table.from_pydict({"k": bk})
    left = at.Table.from_pydict({"k": pk})
    j = _hj()(right, ["k"])
    assert j._plan == "index"
    got_pairs = []
    C = 1500
    for s in range(0, len(pk), C):
        chunk = left.slice(s, min(C, len(pk) - s))
        li, ri = j.probe_indices(chunk, "inner")
        got_pairs += [(int(a) + s, int(b))
                      for a, b in zip(np.asarray(li), np.asarray(ri))]
    from arrow_tpu.ops.join import join_indices
    li, ri = join_indices(left, right, ["k"])
    want = list(zip(np.asarray(li).tolist(), np.asarray(ri).tolist()))
    assert sorted(got_pairs) == sorted(want)
    # streamed count path agrees
    n = chk = 0
    for s in range(0, len(pk), C):
        c, k = j.probe_count(left.slice(s, min(C, len(pk) - s)))
        n += c
        chk += k
    assert n == len(want)
    assert chk == int(np.asarray(ri).sum())


def test_hash_joiner_merge_fallback_and_hows():
    """Duplicate build keys decline the index plan; left/semi/anti
    probes match join_indices per chunk."""
    bk = np.array([1, 1, 2, 5, 9], np.int64)          # dups
    right = at.Table.from_pydict({"k": bk})
    j = _hj()(right, ["k"])
    assert j._plan == "merge"
    pk = np.array([2, 3, 1, 9, 9, 4], np.int64)
    left = at.Table.from_pydict({"k": pk})
    from arrow_tpu.ops.join import join_indices
    for how in ("inner", "left", "semi", "anti"):
        li, ri = j.probe_indices(left, how)
        wl, wr = join_indices(left, right, ["k"], how)
        assert np.asarray(li).tolist() == np.asarray(wl).tolist()
        assert np.asarray(ri).tolist() == np.asarray(wr).tolist()


def test_hash_joiner_null_keys_and_empty():
    """NULL probe keys never match; empty chunks are routine."""
    right = at.Table.from_pydict({"k": np.arange(10, dtype=np.int64)})
    j = _hj()(right, ["k"])
    left = at.Table.from_pyarrow(
        pa.table({"k": pa.array([3, None, 7, None], pa.int64())}))
    li, ri = j.probe_indices(left, "inner")
    assert np.asarray(li).tolist() == [0, 2]
    assert np.asarray(ri).tolist() == [3, 7]
    li, ri = j.probe_indices(left.slice(0, 0), "inner")
    assert li.shape[0] == 0
    c, k = j.probe_count(left)
    assert (c, k) == (2, 10)


def test_group_by_accumulator_streaming_matches_oneshot():
    """GroupByAccumulator (streaming partial/final) == one-shot group_by
    for sum/count/min/max/mean incl. narrow-dtype mean widening and the
    partial-compaction path."""
    import numpy as np
    import arrow_tpu as at
    from arrow_tpu.ops.groupby import (group_by, AggSpec,
                                       GroupByAccumulator)
    rng = np.random.default_rng(11)
    N = 120_000
    t = at.Table.from_pydict({
        "k": rng.integers(0, 3000, N),
        "v": rng.integers(-100, 100, N).astype(np.int32),
        "f": rng.random(N).astype(np.float32)})
    aggs = [AggSpec("v", "sum"), AggSpec("v", "count"),
            AggSpec("v", "min"), AggSpec("v", "max"),
            AggSpec("f", "mean"), AggSpec("v", "mean")]

    def norm(tb):
        idx = np.argsort(np.asarray(tb.column("k").values))
        return {f.name: np.asarray(c.values)[idx]
                for f, c in zip(tb.schema.fields, tb.columns)}

    a = norm(group_by(t, ["k"], aggs))
    acc = GroupByAccumulator(["k"], aggs)
    acc.COMPACT_ROWS = 5000        # force mid-stream partial compaction
    for i in range(0, N, 25_000):
        acc.update(t.slice(i, min(25_000, N - i)))
    assert len(acc._parts) == 1    # compaction actually ran
    b = norm(acc.finalize())
    assert set(a) == set(b)
    for kk in a:
        if a[kk].dtype.kind == "f":
            assert np.allclose(a[kk], b[kk], rtol=1e-12), kk
        else:
            assert (a[kk] == b[kk]).all(), kk


def test_group_by_accumulator_async_pipelined():
    """update_async (depth-2 pipelined updates) == sync update ==
    one-shot group_by; worker exceptions surface at flush/finalize."""
    import numpy as np
    import arrow_tpu as at
    from arrow_tpu.ops.groupby import (group_by, AggSpec,
                                       GroupByAccumulator)
    rng = np.random.default_rng(12)
    N = 80_000
    t = at.Table.from_pydict({
        "k": rng.integers(0, 2000, N),
        "v": rng.integers(-100, 100, N)})
    aggs = [AggSpec("v", "sum"), AggSpec("v", "count"),
            AggSpec("v", "min"), AggSpec("v", "max")]
    acc = GroupByAccumulator(["k"], aggs)
    for i in range(0, N, 10_000):
        acc.update_async(t.slice(i, min(10_000, N - i)))
    got = acc.finalize()
    exp = group_by(t, ["k"], aggs)
    assert got.to_pydict() == exp.to_pydict()

    # errors from the worker thread re-raise on the caller side
    import pytest as _pytest
    bad = GroupByAccumulator(["k"], [AggSpec("missing", "sum")])
    with _pytest.raises(Exception):
        bad.update_async(t.slice(0, 1000))
        bad.flush()
