"""Dense-code grouped aggregation and mask compaction on the CPU.

The dictionary fast path of group_by reduces straight into the slots of
the combined key code with segment ops (ops/groupby.py _fast_agg_stage);
filter compaction is one stable partition sort (ops/filter.py
compact_by_mask).  Both are checked exactly against numpy, and the fast
path is checked against the general sort path of group_by.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu.ops import groupby as gb
from arrow_tpu.ops.filter import compact_by_mask, filter_table
from arrow_tpu.ops.groupby import group_by, AggSpec


def _np_groups(vals, codes, valid, G):
    sums = np.zeros(G, np.int64)
    counts = np.zeros(G, np.int64)
    mins, maxs = {}, {}
    for g in range(G):
        m = (codes == g) & valid
        counts[g] = m.sum()
        if m.any():
            sums[g] = vals[m].sum()
            mins[g] = vals[m].min()
            maxs[g] = vals[m].max()
    return sums, counts, mins, maxs


def _sum_count(vals, codes, valid, G):
    """(sums, counts) of one value column over one dictionary key of G
    entries (slot G of the stage output is the null-key digit)."""
    m = None if valid is None else jnp.asarray(valid)
    sums, counts, _ = gb._fast_agg_stage(
        (G,), G + 1, (), ((jnp.asarray(codes), None),),
        ((jnp.asarray(vals), m),), ())
    return np.asarray(sums[0])[:G], np.asarray(counts[0])[:G]


def _min_max(vals, codes, valid, G):
    m = None if valid is None else jnp.asarray(valid)
    _, counts, mms = gb._fast_agg_stage(
        (G,), G + 1, ((True, True),), ((jnp.asarray(codes), None),),
        ((None, m),), ((jnp.asarray(vals), m),))
    mn, mx = mms[0]
    return (np.asarray(counts[0])[:G], np.asarray(mn)[:G],
            np.asarray(mx)[:G])


def _dict_key(codes, G, validity=None):
    return at.DictionaryColumn(
        jnp.asarray(codes.astype(np.int32)),
        at.column([f"k{i:04d}" for i in range(G)]),
        None if validity is None else jnp.asarray(validity))


@pytest.fixture
def general_path(monkeypatch):
    """Run group_by with the dense fast paths switched off."""
    def run(t, keys, aggs):
        with monkeypatch.context() as m:
            m.setattr(gb, "_dictionary_fast_path", lambda *a: None)
            m.setattr(gb, "_int_range_fast_path", lambda *a: None)
            return group_by(t, keys, aggs)
    return run


@pytest.mark.parametrize("dtype,lo,hi", [
    (np.int64, -10**17, 10**17),
    (np.int32, -2**31, 2**31),
    (np.uint64, 0, 2**63),
    (np.int16, -2**15, 2**15),
])
def test_grouped_sum_count_exact(rng, dtype, lo, hi):
    n, G = 3000, 37
    vals = rng.integers(lo, hi, n).astype(dtype)
    codes = rng.integers(0, G, n).astype(np.int32)
    valid = rng.random(n) > 0.25
    s, c = _sum_count(vals, codes, valid, G)
    exp_s, exp_c, _, _ = _np_groups(vals.astype(np.int64), codes, valid, G)
    assert (c == exp_c).all()
    assert (s == exp_s).all()


def test_grouped_sum_wrapping(rng):
    # wrapping i64 sums match a sequential wrapping loop in any order
    n, G = 1100, 3
    vals = rng.integers(2**62, 2**63, n).astype(np.uint64).astype(np.int64)
    codes = rng.integers(0, G, n).astype(np.int32)
    s, _ = _sum_count(vals, codes, None, G)
    exp = np.zeros(G, np.int64)
    for g in range(G):
        exp[g] = vals[codes == g].sum()      # numpy wraps
    assert (s == exp).all()


def test_grouped_count_none_valid(rng):
    n, G = 2500, 140          # G > 128: more groups than one warp's lanes
    codes = rng.integers(0, G, n).astype(np.int32)
    _, c = _sum_count(np.zeros(n, np.int64), codes, None, G)
    assert (c == np.bincount(codes, minlength=G)).all()


@pytest.mark.parametrize("dtype,lo,hi", [
    (np.int64, -10**17, 10**17),
    (np.uint32, 0, 2**32),
    (np.int8, -128, 128),
])
def test_grouped_min_max_exact(rng, dtype, lo, hi):
    n, G = 3000, 37
    vals = rng.integers(lo, hi, n).astype(dtype)
    codes = rng.integers(0, G, n).astype(np.int32)
    valid = rng.random(n) > 0.25
    counts, mn, mx = _min_max(vals, codes, valid, G)
    _, exp_c, mins, maxs = _np_groups(vals, codes, valid, G)
    assert (counts == exp_c).all()
    for g in range(G):
        if exp_c[g]:
            assert mn[g] == mins[g], g
            assert mx[g] == maxs[g], g


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grouped_min_max_float(rng, dtype):
    """NaN orders above +inf: min skips NaN unless the group is all NaN,
    max is NaN as soon as one value is; ±inf are ordinary extremes."""
    n, G = 2000, 19
    vals = rng.normal(0, 1e6, n).astype(dtype)
    vals[rng.random(n) < 0.05] = np.inf
    vals[rng.random(n) < 0.05] = -np.inf
    vals[rng.random(n) < 0.03] = np.nan
    codes = rng.integers(0, G, n).astype(np.int32)
    codes[codes == 7] = 8
    vals[codes == 8] = np.nan                # an all-NaN group
    valid = rng.random(n) > 0.2
    counts, mn, mx = _min_max(vals, codes, valid, G)
    assert mn.dtype == dtype and mx.dtype == dtype
    for g in range(G):
        x = vals[(codes == g) & valid]
        assert counts[g] == len(x)
        if not len(x):
            continue
        finite = x[~np.isnan(x)]
        exp_mn = finite.min() if len(finite) else np.nan
        exp_mx = np.nan if np.isnan(x).any() else x.max()
        np.testing.assert_array_equal(mn[g], exp_mn)
        np.testing.assert_array_equal(mx[g], exp_mx)


def test_group_by_general_path_matches_numpy(rng, general_path):
    """The general sort path's cumsum/boundary-diff sums and secondary
    sort min/max, at a cardinality the dense paths would take."""
    n = 4000
    keys = rng.integers(0, 11, n).astype(np.int64)
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    kv = rng.random(n) > 0.1
    vv = rng.random(n) > 0.1
    t = at.Table.from_pydict({
        "k": at.column(keys, validity=kv),
        "v": at.column(vals, validity=vv),
    })
    aggs = [AggSpec("v", "sum"), AggSpec("v", "count"),
            AggSpec("v", "min"), AggSpec("v", "max"),
            AggSpec("v", "mean"), AggSpec("v", "count_all")]
    out = general_path(t, ["k"], aggs)
    k_out = np.asarray(out.column("k").values)
    k_ok = np.asarray(out.column("k").is_valid_mask())
    assert not k_ok[0] and k_ok[1:].all()     # null group first
    assert (k_out[1:] == np.arange(11)).all()
    for i in range(12):
        rows = ~kv if i == 0 else kv & (keys == k_out[i])
        x = vals[rows & vv]
        assert int(out.column("v_count_all").values[i]) == rows.sum()
        assert int(out.column("v_count").values[i]) == len(x)
        assert int(out.column("v_sum").values[i]) == x.sum()
        assert int(out.column("v_min").values[i]) == x.min()
        assert int(out.column("v_max").values[i]) == x.max()
        assert float(out.column("v_mean").values[i]) == x.sum() / len(x)


def test_group_by_dictionary_fast_path(rng, general_path):
    # dictionary-key fast path (no row sort) vs the general path
    n = 3000
    codes = rng.integers(0, 5, n)
    kv = rng.random(n) > 0.1
    vals = rng.integers(-10**9, 10**9, n).astype(np.int64)
    vv = rng.random(n) > 0.2
    t = at.Table.from_pydict({
        "k": _dict_key(codes, 5, kv),
        "v": at.column(vals, validity=vv),
    })
    aggs = [AggSpec("v", "sum"), AggSpec("v", "count"),
            AggSpec("v", "min"), AggSpec("v", "max"),
            AggSpec("v", "mean"), AggSpec("v", "count_all")]
    assert gb._dictionary_fast_path(t, [t.column("k")], ["k"],
                                    aggs) is not None
    assert group_by(t, ["k"], aggs).to_pydict() == \
        general_path(t, ["k"], aggs).to_pydict()


def test_group_by_float_minmax_fast_path(rng, general_path):
    n = 1500
    codes = rng.integers(0, 4, n)
    vals = rng.normal(0, 100, n).astype(np.float32)
    vals[rng.random(n) < 0.05] = np.inf
    vals[rng.random(n) < 0.05] = -np.inf
    vals[codes == 2] = np.nan
    vals[::97] = np.nan
    t = at.Table.from_pydict({"k": _dict_key(codes, 4),
                              "v": at.column(vals)})
    aggs = [AggSpec("v", "min"), AggSpec("v", "max")]
    got = group_by(t, ["k"], aggs).to_pydict()
    ref = general_path(t, ["k"], aggs).to_pydict()
    assert got["k"] == ref["k"]
    for name in ("v_min", "v_max"):
        np.testing.assert_array_equal(np.array(got[name], float),
                                      np.array(ref[name], float))


def test_fast_agg_chunked_matches_unchunked(monkeypatch):
    """Streaming two-level aggregation over dictionary keys merges
    per-chunk partials of the fast path: a NaN-only group stays NaN and
    a group absent from later chunks keeps its real extremes."""
    codes = np.array([0] * 8 + [1] * 8 + [2] * 8, np.int32)
    vals = np.full(24, np.nan)
    vals[:8] = np.arange(8)
    vals[16:] = [1.5] + [np.nan] * 7
    t = at.Table.from_pydict({
        "g": _dict_key(codes, 3),
        "v": at.column(jnp.asarray(vals, dtype=jnp.float32)),
        "w": at.column(jnp.asarray(np.arange(24, dtype=np.int64) * 3)),
    })
    specs = [AggSpec("v", "min"), AggSpec("v", "max"),
             AggSpec("w", "sum"), AggSpec("w", "min"),
             AggSpec("w", "max"), AggSpec("v", "count")]
    monkeypatch.setattr(gb, "_SORT_AGG_CHUNK", 5)
    chunked = gb._group_by_chunked(t, ["g"], specs, 24).to_pydict()
    whole = group_by(t, ["g"], specs).to_pydict()
    assert chunked.keys() == whole.keys()
    for k in chunked:
        np.testing.assert_array_equal(
            np.array(chunked[k], object if k == "g" else float),
            np.array(whole[k], object if k == "g" else float))
    assert chunked["v_min"][0] == 0.0 and chunked["v_max"][0] == 7.0
    assert np.isnan(chunked["v_min"][1])
    assert chunked["v_min"][2] == 1.5 and np.isnan(chunked["v_max"][2])


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.bool_,
                                   np.uint64])
def test_compact_by_mask_matches_numpy(rng, dtype):
    n = 2500
    keep = rng.random(n) < 0.4
    if dtype == np.bool_:
        x = rng.integers(0, 2, n).astype(bool)
    elif dtype == np.float32:
        x = rng.random(n).astype(np.float32)
    else:
        x = rng.integers(0, 2**62, n).astype(dtype)
    iota = np.arange(n, dtype=np.int32)
    out, idx = compact_by_mask(jnp.asarray(keep), int(keep.sum()),
                               jnp.asarray(x), jnp.asarray(iota))
    assert (np.asarray(idx) == iota[keep]).all()     # stable order
    assert (np.asarray(out) == x[keep]).all()


def test_filter_table_matches_numpy(rng):
    """filter_table over the widths the compaction takes: 8-byte columns
    with and without validity, a 4-byte column, unsigned 8-byte."""
    n = 2000
    a = rng.integers(-100, 100, n).astype(np.int64)
    av = rng.random(n) > 0.1
    b = rng.integers(0, 9, n).astype(np.int32)
    c = rng.integers(0, 2**40, n).astype(np.uint64)
    d = rng.normal(size=n)
    t = at.Table.from_pydict({
        "a": at.column(a, validity=av), "b": at.column(b),
        "c": at.column(c), "d": at.column(d)})
    pv = rng.random(n) < 0.5
    pvalid = rng.random(n) > 0.05
    out = filter_table(t, at.column(pv, validity=pvalid))
    keep = pv & pvalid
    assert out.num_rows == keep.sum()
    assert (np.asarray(out.column("a").values)[av[keep]]
            == a[keep & av]).all()
    assert (np.asarray(out.column("a").is_valid_mask()) == av[keep]).all()
    assert (np.asarray(out.column("b").values) == b[keep]).all()
    assert (np.asarray(out.column("c").values) == c[keep]).all()
    assert (np.asarray(out.column("d").values) == d[keep]).all()
