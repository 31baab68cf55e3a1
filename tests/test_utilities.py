"""Builders, display/pretty, memory pool, Tensor — the user-facing
utility surface (arrow-array/builder, arrow-cast/display+pretty,
arrow-buffer/pool, arrow facade Tensor)."""

import os

import numpy as np
import pyarrow as pa
import pytest
import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu import dtypes as dt
from arrow_tpu.core import builders as b


# ---- builders ---------------------------------------------------------------

def test_primitive_builder():
    col = b.PrimitiveBuilder(dt.int64).extend([1, None, 3]).finish()
    assert col.to_pylist() == [1, None, 3]


def test_boolean_builder():
    col = b.BooleanBuilder().extend([True, None, False]).finish()
    assert col.to_pylist() == [True, None, False]


def test_string_builder():
    col = b.StringBuilder().extend(["ab", None, "c"]).finish()
    assert col.to_pylist() == ["ab", None, "c"]


def test_dictionary_builder_interns():
    db = b.StringDictionaryBuilder().extend(["x", "y", "x", None, "x"])
    assert db.dictionary_size == 2
    col = db.finish()
    assert col.to_pylist() == ["x", "y", "x", None, "x"]
    assert len(col.values) == 2


def test_list_builder():
    lb = b.ListBuilder(b.PrimitiveBuilder(dt.int64))
    lb.append_value([1, 2]).append_null().append_value([])
    col = lb.finish()
    assert col.to_pylist() == [[1, 2], None, []]


def test_struct_builder():
    sb = b.StructBuilder(
        (dt.Field("a", dt.int64), dt.Field("s", dt.utf8)),
        [b.PrimitiveBuilder(dt.int64), b.StringBuilder()])
    sb.field_builder(0).append(1)
    sb.field_builder(1).append("x")
    sb.append(True)
    sb.append_null()
    col = sb.finish()
    out = col.to_pylist()
    assert out[0] == {"a": 1, "s": "x"} and out[1] is None


def test_map_builder():
    mb = b.MapBuilder(b.StringBuilder(), b.PrimitiveBuilder(dt.int64))
    mb.append_value([("a", 1), ("b", 2)]).append_null()
    col = mb.finish()
    assert col.to_pyarrow().to_pylist() == [[("a", 1), ("b", 2)], None]


def test_fixed_builders():
    col = b.FixedSizeBinaryBuilder(2).extend([b"ab", None]).finish()
    assert col.to_pyarrow().to_pylist() == [b"ab", None]
    fl = b.FixedSizeListBuilder(b.PrimitiveBuilder(dt.int64), 2)
    fl.append_value([1, 2]).append_null()
    assert fl.finish().to_pyarrow().to_pylist() == [[1, 2], None]


def test_decimal_builders():
    col = b.Decimal256Builder(76, 0).extend([10**50, None, -1]).finish()
    assert col.to_pyints() == [10**50, None, -1]


def test_make_builder_matrix():
    for d in [dt.int32, dt.float64, dt.bool_, dt.utf8, dt.binary,
              dt.decimal128(20, 2), dt.dictionary(dt.int32, dt.utf8),
              dt.list_(dt.int64), dt.fixed_size_binary(4),
              dt.struct([dt.Field("x", dt.int64)]),
              dt.map_(dt.utf8, dt.int64), dt.null]:
        assert b.make_builder(d) is not None


# ---- display / pretty --------------------------------------------------------

def test_pretty_format_table():
    t = at.Table.from_pydict({
        "a": at.column([1, None, 3]),
        "s": at.column(["x", "yy", None]),
    })
    out = at.pretty_format_table(t)
    lines = out.splitlines()
    assert lines[0].startswith("+--")
    assert "| a" in lines[1] and "| s" in lines[1]
    assert len(lines) == 3 + 3 + 1          # header rows + data + border
    # parity spot-check: nulls render as empty like the reference default
    assert "| 1" in lines[3]


def test_array_formatter_values():
    col = at.column([True, None])
    f = at.ArrayFormatter(col)
    assert f.value(0) == "true" and f.value(1) == ""


def test_formatter_bytes_and_list():
    col = at.column([[1, 2], [3]], dtype=None) if False else None
    from arrow_tpu.io.interop import column_from_pyarrow
    lc = column_from_pyarrow(pa.array([[1, 2], [3]]))
    f = at.ArrayFormatter(lc)
    assert f.value(0) == "[1, 2]"


# ---- memory pool -------------------------------------------------------------

def test_column_memory_size():
    col = at.column(np.zeros(1000, np.int64))
    assert at.column_memory_size(col) == 8000
    col2 = at.column(np.zeros(1000, np.int64),
                     validity=np.ones(1000, bool))
    assert at.column_memory_size(col2) == 9000


def test_tracking_pool():
    pool = at.TrackingMemoryPool()
    r = at.MemoryReservation.for_column(pool, at.column(np.zeros(10, np.int64)))
    assert pool.used() == 80
    r.resize(40)
    assert pool.used() == 40
    r.free()
    assert pool.used() == 0 and pool.peak() == 80


def test_dictionary_occupancy():
    from arrow_tpu.core.pool import dictionary_occupancy
    col = at.DictionaryColumn(jnp.asarray(np.array([0, 0, 1], np.int32)),
                              at.column(["a", "b", "c"]))
    assert abs(dictionary_occupancy(col) - 2 / 3) < 1e-9


# ---- tensor -------------------------------------------------------------------

def test_tensor_api():
    t = at.Tensor(jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                  dim_names=["r", "c"])
    assert t.shape == (2, 3) and t.ndim == 2 and t.size == 6
    assert t.strides == (12, 4)
    assert t.dim_name(0) == "r"
    assert t.is_row_major() and not t.is_column_major()
    pa_t = t.to_pyarrow()
    back = at.Tensor.from_pyarrow(pa_t)
    assert np.array_equal(back.to_numpy(), t.to_numpy())


def test_fuse_pipeline():
    """arrow_tpu.fuse: a chain of compute ops over column pytrees
    compiles into one program and matches the eager path exactly."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    from arrow_tpu import dtypes as dtp
    from arrow_tpu.core.column import (DictionaryColumn, PrimitiveColumn,
                                       StringColumn)
    rng = np.random.default_rng(0)
    n = 10_000
    x = PrimitiveColumn(jnp.asarray(rng.integers(-100, 100, n)
                                    .astype(np.int32)), dtp.int32,
                        jnp.asarray(rng.random(n) > 0.1))
    y = PrimitiveColumn(jnp.asarray(rng.random(n)), dtp.float64)
    values = StringColumn.from_pylist([f"w{i}" for i in range(50)])
    codes = jnp.asarray(rng.integers(0, 50, n).astype(np.int32))

    @at.fuse
    def query(x, y, codes):
        dcol = DictionaryColumn(codes, values, _canonical=True)
        a = ops.cast(x, dtp.float64)
        m = ops.lt(a, y)
        s = ops.add(ops.cast(x, dtp.int64), ops.cast(x, dtp.int64))
        e = ops.eq(dcol, "w7")
        return m, s, e

    m, s, e = query(x, y, codes)
    dcol = DictionaryColumn(codes, values, _canonical=True)
    em = ops.lt(ops.cast(x, dtp.float64), y)
    es = ops.add(ops.cast(x, dtp.int64), ops.cast(x, dtp.int64))
    ee = ops.eq(dcol, "w7")
    for got, exp in ((m, em), (s, es), (e, ee)):
        assert (np.asarray(got.values) == np.asarray(exp.values)).all()
        gv = None if got.validity is None else np.asarray(got.validity)
        evd = None if exp.validity is None else np.asarray(exp.validity)
        if evd is not None:
            assert gv is not None and (gv == evd).all()

    # dictionary passed as a traced ARG (not closure) fails with the
    # actionable fuse error
    @at.fuse
    def bad(dc):
        return ops.eq(dc, "w7")
    import pytest
    with pytest.raises(RuntimeError, match="arrow_tpu.fuse"):
        bad(dcol)


def test_examples_run():
    """Every example in examples/ runs to completion (the reference
    ships arrow/examples/ as compiled doc — same contract here)."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    examples = sorted((root / "examples").glob("*.py"))
    assert len(examples) >= 7
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(root) + os.pathsep + \
        env.get("PYTHONPATH", "")
    for ex in examples:
        r = subprocess.run([sys.executable, str(ex)], cwd=str(root),
                           env=env, capture_output=True, text=True,
                           timeout=240)
        assert r.returncode == 0, (ex.name, r.stderr[-2000:])
        assert r.stdout.strip(), ex.name


def test_bench_scaling_harness():
    """tools/bench_scaling.py runs against the current parallel API
    (it rotted once when overflow flags were added to the dist ops)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "bench_scaling.py"),
         "--cpu", "--rows-per-device", "2048", "--reps", "1"],
        capture_output=True, text=True, timeout=420,
        env={**os.environ,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert r.returncode == 0, r.stderr[-500:]
    assert '"dist_weak_scaling_efficiency"' in r.stdout
