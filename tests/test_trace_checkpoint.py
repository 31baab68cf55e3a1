"""Op-timer layer + checkpoint/resume (SURVEY.md §5 aux subsystems)."""

import os
import time

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.utils.trace import OpTimings, op_timer, timings, reset_timings
from arrow_tpu.io.checkpoint import (checkpoint_table, restore_table,
                                     CheckpointManager)


def test_op_timer_accumulates():
    sink = OpTimings()
    with op_timer("sleepy", sink=sink):
        time.sleep(0.01)
    with op_timer("sleepy", sink=sink):
        time.sleep(0.01)
    snap = sink.snapshot()
    assert snap["sleepy"]["count"] == 2
    assert snap["sleepy"]["total_ms"] >= 15
    assert "sleepy" in sink.report()


def test_global_timings_reset():
    reset_timings()
    with op_timer("x"):
        pass
    assert timings.snapshot()["x"]["count"] == 1
    reset_timings()
    assert timings.snapshot() == {}


def _table(rng, n=500):
    return at.Table.from_pydict({
        "k": at.column(rng.integers(0, 9, n).astype(np.int64),
                       validity=rng.random(n) > 0.1),
        "s": at.column([f"v{i % 7}" for i in range(n)]),
    })


def test_checkpoint_roundtrip(tmp_path, rng):
    t = _table(rng)
    p = str(tmp_path / "snap.arrow")
    checkpoint_table(p, t)
    back = restore_table(p)
    assert back.to_pydict() == t.to_pydict()


def test_checkpoint_manager(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    t1, t2 = _table(rng, 100), _table(rng, 200)
    mgr.save(1, {"a": t1})
    mgr.save(2, {"a": t1, "b": t2})
    mgr.save(3, {"a": t2})
    assert mgr.steps() == [2, 3]          # pruned to 2
    latest = mgr.restore()
    assert latest["a"].to_pydict() == t2.to_pydict()
    prev = mgr.restore(step=2)
    assert set(prev) == {"a", "b"}
    assert prev["b"].num_rows == 200


def test_checkpoint_manager_crash_safety(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"a": _table(rng, 50)})
    # simulate a torn save: step dir without manifest is ignored
    os.makedirs(str(tmp_path / "ckpt" / "step_000000000002"))
    assert mgr.latest_step() == 1
    assert mgr.restore()["a"].num_rows == 50


def test_checkpoint_tmp_dir_never_breaks_steps(tmp_path):
    """A crash between manifest write and rename must not poison
    steps()/restore() (the tmp dir's name must not match the
    'step_<digits>' scan)."""
    import os
    import arrow_tpu as at
    from arrow_tpu.io.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path))
    t = at.Table.from_pydict({"x": [1, 2]})
    mgr.save(3, {"t": t})
    # simulate a crashed save: committed-looking tmp left behind
    os.makedirs(tmp_path / ".tmp_step_000000000007")
    with open(tmp_path / ".tmp_step_000000000007" / "MANIFEST.json",
              "w") as f:
        f.write("{}")
    # and a stray non-numeric step-prefixed dir
    os.makedirs(tmp_path / "step_junk")
    assert mgr.steps() == [3]
    assert mgr.latest_step() == 3
    assert mgr.restore()["t"].to_pydict() == {"x": [1, 2]}


def test_degraded_path_counters():
    """Parquet page skip/decode decisions surface through trace
    counters, one line per event."""
    import io
    import numpy as np
    import arrow_tpu as at
    from arrow_tpu.utils import trace

    # parquet pushdown decisions mirror into counters
    from arrow_tpu.io.parquet_io import (ParquetReaderBuilder,
                                         RowSelection, WriterProperties,
                                         write_parquet)
    n = 50_000
    t = at.Table.from_pydict({"k": np.arange(n)})
    buf = io.BytesIO()
    write_parquet(buf, t, WriterProperties(write_page_index=True,
                                           data_page_size=4_000))
    trace.reset_counters()
    sel = RowSelection([(0, 10)])
    list(ParquetReaderBuilder(io.BytesIO(buf.getvalue()))
         .with_row_selection(sel).build())
    snap = trace.counters_snapshot()
    assert snap.get("parquet.pages_skipped", 0) > 0
    assert snap.get("parquet.pages_decoded", 0) >= 1
    trace.reset_counters()
