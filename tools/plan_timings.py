"""Time the plain XLA plans of filter and group-by on one GPU.

    python tools/plan_timings.py [--reps 5] [--out FILE]

Runs on one GPU (it exits non-zero on any other backend).  Cases:

  filter_table   10M rows x 4 int64 columns, 50% selectivity (the width
                 the MXU compaction kernel used to take)
  packed_group   group_by, 100M rows x 10M int64 keys, sum/count/min/max
                 of an int64 in [0, 1000) (config4's high-cardinality
                 shape: the packed-sort plan)
  dict_fast      group_by, 100M rows x 1K dictionary keys, same aggregates
                 (config4's low-cardinality shape): the dictionary fast
                 path, segment ops over the dense code
  dict_general   the same call with the fast path switched off (the
                 general sort path)

Data is generated on the device.  Each case runs once to compile, then
--reps timed calls, each ending in jax.block_until_ready on every output
buffer.  Each line reports the median and the range, and the bytes the
case must move at least (inputs read once, outputs written once) over
the median, beside the H100 SXM's 3.35 TB/s (NVIDIA data sheet).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12


def _mix(n, seed):
    import jax.numpy as jnp
    i = jnp.arange(n, dtype=jnp.uint64) + jnp.uint64(seed)
    h = (i ^ (i >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return h ^ (h >> jnp.uint64(31))


def _time(fn, reps):
    import jax
    jax.block_until_ready(fn())                  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def _report(name, times, min_bytes, **extra):
    med = statistics.median(times)
    rec = {"case": name, "median_s": med, "min_s": min(times),
           "max_s": max(times), "reps": len(times),
           "min_bytes": min_bytes, "bytes_per_s": min_bytes / med,
           "share_of_3.35TB_s": min_bytes / med / HBM_BYTES_PER_S}
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def _buffers(table):
    out = []
    for c in table.columns:
        for name in ("values", "codes", "validity"):
            a = getattr(c, name, None)
            if a is not None and hasattr(a, "shape"):
                out.append(a)
    return out


def run_cases(reps, n_filter=10_000_000, n_group=100_000_000,
              high_groups=10_000_000, low_groups=1_000):
    """Time every case; returns the JSON records (also printed)."""
    import jax
    import jax.numpy as jnp
    import arrow_tpu as at
    from arrow_tpu import compute as ops
    from arrow_tpu.ops import groupby as gb
    recs = []

    # filter_table: 10M x 4 int64, 50% selectivity
    n = n_filter
    h = jax.jit(_mix, static_argnums=(0, 1))(n, 1)
    cols = [(h >> jnp.uint64(8 * i)).astype(jnp.int64) for i in range(4)]
    t = at.Table.from_pydict({f"c{i}": at.column(c)
                              for i, c in enumerate(cols)})
    pred = at.column((h & jnp.uint64(1)) == 0)
    kept = int(jnp.sum(pred.values))
    recs.append(_report(
        "filter_table", _time(lambda: _buffers(ops.filter_table(t, pred)),
                              reps),
        4 * 8 * n + n + 4 * 8 * kept, rows=n, kept=kept))
    del t, pred, cols, h

    n = n_group
    aggs = [gb.AggSpec("v", op) for op in ("sum", "count", "min", "max")]

    @jax.jit
    def gen(groups):
        h = _mix(n, 7)
        return ((h % jnp.uint64(groups)).astype(jnp.int64),
                ((h >> jnp.uint64(32)) % jnp.uint64(1000))
                .astype(jnp.int64))

    key, val = gen(high_groups)
    t = at.Table.from_pydict({"k": at.column(key), "v": at.column(val)})
    out = ops.group_by(t, ["k"], aggs)
    ng = out.num_rows
    recs.append(_report(
        "packed_group",
        _time(lambda: _buffers(ops.group_by(t, ["k"], aggs)), reps),
        16 * n + ng * (8 + 4 * 8), rows=n, groups=ng))
    del t, out, key, val

    key, val = gen(low_groups)
    words = at.column([f"key-{i:04d}" for i in range(low_groups)])
    t = at.Table.from_pydict({
        "k": at.DictionaryColumn(key.astype(jnp.int32), words),
        "v": at.column(val)})
    fast = _time(lambda: _buffers(ops.group_by(t, ["k"], aggs)), reps)
    real = gb._dictionary_fast_path
    gb._dictionary_fast_path = lambda *a: None
    try:
        general = _time(lambda: _buffers(ops.group_by(t, ["k"], aggs)),
                        reps)
    finally:
        gb._dictionary_fast_path = real
    recs.append(_report("dict_fast", fast, 12 * n, rows=n,
                        groups=low_groups))
    recs.append(_report("dict_general", general, 12 * n, rows=n,
                        groups=low_groups))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print("plan_timings: no GPU found", file=sys.stderr)
        return 1
    from arrow_tpu.config import enable_compile_cache

    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    dev = jax.devices()[0]
    print(f"nvidia-smi: {smi.stdout.strip()} | jax {jax.__version__} | "
          f"{dev.device_kind}", flush=True)
    recs = run_cases(args.reps)
    if args.out:
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
