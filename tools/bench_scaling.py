"""Scaling-efficiency harness: distributed operators at 1..N devices
(SURVEY.md §7 M6: "scaling-efficiency harness 1 chip -> N hosts").

Measures rows/s for the shard_map operators (hash-shuffle group-by,
range-partitioned sort, FK join, skew-aware join) at every power-of-two
device count available, and reports efficiency vs the 1-device run
(ideal = 1.0: N devices process N x the rows in the same time — weak
scaling).

Without several devices, run with virtual CPU devices to validate the
harness and the collective structure:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/bench_scaling.py --cpu

On a host with several GPUs, run without --cpu: the same meshes ride
NVLink and the numbers are the BASELINE config-5 scaling measurement.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU backend (virtual devices)")
    ap.add_argument("--rows-per-device", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    import arrow_tpu  # noqa: F401
    from arrow_tpu import parallel as par

    ndev_all = jax.device_count()
    per = args.rows_per_device
    rng = np.random.default_rng(0)
    results = {}

    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev_all]
    # weak scaling PER OPERATOR (VERDICT r4 item 3: efficiency numbers
    # per operator, not one fused step)
    results = {op: {} for op in ("group_by", "sort", "join_unique",
                                 "join_skew", "fused")}
    for nd in counts:
        mesh = par.make_mesh(nd)
        axis = par.shard_axis(mesh)
        n = per * nd
        keys = jnp.asarray(rng.integers(0, 1 << 20, n, dtype=np.uint64))
        vals = jnp.asarray(rng.integers(-1000, 1000, n).astype(np.int64))
        ok = jnp.ones((n,), jnp.bool_)
        bkeys = jnp.asarray(np.arange(n, dtype=np.uint64))
        bok = jnp.ones((n,), jnp.bool_)
        bvals = jnp.asarray(np.arange(n, dtype=np.int64))

        def shmap(fn, n_out):
            return jax.jit(functools.partial(
                jax.shard_map, mesh=mesh, in_specs=(P(axis),) * 6,
                out_specs=(P(axis),) * n_out)(fn))

        def op_group_by(k, v, m, bk, bm, bv):
            gk, gv, (gsum,), _ = par.dist_group_by(
                axis, k, m, per, per, [("sum", v)])
            return (gsum,)

        def op_sort(k, v, m, bk, bm, bv):
            sk, svalid, _, _ = par.dist_sort(axis, k, m, per * 2)
            return (sk,)

        def op_join_unique(k, v, m, bk, bm, bv):
            jk, jvalid, _, hit, (got,), _ = par.dist_join_unique(
                axis, k, m, (v,), bk, bm, (bv,), per * 2, per * 2)
            return (got,)

        def op_join_skew(k, v, m, bk, bm, bv):
            light, (hit_h, (got_h,), _) = par.dist_join_skew(
                axis, k, m, (v,), bk, bm, (bv,), n, n,
                heavy_cap=8, build_heavy_cap=8 * nd,
                heavy_min_frac=1.0 / 8)
            return (got_h,)

        def op_fused(k, v, m, bk, bm, bv):
            gk, gv, (gsum,), _ = par.dist_group_by(
                axis, k, m, per, per, [("sum", v)])
            sk, svalid, _, _ = par.dist_sort(axis, k, m, per * 2)
            return (gsum, sk)

        ops = {"group_by": (op_group_by, 1), "sort": (op_sort, 1),
               "join_unique": (op_join_unique, 1),
               "join_skew": (op_join_skew, 1), "fused": (op_fused, 2)}
        for name, (fn, n_out) in ops.items():
            step = shmap(fn, n_out)

            def run():
                out = step(keys, vals, ok, bkeys, bok, bvals)
                return float(np.asarray(out[0]).ravel()[0])

            run()                                 # compile + warm
            t0 = time.perf_counter()
            for _ in range(args.reps):
                run()
            dt = (time.perf_counter() - t0) / args.reps
            results[name][nd] = n / dt
            print(f"devices={nd:>2}  {name:<12} rows={n:>9}  "
                  f"{dt*1e3:8.1f} ms  {n/dt/1e6:8.2f} Mrows/s",
                  flush=True)

    out = {"metric": "dist_weak_scaling_efficiency",
           "per_device_rows": per,
           "backend": jax.default_backend(),
           "operators": {}}
    for name, res in results.items():
        base = res[counts[0]] / counts[0]
        out["operators"][name] = {
            "rows_per_s": {str(k): round(v) for k, v in res.items()},
            "efficiency": {str(k): round(v / (k * base), 3)
                           for k, v in res.items()},
            # on a time-shared host (N virtual devices, 1 physical
            # core) weak-scaling efficiency is bounded by 1/N; absolute
            # throughput retention is the host-meaningful number
            # (1.0 = collectives add zero overhead)
            "throughput_retention": {
                str(k): round(v / res[counts[0]], 3)
                for k, v in res.items()},
        }
    if out["backend"] == "cpu":
        out["note"] = ("virtual CPU mesh = structural validation only; "
                       "see throughput_retention (1/N efficiency bound "
                       "on a time-shared core)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
