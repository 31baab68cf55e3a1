"""Operator-pipeline fusion: one XLA program per query, not per op.

The device-first answer to the reference's kernel-at-a-time API (SURVEY.md
§1 L3): columns are jax pytrees, so ANY chain of `arrow_tpu.compute`
ops over them jits into a single fused program — XLA fuses the
elementwise work, dead code is eliminated, and the per-op dispatch
overhead of the eager API is paid once.

    from arrow_tpu import fuse, compute as ops

    @fuse
    def query(x, y):
        m = ops.lt(ops.cast(x, dtp.float64), y)
        return ops.add(x, x), m

    out_col, mask = query(x_col, y_col)     # ONE device program

Rules (enforced by jax tracing):
  * shapes are static — one compile per distinct input shape;
  * ops that consult values on the host at trace time (dictionary /
    string predicates such as `ops.eq(dict_col, "lit")`, `like`) need
    the dictionary VALUES visible as constants: close over the
    dictionary column (or its values) instead of passing it as an
    argument, and pass the codes tensor;
  * output-size-dependent ops (filter materialization, group_by, join)
    sync to host and cannot live inside a fused region — use their
    capacity-padded static variants (`ops.filter.filter_static`) or
    call them between fused stages;
  * checked arithmetic cannot RAISE inside a fused region (the error
    flag is a tracer): checked ops behave as wrapping there — call
    them eagerly at stage boundaries when overflow detection matters.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["fuse"]


def fuse(fn=None, **jit_kwargs):
    """`jax.jit` for column pipelines (columns are pytrees).

    Accepts the same keyword arguments as `jax.jit` (static_argnums,
    donate_argnums, ...).  Usable bare (`@fuse`) or parameterized
    (`@fuse(static_argnums=1)`)."""
    if fn is None:
        return lambda f: fuse(f, **jit_kwargs)
    jitted = jax.jit(fn, **jit_kwargs)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return jitted(*args, **kwargs)
        except jax.errors.TracerArrayConversionError as e:
            raise RuntimeError(
                "arrow_tpu.fuse: an op inside this pipeline reads "
                "column VALUES on the host at trace time (dictionary/"
                "string predicates do). Close the dictionary column "
                "over the function instead of passing it as an "
                "argument, or run that op eagerly between fused "
                "stages.") from e

    wrapper._fused = jitted
    return wrapper
