"""Op timing + profiling glue (SURVEY.md §5: the reference has no
in-library tracing — criterion benches only; the engine's analog is a
thin op-timer layer over the JAX profiler).

- op_timer(name): context manager that times a block; the caller passes
  a sync hook (e.g. one that calls jax.block_until_ready on the result)
  so the time covers the device work, or gets plain wall time.
- OpTimings: thread-safe accumulator (count/total/max per op).
- trace(path): wraps jax.profiler.trace for XLA-level traces.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

__all__ = ["OpTimings", "op_timer", "timings", "trace", "reset_timings",
           "count", "counters_snapshot", "reset_counters"]


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0


class OpTimings:
    """Per-op wall-time accumulator (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = {}

    def record(self, name: str, seconds: float):
        with self._lock:
            s = self._stats.setdefault(name, _Stat())
            s.count += 1
            s.total_s += seconds
            s.max_s = max(s.max_s, seconds)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"count": v.count, "total_ms": v.total_s * 1e3,
                        "mean_ms": v.total_s / v.count * 1e3,
                        "max_ms": v.max_s * 1e3}
                    for k, v in self._stats.items()}

    def reset(self):
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        snap = sorted(self.snapshot().items(),
                      key=lambda kv: -kv[1]["total_ms"])
        lines = [f"{'op':<32}{'count':>8}{'total ms':>12}"
                 f"{'mean ms':>10}{'max ms':>10}"]
        for name, s in snap:
            lines.append(f"{name:<32}{s['count']:>8}"
                         f"{s['total_ms']:>12.2f}{s['mean_ms']:>10.3f}"
                         f"{s['max_ms']:>10.3f}")
        return "\n".join(lines)


timings = OpTimings()


def reset_timings():
    timings.reset()


@contextlib.contextmanager
def op_timer(name: str, sync: Optional[Callable] = None,
             sink: Optional[OpTimings] = None):
    """Time a block; `sync()` may be passed to force completion
    (e.g. lambda: jax.block_until_ready(x)).  Records into the global
    `timings` unless a sink is given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        (sink or timings).record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(path: str):
    """XLA-level profiler trace (view with TensorBoard / xprof)."""
    import jax
    with jax.profiler.trace(path):
        yield


# ---------------------------------------------------------------------------
# Decision counters: make plan choices observable (e.g. parquet
# page-skip pushdown effectiveness)
# ---------------------------------------------------------------------------

_counter_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Bump a named engine counter (thread-safe)."""
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters_snapshot() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counter_lock:
        _counters.clear()
