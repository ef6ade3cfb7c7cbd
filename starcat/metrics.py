"""Metrics / logging / observability (SURVEY.md §5.5) and tracing/profiling
helpers (SURVEY.md §5.1).

Reference status: matplotlib plots + prints (SURVEY.md §5.5 `[R]`).  Here:
per-window scalar metrics appended as JSONL by process 0, a
`jax.profiler.trace` context for TensorBoard/xprof captures, and an XLA
cost-analysis helper (flops and bytes of a compiled function).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import jax


class MetricsLogger:
    """Append-only JSONL metrics sink; no-ops on non-zero processes."""

    def __init__(self, path: str | None, run_name: str = "run"):
        self.run_name = run_name
        self._fh = None
        if path is not None and jax.process_index() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **scalars: Any) -> None:
        if self._fh is None:
            return
        rec = {"t": time.time(), "run": self.run_name, "event": event}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def timed(logger: MetricsLogger | None, event: str, **extra):
    """Wall-clock a block (device-synchronized at exit) and log it."""
    t0 = time.perf_counter()
    yield
    jax.block_until_ready(jax.numpy.zeros(()))
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log(event, wall_seconds=dt, **extra)


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """jax.profiler trace for TensorBoard/xprof; no-op if logdir is None."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


def cost_analysis(jitted_fn, *example_args) -> dict:
    """XLA cost analysis of a jitted callable on example args.

    Returns {'flops', 'bytes_accessed'} as the compiler counts them for the
    current backend.  No device peak is assumed here: a roofline share
    needs a peak table keyed by device_kind, kept with the benchmark.
    """
    compiled = jax.jit(jitted_fn).lower(*example_args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns a list per computation
        ca = ca[0]
    return {
        "flops": float(ca.get("flops", 0.0)),
        "bytes_accessed": float(
            ca.get("bytes accessed", ca.get("bytes_accessed", 0.0))),
    }
