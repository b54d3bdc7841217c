"""Device-level profiling on ``torch.profiler``, integrated with the
phase-timing registry (``utils/logging.py``).

Counterpart of ``dune_hdd_tpu/utils/profiling.py``:

* ``trace(logdir)``: a context manager that records the host ops and, on a
  card, the device kernels of everything run inside it, and writes them as
  a Chrome / Perfetto trace (``<logdir>/trace.json``; open it in
  ``chrome://tracing`` or ui.perfetto.dev).
* ``annotate(name)``: a ``record_function`` region (named in the trace) and
  a span in the phase-timing registry.
* ``profile_report()``: the registry aggregated to a printable table
  (calls / total / mean per phase).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from .logging import _TIMINGS, reset_timings, timings

__all__ = ["trace", "annotate", "profile_report"]


@contextmanager
def trace(logdir: str):
    """Profile the block; on exit write ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextmanager
def annotate(name: str):
    """Named region: a ``torch.profiler.record_function`` (visible in
    traces) and a span in the phase-timing registry."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _TIMINGS.setdefault(name, []).append(time.perf_counter() - t0)


def profile_report(reset: bool = False) -> str:
    """Aggregate the phase registry into a table (name, calls, total, mean)."""
    rows = []
    for name, vals in sorted(timings().items()):
        rows.append((name, len(vals), sum(vals), sum(vals) / len(vals)))
    width = max([len(r[0]) for r in rows], default=10)
    lines = [f"{'phase':{width}s}  calls   total[s]    mean[s]"]
    for name, n, tot, mean in rows:
        lines.append(f"{name:{width}s}  {n:5d}  {tot:9.4f}  {mean:9.4f}")
    if reset:
        reset_timings()
    return "\n".join(lines)
