"""Reduction of ``torch.profiler`` traces to what the metrics read: the
device-busy union over the traced window and device time by operation,
from a trace of the device alone, and the idle gaps labelled by the host
operation they fall in, from a second trace that records the host too.

The busy union and the gap walk are ``dune_hdd_tpu_torch/profile_bench.py``'s
arithmetic, copied so that the yardstick stays with the benchmark.
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["TraceSummary", "summarize", "busy_union"]


class TraceSummary(NamedTuple):
    busy_s: float        # union of device operation intervals
    window_s: float      # the traced window (host clock)
    device_s: dict       # device seconds by operation name
    idle_by_host: dict   # idle seconds by the innermost host operation around each gap
    device_ops: int      # device operations traced


def busy_union(intervals):
    """(busy, gaps) of sorted (start, end) intervals: the length of their
    union and the gaps between its pieces."""
    busy, gaps, end = 0.0, [], None
    for a, b in intervals:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def _label_gaps(gaps, host):
    """Idle seconds per host operation: each gap (nanoseconds) goes to the
    innermost host interval (latest start) that holds its midpoint, or to
    "(none)"."""
    host = sorted(host)  # (start, -end, name)
    out: dict = {}
    stack, k = [], 0
    for g0, g1 in sorted(gaps):
        t = 0.5 * (g0 + g1)
        while k < len(host) and host[k][0] <= t:
            stack.append(host[k])
            k += 1
        while stack and -stack[-1][1] < t:
            stack.pop()
        name = "(none)"
        for s in reversed(stack):
            if -s[1] >= t:
                name = s[2]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
    return out


def _split(events):
    """(sorted device intervals, device seconds by name, host intervals)."""
    from torch.autograd import DeviceType

    device, host, by_name = [], [], {}
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((a, b))
            name = e.name()
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        elif b > a:
            host.append((a, -b, e.name()))
    device.sort()
    return device, by_name, host


def summarize(events, window_s: float, labelled) -> TraceSummary:
    """``events``: the profiler's raw events of a pass that traced the
    device alone (``prof.profiler.kineto_results.events()``, which skips
    building the event tree of ``prof.events()``), over ``window_s``;
    ``labelled``: those of a pass that traced the host's operations too,
    whose idle gaps are labelled.  Times in nanoseconds."""
    device, by_name, _ = _split(events)
    busy, _ = busy_union(device)
    ldevice, _, host = _split(labelled)
    _, gaps = busy_union(ldevice)
    return TraceSummary(busy * 1e-9, window_s, by_name, _label_gaps(gaps, host), len(device))


def top(d: dict, n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
