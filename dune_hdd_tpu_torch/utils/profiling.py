"""The port's spans and counters, and device-level profiling on
``torch.profiler``.

Counterpart of ``dune_hdd_tpu/utils/profiling.py``.  One store, off by
default:

* ``recording()``: a context manager that turns recording on and yields
  the ``Record``; everything stays in it, in memory, until the caller reads
  it.  On exit it synchronizes the device once and resolves the device
  durations of the spans that asked for them.
* ``span(name, device=False)``: a named region.  Each span holds its name,
  host start and end (``time.perf_counter_ns``), the index of its parent
  span and a solve id: a root span opens a new solve id and every span
  nested under it shares it.  While a ``torch.profiler`` is active the span
  also opens ``record_function("hdd::<name>")``, so the device trace holds
  the program's spans on its own clock.  Otherwise a span opened with
  ``device=True`` records a CUDA event pair on the current stream, without
  a synchronization, and its device duration is resolved when recording
  ends (on the CPU the host clock stands in).
* ``count(name, n=1)``: adds to a counter, on the innermost open span and
  in the record's totals.  ``host_read(t)`` is ``t.item()`` and
  ``upload(a, device)`` a copy to the device, each counted in
  ``host.syncs``; each raises ``SyncInCapture`` while the current CUDA
  stream captures a graph, which cannot hold a wait for the device.
  ``count_launch`` counts a kernel launch; ``capturing()`` says whether
  the current CUDA stream captures a graph.
* ``captured_counts()``: the counts made while a CUDA graph is captured,
  kept apart from the record; the graph's work runs at each replay, whose
  caller counts them again.
* ``trace(logdir)``: records the host ops and, on a card, the device
  kernels of everything run inside it, the ``hdd::`` spans included, and
  writes them as a Chrome / Perfetto trace (``<logdir>/trace.json``).
* ``span_breakdown(events)``: a profiler trace taken while recording,
  reduced to device time, device operations and idle time by the stack of
  ``hdd::`` spans that launched or held them.
* ``annotate`` (a span), ``timings()`` and ``profile_report()``: the phase
  view of the same record (``utils/logging.timed`` opens spans too).

When recording is off, ``span`` returns one shared no-op context after a
single module-level check, and ``count`` returns after the same check: no
``record_function``, no CUDA event, no allocation, no dict update.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["Record", "Span", "recording", "span", "count", "host_read", "upload",
           "count_launch", "SyncInCapture", "captured_counts", "capturing",
           "trace", "annotate", "timings", "reset_timings", "profile_report",
           "SpanBreakdown", "span_breakdown", "SPAN_PREFIX"]

SPAN_PREFIX = "hdd::"   # the spans' names in a profiler trace

_ON = False                       # the one check of the off path
_REC: Optional["Record"] = None   # the record being written
_LAST: Optional["Record"] = None  # the record last written (``timings``)
_NULL = nullcontext()             # the span of the off path
_CAPTURED: Optional[Dict[str, int]] = None  # the counts of a graph being captured


class Span:
    """One span: name, host start and end in ns, parent index (None for a
    root), solve id, the counts made while it was innermost, and its device
    seconds once resolved (None: host clock only)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "solve", "counts", "device_s",
                 "_events")

    def __init__(self, name: str, parent: Optional[int], solve: int):
        self.name, self.parent, self.solve = name, parent, solve
        self.start_ns = self.end_ns = 0
        self.counts: Optional[Dict[str, int]] = None
        self.device_s: Optional[float] = None
        self._events = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def seconds(self) -> float:
        """Device seconds where resolved, else host seconds."""
        return self.host_s if self.device_s is None else self.device_s


class Record:
    """The spans (in the order they opened) and counter totals of one
    ``recording()``."""

    def __init__(self, cuda: bool):
        self.spans: List[Span] = []
        self.totals: Dict[str, int] = {}
        self.cuda = cuda
        self._stack: List[int] = []
        self._solves = 0

    def seconds(self, name: str) -> List[float]:
        """Each ``name`` span's seconds (device-timed where resolved)."""
        return [s.seconds for s in self.spans if s.name == name]

    def timings(self) -> Dict[str, List[float]]:
        """Host seconds by span name."""
        out: Dict[str, List[float]] = {}
        for s in self.spans:
            out.setdefault(s.name, []).append(s.host_s)
        return out

    def total(self, name: str, solve: Optional[int] = None) -> int:
        """Counter ``name`` over the record, or over the spans of one solve."""
        if solve is None:
            return self.totals.get(name, 0)
        return sum(s.counts.get(name, 0) for s in self.spans if s.solve == solve and s.counts)

    def totals_under(self, prefix: str) -> Dict[str, int]:
        """The counters whose names start with ``prefix``, the prefix cut off."""
        return {k[len(prefix):]: v for k, v in self.totals.items() if k.startswith(prefix)}

    def solves(self) -> List[int]:
        return sorted({s.solve for s in self.spans})

    def path(self, index: int) -> tuple:
        """Names from the root down to span ``index``."""
        names = []
        while index is not None:
            s = self.spans[index]
            names.append(s.name)
            index = s.parent
        return tuple(reversed(names))

    def resolve(self) -> None:
        """Device seconds of the spans that recorded CUDA events (one
        synchronization)."""
        timed = [s for s in self.spans if s._events is not None]
        if not timed:
            return
        torch.cuda.synchronize()
        for s in timed:
            start, end = s._events
            s.device_s = start.elapsed_time(end) * 1e-3
            s._events = None


class _Open:
    """The context of one span while recording."""

    __slots__ = ("rec", "name", "device", "span", "rf")

    def __init__(self, rec: Record, name: str, device: bool):
        self.rec, self.name, self.device, self.rf = rec, name, device, None

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        if parent is None:
            rec._solves += 1
        s = Span(self.name, parent, rec._solves if parent is None else rec.spans[parent].solve)
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()
        elif self.device and rec.cuda:
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            s._events[0].record()
        rec._stack.append(len(rec.spans))
        rec.spans.append(s)
        self.span = s
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        s = self.span
        s.end_ns = time.perf_counter_ns()
        if s._events is not None:
            s._events[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._stack.pop()
        return False


@contextmanager
def recording():
    """Turns recording on for the block and yields the ``Record``; with a
    card, ``device=True`` spans time themselves with CUDA events.  Nested,
    the inner block shares the outer record."""
    global _ON, _REC, _LAST
    if _ON:
        yield _REC
        return
    rec = Record(torch.cuda.is_available())
    _REC, _ON = rec, True
    try:
        yield rec
    finally:
        _ON, _REC, _LAST = False, None, rec
        rec.resolve()


def span(name: str, device: bool = False):
    """A named region of the record (module docstring); ``device``: time it
    on the device too (the coarse spans)."""
    if not _ON:
        return _NULL
    return _Open(_REC, name, device)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``: on the innermost open span and in the
    record's totals, or, while a graph is captured, to its counts."""
    if not _ON:
        return
    if _CAPTURED is not None:
        _CAPTURED[name] = _CAPTURED.get(name, 0) + n
        return
    rec = _REC
    rec.totals[name] = rec.totals.get(name, 0) + n
    if rec._stack:
        s = rec.spans[rec._stack[-1]]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


@contextmanager
def captured_counts():
    """Yields a dict that takes, instead of the record, the counts made in
    the block: the capture of a CUDA graph, which launches nothing itself.
    Each replay of the graph counts them."""
    global _CAPTURED
    outer, _CAPTURED = _CAPTURED, {}
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = outer


class SyncInCapture(RuntimeError):
    """A wait for the device asked for while the current CUDA stream
    captures a graph (``host_read``, ``upload``): the capture cannot hold it."""


def capturing() -> bool:
    """Whether the current CUDA stream captures a graph (False without a card)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _refuse_in_capture(what: str) -> None:
    if capturing():
        raise SyncInCapture(f"{what} waits for the device, which a CUDA graph capture "
                            "cannot hold")


def host_read(t: torch.Tensor):
    """``t.item()``, counted in ``host.syncs``: on a card the host waits for
    the device to reach the value (``SyncInCapture`` during a capture)."""
    _refuse_in_capture("host_read")
    count("host.syncs")
    return t.item()


def upload(a, device, dtype=None) -> torch.Tensor:
    """Host data (an array, a list) as a tensor on ``device``, counted in
    ``host.syncs``: a copy from pageable host memory to a card waits for the
    device (``SyncInCapture`` during a capture)."""
    _refuse_in_capture("upload")
    count("host.syncs")
    return torch.as_tensor(a, dtype=dtype).to(device)


_CASE_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def count_launch(kernel: str, planes: Optional[torch.Tensor] = None) -> None:
    """Counts one launch of ``kernel`` in ``kernel.<kernel>`` and, given its
    planes [.., nd, nd, 8, KY, KX], per instantiation and lattice in
    ``kernel.<kernel>.nd<nd>_<f32|f64> <KY>x<KX>``."""
    if not _ON:
        return
    count("kernel." + kernel)
    if planes is not None:
        count(f"kernel.{kernel}.nd{planes.shape[-5]}_{_CASE_DTYPES[planes.dtype]} "
              f"{planes.shape[-2]}x{planes.shape[-1]}")


def annotate(name: str):
    """A span (``span(name)``): a region of the record, named ``hdd::<name>``
    in a profiler trace."""
    return span(name)


def _current() -> Optional[Record]:
    return _REC if _ON else _LAST


def timings() -> Dict[str, List[float]]:
    """Host seconds by span name, of the record being written or else the
    last one."""
    rec = _current()
    return rec.timings() if rec is not None else {}


def reset_timings() -> None:
    """Forgets the last record (a record being written stays)."""
    global _LAST
    _LAST = None


@contextmanager
def trace(logdir: str):
    """Profile the block while recording; on exit write ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def profile_report(reset: bool = False) -> str:
    """The record's spans aggregated to a table (name, calls, total, mean)."""
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


# -- the span pass: a profiler trace by hdd:: span ----------------------------


class SpanBreakdown(NamedTuple):
    """A trace taken with host and device activity while recording, by the
    stack of ``hdd::`` spans (root first, prefix cut off; () outside any)."""

    device_s: dict     # stack -> device seconds of the operations launched in it
    ops: dict          # stack -> device operations launched in it
    idle_s: dict       # stack -> idle device seconds whose midpoint it held
    window_s: float    # first root span's start to last root span's end
    busy_s: float      # union of the device intervals inside the window
    device_ops: int    # device operations in the trace


def _nested(spans):
    """``spans`` (start, end, name), properly nested, sorted outermost first
    where they start together."""
    return sorted(spans, key=lambda iv: (iv[0], -iv[1]))


def _stacks_at(spans, times):
    """For each time (ns), the names of the spans that hold it, outermost
    first: one sweep over the sorted spans and times."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [()] * len(times)
    stack, k = [], 0
    for i in order:
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(iv[2] for iv in stack)
    return out


def _is_runtime(name: str) -> bool:
    return name.startswith("cu")  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...


def span_breakdown(events) -> SpanBreakdown:
    """``events``: the raw events (``prof.profiler.kineto_results.events()``)
    of a ``torch.profiler`` run with CPU and CUDA activity over solves run
    while recording.  Each device operation goes to the ``hdd::`` spans that
    held the host event that launched it: the runtime call of the same
    correlation id, else the operation it is linked to.  Each idle stretch
    of the device inside the window (between the device intervals, and
    before the first and after the last) goes to the spans holding its
    midpoint, so the idle seconds add up to window less busy.  Times in
    nanoseconds."""
    from torch.autograd import DeviceType

    spans, runtime, ops_at, device = [], {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):  # not a span's device-side annotation
                device.append(e)
        elif name.startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.end_ns(), name[len(SPAN_PREFIX):]))
        elif e.correlation_id():
            (runtime if _is_runtime(name) else ops_at).setdefault(e.correlation_id(),
                                                                  e.start_ns())
    spans = _nested(spans)
    device.sort(key=lambda e: e.start_ns())
    launched = [runtime.get(e.correlation_id(), ops_at.get(e.linked_correlation_id()))
                for e in device]
    known = [i for i, t in enumerate(launched) if t is not None]
    stacks = dict(zip(known, _stacks_at(spans, [launched[i] for i in known])))
    device_s: dict = {}
    ops: dict = {}
    for i, e in enumerate(device):
        key = stacks.get(i, ())
        device_s[key] = device_s.get(key, 0.0) + (e.end_ns() - e.start_ns()) * 1e-9
        ops[key] = ops.get(key, 0) + 1
    if not spans:
        return SpanBreakdown(device_s, ops, {}, 0.0, 0.0, len(device))
    w0, w1 = spans[0][0], max(iv[1] for iv in spans)
    busy, gaps, end = 0, [], w0
    for e in device:
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if b <= end:
            continue
        if a > end:
            gaps.append((end, a))
            busy += b - a
        else:
            busy += b - end
        end = b
    if end < w1:
        gaps.append((end, w1))
    idle: dict = {}
    for (g0, g1), key in zip(gaps, _stacks_at(spans, [0.5 * (g0 + g1) for g0, g1 in gaps])):
        idle[key] = idle.get(key, 0.0) + (g1 - g0) * 1e-9
    return SpanBreakdown(device_s, ops, idle, (w1 - w0) * 1e-9, busy * 1e-9, len(device))
