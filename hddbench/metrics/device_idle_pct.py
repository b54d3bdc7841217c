"""Share of the traced solves' untraced time in which no operation ran on
the device, %: 100 (1 - busy / untraced), busy the union of device
operation intervals in the trace of the device alone, untraced the time of
the same solves, on the same inputs, without the profiler (whose tracing
slows the host's dispatch, and so would count its own cost as idle)."""


def read(run):
    t = run.trace
    if t is None or t.untraced_s <= 0 or t.summary.device_ops == 0:
        return None
    return 100.0 * (1.0 - t.summary.busy_s / t.untraced_s)
