"""Shared arithmetic of the roofline readers: bytes the algorithm needs over
the device time of the named kernels, against the published bandwidth."""
import re

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth, bytes/s (at 700 W).
PEAK_BYTES_PER_S = 3.35e12


def kernel_seconds(run, pattern):
    t = run.trace
    if t is None:
        return 0.0
    rx = re.compile(pattern)
    return sum(s for name, s in t.summary.device_s.items() if rx.search(name))


def share_pct(bytes_needed, seconds):
    if not seconds or not bytes_needed:
        return None
    return 100.0 * bytes_needed / PEAK_BYTES_PER_S / seconds
