"""Phase timing.

Counterpart of ``timed``, ``timings`` and ``reset_timings`` in
``dune_hdd_tpu/utils/logging.py``: a context manager that records each
phase's seconds in a process-wide registry that reports read.  The
reference's logger factory and its "<phase>... done" lines wait for the CLI
(ROADMAP queue 1, slice 6).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import torch

__all__ = ["timed", "timings", "reset_timings"]

_TIMINGS: Dict[str, List[float]] = {}


@contextmanager
def timed(phase: str, sync=None):
    """Records the seconds of the phase.  ``sync``: a device to synchronize
    before the clock stops, so the time covers the phase's device work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None and torch.device(sync).type == "cuda":
            torch.cuda.synchronize(sync)
        _TIMINGS.setdefault(phase, []).append(time.perf_counter() - t0)


def timings() -> Dict[str, List[float]]:
    return dict(_TIMINGS)


def reset_timings():
    _TIMINGS.clear()
