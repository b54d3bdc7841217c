"""Logging and phase timing (Stuff::Common::Logger / DSC::TimedLogger analog).

Counterpart of ``dune_hdd_tpu/utils/logging.py``: a logger factory with the
reference's [logging] flags (info / debug / file, discreteproblem.hh:104-115),
a ``timed`` context manager that opens a span of the phase in the port's
record (``utils/profiling.py``; kept only while recording) and, given a
logger, writes the reference's "<phase>... done (took Xs)" lines, and a
scoped logger with elapsed-time prefixes.
"""
from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Optional

import torch

from . import profiling
from .profiling import reset_timings, timings

__all__ = ["create_logger", "timed", "timings", "reset_timings", "TimedLogger"]


def create_logger(config: Optional[dict] = None, name: str = "dune_hdd_tpu_torch"
                  ) -> logging.Logger:
    """[logging] flags: info / debug / file (discreteproblem.hh:104-115)."""
    cfg = dict(config or {})
    logger = logging.getLogger(name)
    logger.handlers.clear()
    level = logging.WARNING
    if cfg.get("debug"):
        level = logging.DEBUG
    elif cfg.get("info", True):
        level = logging.INFO
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    if cfg.get("file"):
        fh = logging.FileHandler(str(cfg.get("filename", name + ".log")))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
    return logger


@contextmanager
def timed(phase: str, logger: Optional[logging.Logger] = None, sync=None):
    """The phase as a span of the record, and its "<phase>..." log lines.
    ``sync``: a device to synchronize before the clock stops, so the time
    covers the phase's device work (only where a time is taken: while
    recording or for the logger)."""
    if logger:
        logger.info(f"{phase}...")
    t0 = time.perf_counter()
    with profiling.span(phase):
        try:
            yield
        finally:
            if (sync is not None and (logger or profiling._ON)
                    and torch.device(sync).type == "cuda"):
                torch.cuda.synchronize(sync)
    if logger:
        logger.info(f"{phase}... done (took {time.perf_counter() - t0:.3f}s)")


class TimedLogger:
    """DSC::TimedLogger-style scoped logger with elapsed-time prefixes."""

    def __init__(self, name: str = "dune_hdd_tpu_torch", info: bool = True,
                 debug: bool = False):
        self._logger = create_logger({"info": info, "debug": debug}, name)
        self._t0 = time.perf_counter()

    def _prefix(self) -> str:
        return f"[{time.perf_counter() - self._t0:8.3f}s] "

    def info(self, msg: str):
        self._logger.info(self._prefix() + msg)

    def debug(self, msg: str):
        self._logger.debug(self._prefix() + msg)

    def warn(self, msg: str):
        self._logger.warning(self._prefix() + msg)
