"""o = 2 x + y: CUDA kernel wrapper and its plain PyTorch version.

The counterpart of the reference's Pallas compile probe
(``scripts/pallas_minimal_repro.py``), kept as the smallest kernel of the
build route.  CUDA tensors go to ``csrc/probe.cu``; CPU tensors go to
``probe_reference``.  The two agree bitwise.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build

__all__ = ["probe", "probe_reference"]


def probe_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 2 * x + y


@lru_cache(maxsize=None)
def _kernel():
    fn = build.load("probe").probe_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 x + y for float32 tensors of one shape and device.  On CUDA tensors
    this launches the kernel (counted in ``probe.launches``); on CPU tensors
    it is ``probe_reference``."""
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x and y must be float32, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    if x.device.type == "cpu":
        return probe_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    o = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), y.data_ptr(), o.data_ptr(), x.numel(), x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"probe launch failed: cudaError {err}")
    probe.launches += 1
    return o


probe.launches = 0
