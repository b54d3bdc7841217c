"""o = 2 x + y: CUDA kernel wrapper and its plain PyTorch version.

The counterpart of the reference's Pallas compile probe
(``scripts/pallas_minimal_repro.py``), kept as the smallest kernel of the
build route.  CUDA tensors go to ``csrc/probe.cu``; CPU tensors go to
``probe_reference``.  The two agree bitwise.

The kernel moves float4s when x, y and o lie at the same offset modulo 16
bytes, with a scalar head and tail, and runs the whole range scalar
otherwise.  When x and y share an offset, ``probe`` allocates o at that
offset too, so only inputs at different offsets (``x[1:]`` beside a fresh
``y``) take the scalar path; those launches are counted again in
``kernel.probe.scalar`` while recording.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.profiling import count, count_launch
from . import build

__all__ = ["probe", "probe_reference"]


def probe_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 2 * x + y


@lru_cache(maxsize=None)
def _kernel():
    fn = build.load("probe").probe_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _output_like(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """An empty o; at x's offset modulo 16 bytes when y shares it."""
    shift = x.data_ptr() % 16
    if shift == 0 or y.data_ptr() % 16 != shift:
        return torch.empty_like(x)
    pad = shift // x.element_size()  # the allocator's blocks start 16-byte aligned
    return torch.empty(x.numel() + pad, dtype=x.dtype, device=x.device)[pad:].view(x.shape)


def probe(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 x + y for float32 tensors of one shape and device.  On CUDA tensors
    this launches the kernel (counted while recording in ``kernel.probe``,
    and in ``kernel.probe.scalar`` when the offsets force the scalar path); on CPU
    tensors it is ``probe_reference``."""
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
    if x.numel() == 0:
        return torch.empty_like(x)
    o = _output_like(x, y)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vector_path = ctypes.c_int(0)
    err = _kernel()(x.data_ptr(), y.data_ptr(), o.data_ptr(), x.numel(), x.device.index, stream,
                    ctypes.byref(vector_path))
    if err != 0:
        raise RuntimeError(f"probe launch failed: cudaError {err}")
    count_launch("probe")
    if not vector_path.value:
        count("kernel.probe.scalar")
    return o
