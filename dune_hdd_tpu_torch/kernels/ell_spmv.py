"""The scalar-ELL SpMV of ``SparseMatrix.matvec``: CUDA kernel wrapper and
its plain PyTorch version.

``ell_spmv(ell_vals, ell_cols, x)`` computes, for ELL values [N, K]
(float32 or float64), int32 columns [N, K] and x [M] of the values' type,

    y[i] = sum_k ell_vals[i, k] * x[ell_cols[i, k]],

padded slots (value 0, column 0) included.  CUDA tensors go to the
hand-written kernel (``csrc/ell_spmv.cu``), launched with the tile and
ring that ``ell_geometry`` computes from N, K and the value type; CPU
tensors go to ``ell_spmv_reference``, the gather, product and row sum.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.profiling import count_launch
from . import build

__all__ = ["ell_spmv", "ell_spmv_reference", "ell_geometry"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

# The kernel's launch geometry (csrc/ell_spmv.cu).
MAX_THREADS = 512         # rows in flight on an SM, one a thread
STAGES = 2                # the ring: one tile computed while the next streams in
HEADER_BYTES = 128        # the ring's mbarriers
STAGE_TARGET = 48 * 1024  # short rows: several a thread, up to a stage of this
SMEM_PER_BLOCK = 232448   # 227 KB at most for one block on an H100


def ell_spmv_reference(ell_vals: torch.Tensor, ell_cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather x by column, multiply, sum each row."""
    return (ell_vals * x[ell_cols]).sum(dim=1)


@lru_cache(maxsize=None)
def ell_geometry(n: int, K: int, itemsize: int, sms: int) -> tuple:
    """(rows per tile R, threads, dynamic shared memory bytes) for N = ``n``
    rows of ``K`` slots of ``itemsize``-byte values on a card of ``sms``
    SMs.  A stage holds as many rows as fit STAGES times in one block, at
    most MAX_THREADS with one thread a row (a multiple of 32), or several
    a thread while a stage stays under STAGE_TARGET bytes; rows too long
    for 32 a stage take 32 threads and fewer rows, a multiple of 4.  A
    small matrix gets shorter tiles, so that it spreads over every SM.
    Raises ValueError for rows too long for 4 a stage."""
    entry = K * (itemsize + 4)
    fit = (SMEM_PER_BLOCK - HEADER_BYTES) // (STAGES * entry)
    threads = min(MAX_THREADS, fit // 32 * 32)
    if threads:
        R = threads * max(1, STAGE_TARGET // (threads * entry))
    else:
        R, threads = fit // 4 * 4, 32
    if R < 4:
        raise ValueError(f"ELL rows of K = {K} slots of {itemsize}-byte values leave no room "
                         f"for {STAGES} stages of 4 rows")
    per_sm = -(-n // sms)
    R = min(R, -(-per_sm // 4) * 4)
    threads = min(threads, -(-R // 32) * 32)
    return R, threads, HEADER_BYTES + STAGES * R * entry


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("ell_spmv"), "ell_spmv_" + _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(ell_vals: torch.Tensor, ell_cols: torch.Tensor, x: torch.Tensor) -> None:
    """Shapes, dtypes, devices and contiguity."""
    if ell_vals.dim() != 2 or tuple(ell_cols.shape) != tuple(ell_vals.shape):
        raise ValueError(f"ELL values and columns must be one [N, K] shape, got "
                         f"{tuple(ell_vals.shape)} and {tuple(ell_cols.shape)}")
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got shape {tuple(x.shape)}")
    if ell_vals.dtype not in _DTYPES or x.dtype != ell_vals.dtype:
        raise TypeError(f"ELL values and x must share dtype float32 or float64, "
                        f"got {ell_vals.dtype} and {x.dtype}")
    if ell_cols.dtype != torch.int32:
        raise TypeError(f"ELL columns must be int32, got {ell_cols.dtype}")
    if not (ell_vals.device == ell_cols.device == x.device):
        raise ValueError(f"values on {ell_vals.device}, columns on {ell_cols.device}, "
                         f"x on {x.device}")
    if not (ell_vals.is_contiguous() and ell_cols.is_contiguous() and x.is_contiguous()):
        raise ValueError("ELL values, columns and x must be contiguous")


def _launch(ell_vals: torch.Tensor, ell_cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launches the kernel on CUDA tensors that ``_check`` passed; returns y."""
    if ell_vals.device.type != "cuda":
        raise ValueError(f"unsupported device {ell_vals.device}")
    n, K = ell_vals.shape
    if x.numel() == 0:
        raise ValueError(f"x is empty but the matrix has {n} rows")
    if n >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError(f"{n} rows or {x.numel()} columns pass the kernel's 32-bit indices")
    if ell_vals.data_ptr() % 16 or ell_cols.data_ptr() % 16:
        raise ValueError("the kernel reads ELL values and columns by bulk copies: they must "
                         "be 16-byte aligned")
    R, threads, smem = ell_geometry(n, K, ell_vals.element_size(), _sms(ell_vals.device))
    y = torch.empty(n, dtype=ell_vals.dtype, device=ell_vals.device)
    stream = torch.cuda.current_stream(ell_vals.device).cuda_stream
    err = _kernel(ell_vals.dtype)(ell_vals.data_ptr(), ell_cols.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), n, K, R, threads, smem, ell_vals.device.index,
                                  stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv launch failed: cudaError {err}")
    return y


def ell_spmv(ell_vals: torch.Tensor, ell_cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the ELL matrix (``ell_vals``, ``ell_cols``), see the
    module docstring.  On CUDA tensors this launches the kernel, counted
    while recording (``utils/profiling.count_launch``) in
    ``kernel.ell_spmv``, and raises for an input it does not take; on CPU
    tensors it is ``ell_spmv_reference``."""
    _check(ell_vals, ell_cols, x)
    if ell_vals.device.type == "cpu":
        return ell_spmv_reference(ell_vals, ell_cols, x)
    if ell_vals.shape[0] == 0:  # nothing to launch
        return ell_vals.new_empty(0)
    y = _launch(ell_vals, ell_cols, x)
    count_launch("ell_spmv")
    return y
