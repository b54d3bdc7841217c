"""The plane SpMV of the SWIPDG stencil operator: CUDA kernel wrapper and its
plain PyTorch version.

``plane_spmv(W, X, plan)`` computes, for planes W [4, 3, 3, 8, KY, KX] and a
field X [3, 8, KY, KX] (see ``csrc/plane_spmv.cu`` for the formula),

    Y[i] = sum_s sum_j W[s, i, j] * X_s[j],

where X_0 = X and X_{s+1} holds, for subclass k, X[:, ks] rolled by
(-dy, -dx) with (ks, dy, dx) = plan[k][s].  CUDA tensors go to the
hand-written kernel; CPU tensors go to ``plane_spmv_reference``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build

__all__ = ["plane_spmv", "plane_spmv_reference"]

_FUNCS = {torch.float32: "plane_spmv_f32", torch.float64: "plane_spmv_f64"}


def plane_spmv_reference(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Plain PyTorch version: 24 lattice rolls and 36 multiply-adds, in the
    summation order of the reference package's StencilBlockEll.matvec."""
    fields = [X]
    for s in range(3):
        per_k = []
        for k in range(8):
            ks, dy, dx = plan[k][s]
            per_k.append(torch.roll(X[:, ks], shifts=(-dy, -dx), dims=(1, 2)))
        fields.append(torch.stack(per_k, dim=1))
    acc = []
    for i in range(3):
        t = W[0, i, 0] * X[0]
        for s in range(4):
            for j in range(3):
                if s or j:
                    t = torch.addcmul(t, W[s, i, j], fields[s][j])
        acc.append(t)
    return torch.stack(acc, dim=0)


@lru_cache(maxsize=None)
def _plan_array(plan) -> ctypes.Array:
    flat = [int(v) for row in plan for entry in row for v in entry]
    if len(flat) != 72:
        raise ValueError(f"plan must be 8 x 3 (ks, dy, dx) triples, got {plan!r}")
    return (ctypes.c_int * 72)(*flat)


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("plane_spmv"), _FUNCS[dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(W: torch.Tensor, X: torch.Tensor) -> None:
    if W.dim() != 6 or tuple(W.shape[:4]) != (4, 3, 3, 8):
        raise ValueError(f"planes must be [4, 3, 3, 8, KY, KX], got {tuple(W.shape)}")
    if tuple(X.shape) != (3, 8) + tuple(W.shape[4:]):
        raise ValueError(f"X must be [3, 8, {W.shape[4]}, {W.shape[5]}], got {tuple(X.shape)}")
    if W.dtype not in _FUNCS or X.dtype != W.dtype:
        raise TypeError(f"planes and X must share dtype float32 or float64, "
                        f"got {W.dtype} and {X.dtype}")
    if W.device != X.device:
        raise ValueError(f"planes on {W.device} but X on {X.device}")
    if not (W.is_contiguous() and X.is_contiguous()):
        raise ValueError("planes and X must be contiguous")


def plane_spmv(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Y = A X for the stencil operator with planes W (see module docstring).

    ``plan``: 8 x 3 tuple of (ks, dy, dx).  On CUDA tensors this launches
    the kernel (and counts the launch in ``plane_spmv.launches``); on CPU
    tensors it is ``plane_spmv_reference``."""
    _check(W, X)
    if W.device.type == "cpu":
        return plane_spmv_reference(W, X, plan)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    Y = torch.empty_like(X)
    KY, KX = W.shape[4], W.shape[5]
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = _kernel(W.dtype)(W.data_ptr(), X.data_ptr(), Y.data_ptr(), KY, KX,
                           _plan_array(plan), W.device.index, stream)
    if err != 0:
        raise RuntimeError(f"plane_spmv launch failed: cudaError {err}")
    plane_spmv.launches += 1
    return Y


plane_spmv.launches = 0
