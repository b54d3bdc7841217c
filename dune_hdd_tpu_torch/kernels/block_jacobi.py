"""The block-Jacobi apply of the stencil smoother: CUDA kernel wrapper and
its plain PyTorch version.

``block_jacobi(Dinv, R)`` computes, for the inverse diagonal blocks Dinv
[nd, nd, 8, KY, KX] and a field R [nd, 8, KY, KX] with nd in {3, 6, 10}
(DG P1, P2, P3 on triangles),

    Z[i] = sum_j Dinv[i, j] * R[j],

each Z[i] the product of its j = 0 term, then one fused multiply-add per
further j in j order.  CUDA tensors go to the hand-written kernel
(``csrc/block_jacobi.cu``): 16-byte loads where Dinv and R are 16-byte
aligned, one value a thread otherwise (counted while recording in
``kernel.block_jacobi.scalar``); CPU tensors go to
``block_jacobi_reference``.  The two agree bitwise on the card.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.profiling import count, count_launch
from . import build

__all__ = ["block_jacobi", "block_jacobi_reference"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
KERNEL_ND = (3, 6, 10)


def block_jacobi_reference(Dinv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per row i a product and nd - 1 ``addcmul`` in
    j order (the rounding of the reference's XLA contraction)."""
    nd = Dinv.shape[0]
    out = []
    for i in range(nd):
        t = Dinv[i, 0] * R[0]
        for j in range(1, nd):
            t = torch.addcmul(t, Dinv[i, j], R[j])
        out.append(t)
    return torch.stack(out)


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype, nd: int):
    fn = getattr(build.load("block_jacobi"), f"block_jacobi_nd{nd}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(Dinv: torch.Tensor, R: torch.Tensor) -> None:
    """Shapes, dtypes, devices and contiguity."""
    if Dinv.dim() != 5 or Dinv.shape[0] != Dinv.shape[1] or Dinv.shape[2] != 8:
        raise ValueError(f"Dinv must be [nd, nd, 8, KY, KX], got {tuple(Dinv.shape)}")
    nd = Dinv.shape[0]
    if nd not in KERNEL_ND:
        raise ValueError(f"the kernel is built for nd in {KERNEL_ND}, got nd = {nd}")
    if tuple(R.shape) != tuple(Dinv.shape[1:]):
        raise ValueError(f"R must be {list(Dinv.shape[1:])}, got {tuple(R.shape)}")
    if Dinv.dtype not in _DTYPES or R.dtype != Dinv.dtype:
        raise TypeError(f"Dinv and R must share dtype float32 or float64, "
                        f"got {Dinv.dtype} and {R.dtype}")
    if Dinv.device != R.device:
        raise ValueError(f"Dinv on {Dinv.device} but R on {R.device}")
    if not (Dinv.is_contiguous() and R.is_contiguous()):
        raise ValueError("Dinv and R must be contiguous")


def _launch(Dinv: torch.Tensor, R: torch.Tensor) -> tuple:
    """Launches the kernel on CUDA tensors that ``_check`` passed; returns
    (Z, whether the 16-byte path ran)."""
    if Dinv.device.type != "cuda":
        raise ValueError(f"unsupported device {Dinv.device}")
    sites = R[0].numel()
    if Dinv.numel() >= 2 ** 31:
        raise ValueError(f"{Dinv.numel()} values of Dinv pass the kernel's 32-bit offsets")
    Z = torch.empty_like(R)
    vector = Dinv.data_ptr() % 16 == 0 and R.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(R.device).cuda_stream
    err = _kernel(R.dtype, Dinv.shape[0])(Dinv.data_ptr(), R.data_ptr(), Z.data_ptr(), sites,
                                          int(vector), R.device.index, stream)
    if err != 0:
        raise RuntimeError(f"block_jacobi launch failed: cudaError {err}")
    return Z, vector


def block_jacobi(Dinv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Z = D^-1 R blockwise (see the module docstring).  On CUDA tensors
    this launches the kernel, counted while recording
    (``utils/profiling.count_launch``) in ``kernel.block_jacobi`` and per
    instantiation and lattice in
    ``kernel.block_jacobi.nd<nd>_<f32|f64> <KY>x<KX>`` (again at each
    replay of a graph that captured it); it raises for an input it does
    not take.  On CPU tensors it is ``block_jacobi_reference``."""
    _check(Dinv, R)
    if R.device.type == "cpu":
        return block_jacobi_reference(Dinv, R)
    Z, vector = _launch(Dinv, R)
    count_launch("block_jacobi", Dinv)
    if not vector:
        count("kernel.block_jacobi.scalar")
    return Z
