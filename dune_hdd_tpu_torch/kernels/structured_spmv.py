"""The block-ELL SpMV in the structured cell numbering: CUDA kernel wrapper
and its plain PyTorch version.

``structured_spmv(planes, x, offsets)`` computes, for block planes
[4, nd, nd, nc] (the SoA repack of blocks [nc, 4, nd, nd], slot 0 = self),
a flat cell-major x [nc * nd] and 8 x 3 flat cell offsets (see
``csrc/structured_spmv.cu`` for the formula),

    y[c] = sum_s B_s[c] x[(c + o[k(c)][s-1]) mod nc],   k(c) = c // (nc / 8),

with the self term at s = 0.  Neighbour reads wrap modulo nc, the semantics
of the reference's ``StructuredBlockEll.matvec``.  CUDA tensors go to the
hand-written kernel (float32, nd in {3, 6, 10}); CPU tensors go to
``structured_spmv_reference``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build

__all__ = ["structured_spmv", "structured_spmv_reference", "structured_neighbor_fields"]

KERNEL_ND = (3, 6, 10)


def structured_neighbor_fields(xc: torch.Tensor, offsets) -> torch.Tensor:
    """[nc, 4, nd]: x at each cell and at its three slot neighbours, from
    contiguous slices of [x; x] (reads wrap modulo nc)."""
    nc = xc.shape[0]
    L = nc // 8
    x2 = torch.cat([xc, xc], dim=0)
    fields = [xc]
    for s in range(3):
        starts = [k * L + int(offsets[k][s]) % nc for k in range(8)]
        fields.append(torch.cat([x2[a:a + L] for a in starts], dim=0))
    return torch.stack(fields, dim=1)


def structured_spmv_reference(planes: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """Plain PyTorch version: the neighbour fields and one contraction over
    (slot, j), as the reference's StructuredBlockEll.matvec."""
    nd, nc = planes.shape[1], planes.shape[3]
    fields = structured_neighbor_fields(x.reshape(nc, nd), offsets)
    return torch.einsum("bijc,cbj->ci", planes, fields).reshape(-1)


@lru_cache(maxsize=None)
def _offsets_array(offsets, nc: int) -> ctypes.Array:
    flat = [int(o) % nc for row in offsets for o in row]
    if len(flat) != 24:
        raise ValueError(f"offsets must be 8 x 3 ints, got {offsets!r}")
    return (ctypes.c_longlong * 24)(*flat)


@lru_cache(maxsize=None)
def _kernel(nd: int):
    name = "structured_spmv_" + ("" if nd == 3 else f"nd{nd}_") + "f32"
    fn = getattr(build.load("structured_spmv"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(planes: torch.Tensor, x: torch.Tensor) -> None:
    if planes.dim() != 4 or planes.shape[0] != 4 or planes.shape[1] != planes.shape[2]:
        raise ValueError(f"planes must be [4, nd, nd, nc], got {tuple(planes.shape)}")
    nd, nc = planes.shape[1], planes.shape[3]
    if nd not in KERNEL_ND:
        raise ValueError(f"the kernel is built for nd in {KERNEL_ND}, got nd = {nd}")
    if nc % 8:
        raise ValueError(f"the cell count must be a multiple of 8 subclasses, got {nc}")
    if tuple(x.shape) != (nc * nd,):
        raise ValueError(f"x must be [{nc * nd}] (cell-major), got {tuple(x.shape)}")
    if planes.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"planes and x must be float32, got {planes.dtype} and {x.dtype}")
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device} but x on {x.device}")
    if not (planes.is_contiguous() and x.is_contiguous()):
        raise ValueError("planes and x must be contiguous")


def structured_spmv(planes: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """y = A x for the structured block operator (see module docstring).

    ``offsets``: 8 x 3 tuple of ints.  On CUDA tensors this launches the
    kernel (and counts the launch in ``structured_spmv.launches``); on CPU
    tensors it is ``structured_spmv_reference``."""
    _check(planes, x)
    if planes.device.type == "cpu":
        return structured_spmv_reference(planes, x, offsets)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    nc = planes.shape[3]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    offsets = tuple(tuple(int(o) for o in row) for row in offsets)
    err = _kernel(planes.shape[1])(planes.data_ptr(), x.data_ptr(), y.data_ptr(), nc,
                    _offsets_array(offsets, nc), planes.device.index, stream)
    if err != 0:
        raise RuntimeError(f"structured_spmv launch failed: cudaError {err}")
    structured_spmv.launches += 1
    return y


structured_spmv.launches = 0
