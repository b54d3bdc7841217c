"""The plane SpMV of the SWIPDG stencil operator: CUDA kernel wrapper and its
plain PyTorch version.

``plane_spmv(W, X, plan)`` computes, for planes W [4, nd, nd, 8, KY, KX] and
a field X [nd, 8, KY, KX] with nd in {3, 6, 10} DoF per cell (DG P1, P2, P3
on triangles; see ``csrc/plane_spmv.cu`` for the formula),

    Y[i] = sum_s sum_j W[s, i, j] * X_s[j],

where X_0 = X and X_{s+1} holds, for subclass k, X[:, ks] rolled by
(-dy, -dx) with (ks, dy, dx) = plan[k][s].  CUDA tensors go to the
hand-written kernel, launched with the tile, X halo, ring and grid that
``plane_geometry`` computes from the shapes and the plan; CPU tensors go to
``plane_spmv_reference``.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import torch

from . import build

__all__ = ["plane_spmv", "plane_spmv_reference"]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
KERNEL_ND = (3, 6, 10)


def plane_spmv_reference(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Plain PyTorch version: 24 lattice rolls and 4 nd^2 multiply-adds, in
    the summation order of the reference package's StencilBlockEll.matvec."""
    nd = X.shape[0]
    fields = [X]
    for s in range(3):
        per_k = []
        for k in range(8):
            ks, dy, dx = plan[k][s]
            per_k.append(torch.roll(X[:, ks], shifts=(-dy, -dx), dims=(1, 2)))
        fields.append(torch.stack(per_k, dim=1))
    acc = []
    for i in range(nd):
        t = W[0, i, 0] * X[0]
        for s in range(4):
            for j in range(nd):
                if s or j:
                    t = torch.addcmul(t, W[s, i, j], fields[s][j])
        acc.append(t)
    return torch.stack(acc, dim=0)


# The kernel's launch geometry (csrc/plane_spmv.cu).  Per (nd, bytes per
# value): the tile (TY, TX) and the (s, i, j) plane groups per ring stage;
# the kernel's Config holds the same numbers and rejects any other.
TILES = {(3, 4): (4, 32, 2), (3, 8): (2, 32, 2), (6, 4): (2, 64, 4),
         (6, 8): (2, 32, 2), (10, 4): (2, 32, 8), (10, 8): (4, 16, 2)}
THREADS = 288            # 8 consumer warps and one producer warp
MAX_STAGES = 8
HEADER_BYTES = 128       # the ring's mbarriers
SMEM_PER_SM = 233472     # 228 KB of shared memory on an H100 SM
SMEM_PER_BLOCK = 232448  # 227 KB at most for one block
SMEM_RESERVED = 1024     # held back per resident block


class Geometry(ctypes.Structure):
    """The kernel's ``PlaneGeometry``: lattice, tile, staged X box and its halo
    (rows above, columns left), ring stages, the grid of tiles, dynamic
    shared memory, and per (subclass k, slot s) the position of tile site
    (0, 0)'s source in the staged box [8, BY, BX]."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "KY", "KX", "TY", "TX", "lx", "BY", "BX", "hy", "hx", "stages", "grid_x", "grid_y",
        "smem_bytes")] + [("xoff", (ctypes.c_int * 4) * 8)]


def plan_halo(plan) -> tuple:
    """(rows above, rows below, columns left, columns right) of a tile that
    the plan's shifted reads reach."""
    dys = [dy for row in plan for _, dy, _ in row] + [0]
    dxs = [dx for row in plan for _, _, dx in row] + [0]
    return -min(dys), max(dys), -min(dxs), max(dxs)


@lru_cache(maxsize=None)
def plane_geometry(nd: int, itemsize: int, lattice: tuple, plan) -> Geometry:
    """The launch geometry for planes of ``nd`` x ``nd`` blocks of
    ``itemsize``-byte values on ``lattice`` (KY, KX) under ``plan``: one
    block per tile.  The ring takes as many stages (2 to MAX_STAGES) as fit
    beside the staged X with two blocks per SM, else with one.  Raises
    ValueError for a shape the kernel does not take."""
    if (nd, itemsize) not in TILES:
        raise ValueError(f"no plane_spmv kernel for nd = {nd} with {itemsize}-byte values")
    KY, KX = (int(v) for v in lattice)
    if KY < 1 or KX < 4 or KX % 4:
        raise ValueError(f"the kernel takes lattices with KX a multiple of 4, got {KY} x {KX}")
    if 8 * nd * KY * KX >= 2 ** 31:
        raise ValueError(f"lattice {KY} x {KX} too large for 32-bit plane offsets")
    TY, TX, groups = TILES[nd, itemsize]
    up, down, left, right = plan_halo(plan)
    BY, BX = TY + up + down, TX + left + right
    stage = 8 * groups * TY * TX * itemsize
    fixed = HEADER_BYTES + 8 * nd * BY * BX * itemsize + 4 * (BY + BX)
    for blocks in (2, 1):
        budget = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks - SMEM_RESERVED)
        stages = min(MAX_STAGES, (budget - fixed) // stage)
        if stages >= 2:
            break
    else:
        raise ValueError(f"the X box {BY} x {BX} of plan halo {(up, down, left, right)} "
                         f"leaves no room for the ring at nd = {nd}")
    xoff = [[(k * BY + up) * BX + left] + [(ks * BY + up + dy) * BX + left + dx
                                           for ks, dy, dx in plan[k]] for k in range(8)]
    return Geometry(KY, KX, TY, TX, TX.bit_length() - 1, BY, BX, up, left, stages,
                    -(-KX // TX), -(-KY // TY), fixed + stages * stage,
                    ((ctypes.c_int * 4) * 8)(*[(ctypes.c_int * 4)(*row) for row in xoff]))


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype, nd: int):
    name = "plane_spmv_" + ("" if nd == 3 else f"nd{nd}_") + _DTYPES[dtype]
    fn = getattr(build.load("plane_spmv"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(Geometry), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(W: torch.Tensor, X: torch.Tensor) -> None:
    if W.dim() != 6 or W.shape[0] != 4 or W.shape[1] != W.shape[2] or W.shape[3] != 8:
        raise ValueError(f"planes must be [4, nd, nd, 8, KY, KX], got {tuple(W.shape)}")
    nd = W.shape[1]
    if nd not in KERNEL_ND:
        raise ValueError(f"the kernel is built for nd in {KERNEL_ND}, got nd = {nd}")
    if tuple(X.shape) != (nd, 8) + tuple(W.shape[4:]):
        raise ValueError(f"X must be [{nd}, 8, {W.shape[4]}, {W.shape[5]}], got {tuple(X.shape)}")
    if W.dtype not in _DTYPES or X.dtype != W.dtype:
        raise TypeError(f"planes and X must share dtype float32 or float64, "
                        f"got {W.dtype} and {X.dtype}")
    if W.device != X.device:
        raise ValueError(f"planes on {W.device} but X on {X.device}")
    if not (W.is_contiguous() and X.is_contiguous()):
        raise ValueError("planes and X must be contiguous")


def plane_spmv(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Y = A X for the stencil operator with planes W (see module docstring).

    ``plan``: 8 x 3 tuple of (ks, dy, dx).  On CUDA tensors this launches
    the kernel and counts the launch in ``plane_spmv.launches``, per
    instantiation in ``plane_spmv.case_launches["nd<nd>_<f32|f64>"]`` and
    per instantiation and lattice in
    ``plane_spmv.lattice_launches["nd<nd>_<f32|f64> <KY>x<KX>"]``; it
    raises ValueError for a lattice or an alignment the kernel does not
    take (``plane_geometry``).  On CPU tensors it is
    ``plane_spmv_reference``."""
    _check(W, X)
    if W.device.type == "cpu":
        return plane_spmv_reference(W, X, plan)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    if W.data_ptr() % 16:
        raise ValueError("the kernel reads the planes with TMA: they must be 16-byte aligned")
    nd, KY, KX = W.shape[1], W.shape[4], W.shape[5]
    geometry = plane_geometry(nd, W.element_size(), (KY, KX), plan)
    Y = torch.empty_like(X)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = _kernel(W.dtype, nd)(W.data_ptr(), X.data_ptr(), Y.data_ptr(), ctypes.byref(geometry),
                               W.device.index, stream)
    if err != 0:
        raise RuntimeError(f"plane_spmv launch failed: cudaError {err}")
    case = f"nd{nd}_{_DTYPES[W.dtype]}"
    plane_spmv.launches += 1
    plane_spmv.case_launches[case] += 1
    plane_spmv.lattice_launches[f"{case} {KY}x{KX}"] += 1
    return Y


plane_spmv.launches = 0
plane_spmv.case_launches = Counter()
plane_spmv.lattice_launches = Counter()
