"""The half-storage symmetric plane SpMV of the SWIPDG stencil operator: CUDA
kernel wrapper and its plain PyTorch version.

The SWIPDG operator is symmetric: each undirected coupling edge (k, s) ~
(ks, sp) of the stencil plan satisfies W[sp+1, j, i, ks] = roll(W[s+1, i,
j, k], (dy, dx)) up to assembly roundoff.  ``sym_plane_spmv(W, X, plan)``
applies the exactly symmetric operator that this storage defines, for
planes W [4, nd, nd, 8, KY, KX] and a field X [nd, 8, KY, KX] with nd in
{3, 6, 10}: it reads only the upper triangle of the self blocks and the 12
forward-edge plane sets (``sym_forward_edges``), and applies each stored
plane twice, forward and transposed at the inverse shift.  This is
``StencilBlockEll._matvec_sym`` of the reference package
(dune_hdd_tpu/la/stencil.py:209-260).  CUDA tensors go to the hand-written
kernel (``csrc/sym_plane_spmv.cu``), CPU tensors to
``sym_plane_spmv_reference``; both add in the reference's order.

``spmv_pairs`` pairs each full-plane SpMV with its half-storage partner, the
kernels and their plain versions apart: ``half_storage`` and
``plain_version`` read that one table.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable

import torch

from ..utils.profiling import count_launch
from . import build
from . import plane_spmv as _full
from .plane_spmv import _DTYPES, _check

__all__ = ["sym_plane_spmv", "sym_plane_spmv_reference", "sym_forward_edges", "sym_schedule",
           "sym_plane_bytes", "spmv_pairs", "half_storage", "plain_version"]


@lru_cache(maxsize=None)
def sym_forward_edges(plan) -> tuple:
    """The 12 forward edges ((k, s), (ks, sp)) of an 8 x 3 stencil plan, each
    undirected coupling once, in the reference's order; (ks, sp) is the
    reverse slot, plan[ks][sp] = (k, -dy, -dx).  Raises ValueError if a
    slot has no reverse or the edges do not cover all 24 slots."""
    pairs = {}
    for k in range(8):
        for s in range(3):
            ks, dy, dx = plan[k][s]
            rev = None
            for sp in range(3):
                if tuple(plan[ks][sp]) == (k, -dy, -dx):
                    rev = sp
            if rev is None:
                raise ValueError(f"stencil plan has no reverse edge for (k={k}, s={s})")
            pairs[(k, s)] = (ks, rev)
    edges = tuple((e, pairs[e]) for e in pairs if e < pairs[e])
    if len({slot for edge in edges for slot in edge}) != 24:
        raise ValueError("stencil plan's forward edges do not cover all 24 slots")
    return edges


@lru_cache(maxsize=None)
def sym_schedule(plan) -> tuple:
    """Per output subclass k: its three edge terms in the order the reference
    adds them, as (forward, stored slot s, slot of k).  A forward term reads
    W[s+1, :, :, k] at the cell's own site; a reverse term reads the plane
    W[s+1, :, :, ks] of the forward subclass ks = plan[k][slot][0],
    transposed, at the neighbour site plan[k][slot] points to.  Both read X
    at that neighbour."""
    terms = [[] for _ in range(8)]
    for (k, s), (ks, sp) in sym_forward_edges(plan):
        terms[k].append((1, s, s))
        terms[ks].append((0, s, sp))
    return tuple(tuple(t) for t in terms)


def sym_plane_bytes(nd: int, lattice, itemsize: int) -> int:
    """Bytes the operator must move once: per lattice site the upper
    triangles of 8 self blocks, 12 forward plane sets, X and Y."""
    KY, KX = lattice
    per_site = 8 * nd * (nd + 1) // 2 + 12 * nd * nd + 2 * 8 * nd
    return per_site * KY * KX * itemsize


def sym_plane_spmv_reference(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Plain PyTorch version, in the reference's order for every output
    (i, k): the self terms W[0, min(i, j), max(i, j), k] X[j, k] in
    ascending j, then one partial sum per edge in ``sym_forward_edges``
    order, over j for a forward edge and over i for a reversed one, each
    added to the accumulator.  Every product and sum is rounded on its own
    (no fused multiply-add)."""
    nd = W.shape[1]
    acc = []
    for i in range(nd):
        t = W[0, 0, i] * X[0]
        for j in range(1, nd):
            t = t + W[0, min(i, j), max(i, j)] * X[j]
        acc.append(t)
    acc = torch.stack(acc)  # [nd, 8, KY, KX]
    for (k, s), (ks, _) in sym_forward_edges(plan):
        _, dy, dx = plan[k][s]
        Wf = W[s + 1, :, :, k]  # [nd, nd, KY, KX]
        Xsh = torch.roll(X[:, ks], shifts=(-dy, -dx), dims=(1, 2))
        t = Wf[:, 0] * Xsh[0]
        for j in range(1, nd):
            t = t + Wf[:, j] * Xsh[j]
        acc[:, k] += t
        t = Wf[0] * X[0, k]
        for i in range(1, nd):
            t = t + Wf[i] * X[i, k]
        acc[:, ks] += torch.roll(t, shifts=(dy, dx), dims=(1, 2))
    return acc


class SymGeometry(ctypes.Structure):
    """The kernel's ``SymGeometry``: the lattice and, per (output subclass k,
    term m), the term's direction, stored slot and neighbour (kn, dy mod KY,
    dx mod KX)."""
    _fields_ = [("KY", ctypes.c_int), ("KX", ctypes.c_int),
                ("terms", ((ctypes.c_int * 5) * 3) * 8)]


@lru_cache(maxsize=None)
def sym_geometry(lattice: tuple, plan) -> SymGeometry:
    """The launch table for ``lattice`` (KY, KX) under ``plan`` (the kernel
    runs one block per 32 columns of a lattice row).  Raises ValueError for
    a lattice the kernel does not take."""
    KY, KX = (int(v) for v in lattice)
    if not 1 <= KY <= 65535 or KX < 1 or 8 * KY * KX >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= KY <= 65535 rows and 8 KY KX < 2^31 sites, "
                         f"got {KY} x {KX}")
    rows = []
    for k, terms in enumerate(sym_schedule(plan)):
        rows.append([(fwd, s, plan[k][slot][0], plan[k][slot][1] % KY, plan[k][slot][2] % KX)
                     for fwd, s, slot in terms])
    table = (((ctypes.c_int * 5) * 3) * 8)(
        *[((ctypes.c_int * 5) * 3)(*[(ctypes.c_int * 5)(*t) for t in r]) for r in rows])
    return SymGeometry(KY, KX, table)


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype, nd: int):
    fn = getattr(build.load("sym_plane_spmv"), f"sym_plane_spmv_nd{nd}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(SymGeometry), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sym_plane_spmv(W: torch.Tensor, X: torch.Tensor, plan) -> torch.Tensor:
    """Y = A X for the symmetric operator that the half storage of planes W
    defines (module docstring).  ``plan``: 8 x 3 tuple of (ks, dy, dx).  On
    CUDA tensors this launches the kernel, counted while recording
    (``utils/profiling.count_launch``) in ``kernel.sym_plane_spmv`` and per
    instantiation and lattice in
    ``kernel.sym_plane_spmv.nd<nd>_<f32|f64> <KY>x<KX>``.  On
    CPU tensors it is ``sym_plane_spmv_reference``.  Raises ValueError for
    nd outside {3, 6, 10} or a plan without reverse edges."""
    _check(W, X)
    if W.device.type == "cpu":
        return sym_plane_spmv_reference(W, X, plan)
    if W.device.type != "cuda":
        raise ValueError(f"unsupported device {W.device}")
    nd, KY, KX = W.shape[1], W.shape[4], W.shape[5]
    geometry = sym_geometry((KY, KX), plan)
    Y = torch.empty((nd, 8, KY, KX), dtype=W.dtype, device=W.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = _kernel(W.dtype, nd)(W.data_ptr(), X.data_ptr(), Y.data_ptr(), ctypes.byref(geometry),
                               W.device.index, stream)
    if err != 0:
        raise RuntimeError(f"sym_plane_spmv launch failed: cudaError {err}")
    count_launch("sym_plane_spmv", W)
    return Y


def spmv_pairs() -> tuple:
    """The plane SpMVs as (full planes, half storage) pairs of one family
    each: the hand-written kernels, then their plain versions.  Read from
    the modules at each call, so a function replaced there (a test's
    counting spy) takes its place in the pairs."""
    return ((_full.plane_spmv, sym_plane_spmv),
            (_full.plane_spmv_reference, sym_plane_spmv_reference))


def half_storage(spmv) -> Callable:
    """The half-storage SpMV of ``spmv``'s family (``spmv`` itself where it
    is one).  Raises ValueError for a callable that is no plane SpMV."""
    for pair in spmv_pairs():
        if any(spmv is f for f in pair):
            return pair[1]
    raise ValueError(f"{spmv!r} is not a plane SpMV of `spmv_pairs`")


def plain_version(spmv) -> Callable:
    """The plain version of the plane SpMV ``spmv``, of the same storage.
    Raises ValueError for a callable that is no plane SpMV."""
    kernels, plain = spmv_pairs()
    for f, p in zip(kernels + plain, plain + plain):
        if spmv is f:
            return p
    raise ValueError(f"{spmv!r} is not a plane SpMV of `spmv_pairs`")
