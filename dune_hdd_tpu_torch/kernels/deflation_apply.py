"""The fine level of the two-level deflation apply in the plane layout: CUDA
kernel wrappers and their plain PyTorch versions.

With the weighted aggregation Z_w = diag(w) Z onto (my, mx) aggregates of
fy x fx lattice sites (agg(y, x) = (y // fy, x // fx)), the weighted AZ
planes AZ [4, nd, 8, KY, KX] (AZ[s, i] = sum_j W[s, i, j] w_j at the slot-s
neighbour) and, where the preconditioner smooths with block Jacobi, its
inverse blocks Dinv [nd, nd, 8, KY, KX], one application of

    M^-1 R = Z_w y1 + S - Z_w y2,   y1 = E^-1 Z_w^T R,
    S = M_J (R - A Z_w y1),         y2 = E^-1 Z_w^T A S

is four passes around the two coarse solves, which stay in PyTorch:

- ``weighted_sums(F, R)``: Z_w^T R;
- ``residual(F, R, y1)``: S = Dinv (R - A Z_w y1), or T = R - A Z_w y1 where
  ``F.Dinv`` is None (a caller's smoother is applied to T after it);
- ``zt_a(F, S)``: Z_w^T A S;
- ``combine(F, y1, S, y2)``: (w y1[agg] + S) - w y2[agg].

The coarse vectors have the aggregation's layout: ``agg.shape``, x-major flat
[mx * my] for the dense and BCR coarse solves or [my, mx] for a middle
lattice, and ``agg.grid`` their [my, mx] view, whose strides the kernels
read.  CUDA tensors go to the
hand-written kernels (``csrc/deflation_apply.cu``), each pass counted while
recording in ``kernel.deflation_apply.<weighted_sums|residual|defect|zt_a|
combine>`` (``residual`` the pass fused with the Jacobi product, ``defect``
the one without); CPU tensors go to the plain versions ``*_reference``, the
PyTorch closures the apply ran before the kernels.  On the card the residual,
defect and combine passes are bitwise the plain versions; the two aggregate
sums are taken in another fixed order (no atomics), so they agree within
rounding and are the same from run to run.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Any, NamedTuple, Optional

import torch

from ..utils.profiling import count_launch
from . import build
from .block_jacobi import block_jacobi_reference

__all__ = [
    "FineLevel",
    "SumGeometry",
    "fine_level",
    "sum_geometry",
    "weighted_sums",
    "residual",
    "zt_a",
    "combine",
    "weighted_sums_reference",
    "residual_reference",
    "zt_a_reference",
    "combine_reference",
]

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
KERNEL_ND = (3, 6, 10)
# threads the first launch of an aggregate sum aims at, and partials a
# thread of the second sums before its group's tree
STAGE_ONE_THREADS = 1 << 17
TERMS_PER_THREAD = 8
_PASSES = {"weighted_sums": 0, "residual": 1, "defect": 2, "zt_a": 3, "combine": 4}


class FineLevel(NamedTuple):
    """What the fine-level passes read: ``agg`` has ``aggsum`` / ``broadcast``
    (the plain versions' aggregation), ``mx``, ``my``, ``fy``, ``fx`` and the
    coarse layout ``shape`` / ``grid``;
    ``sources[s][ks]`` = (k, dy, dx): slot s of subclass k reaches the
    target subclass ks, shifted by (dy, dx) (the inverse of ``plan``'s slot
    map)."""

    AZ: torch.Tensor
    weight: torch.Tensor
    Dinv: Optional[torch.Tensor]
    plan: tuple
    sources: tuple
    agg: Any


def _sources(plan) -> tuple:
    """sources[s][ks] = (k, dy, dx) with plan[k][s] = (ks, dy, dx); raises
    ValueError where a slot's k -> ks map is not a bijection."""
    out = []
    for s in range(3):
        row = [None] * 8
        for k in range(8):
            ks, dy, dx = plan[k][s]
            if row[ks] is not None:
                raise ValueError("stencil plan slot map is not bijective")
            row[ks] = (k, dy, dx)
        out.append(tuple(row))
    return tuple(out)


def fine_level(AZ: torch.Tensor, weight: torch.Tensor, plan, agg,
               Dinv: Optional[torch.Tensor] = None) -> FineLevel:
    """The fine level of a deflation preconditioner (set-up; checks the plan
    is a bijection in every slot and that AZ, weight and Dinv agree)."""
    if AZ.dim() != 5 or AZ.shape[0] != 4 or AZ.shape[2] != 8:
        raise ValueError(f"AZ must be [4, nd, 8, KY, KX], got {tuple(AZ.shape)}")
    nd, KY, KX = AZ.shape[1], AZ.shape[3], AZ.shape[4]
    if tuple(weight.shape) != tuple(AZ.shape[1:]):
        raise ValueError(f"weight must be {list(AZ.shape[1:])}, got {tuple(weight.shape)}")
    if Dinv is not None and tuple(Dinv.shape) != (nd,) + tuple(AZ.shape[1:]):
        raise ValueError(f"Dinv must be [{nd}, {nd}, 8, {KY}, {KX}], got {tuple(Dinv.shape)}")
    if agg.my * agg.fy != KY or agg.mx * agg.fx != KX:
        raise ValueError(f"aggregation ({agg.my} x {agg.fy}, {agg.mx} x {agg.fx}) does not "
                         f"tile the lattice {(KY, KX)}")
    plan = tuple(tuple(tuple(int(v) for v in e) for e in row) for row in plan)
    return FineLevel(AZ.contiguous(), weight.contiguous(),
                     None if Dinv is None else Dinv.contiguous(), plan, _sources(plan), agg)


# -- plain versions -------------------------------------------------------------


def weighted_sums_reference(F: FineLevel, R: torch.Tensor) -> torch.Tensor:
    """Z_w^T R: weighted aggregate sums."""
    return F.agg.aggsum(R * F.weight)


def _a_broadcast(F: FineLevel, yc: torch.Tensor) -> torch.Tensor:
    """A (Z_w yc) via the AZ planes and the rolled broadcast."""
    B0 = F.agg.broadcast(yc)  # [8, KY, KX]
    out = F.AZ[0] * B0[None]
    for s in range(3):
        Bs = torch.stack([torch.roll(B0[ks], shifts=(-dy, -dx), dims=(0, 1))
                          for ks, dy, dx in (F.plan[k][s] for k in range(8))])
        out = out + F.AZ[s + 1] * Bs[None]
    return out


def residual_reference(F: FineLevel, R: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """Dinv (R - A Z_w yc), or R - A Z_w yc where ``F.Dinv`` is None."""
    T = R - _a_broadcast(F, yc)
    return T if F.Dinv is None else block_jacobi_reference(F.Dinv, T)


def zt_a_reference(F: FineLevel, S: torch.Tensor) -> torch.Tensor:
    """Z_w^T A S via the AZ planes: each slot's pairing scattered back to the
    neighbour's lattice position with the inverse roll, then the aggregate
    sums."""
    total = (F.AZ[0] * S).sum(dim=0)  # [8, KY, KX]
    for s in range(3):
        Ps = (F.AZ[s + 1] * S).sum(dim=0)
        out_k = [None] * 8
        for k in range(8):
            ks, dy, dx = F.plan[k][s]
            contrib = torch.roll(Ps[k], shifts=(dy, dx), dims=(0, 1))
            out_k[ks] = contrib if out_k[ks] is None else out_k[ks] + contrib
        total = total + torch.stack(out_k)
    return F.agg.aggsum(total)


def combine_reference(F: FineLevel, y1: torch.Tensor, S: torch.Tensor,
                      y2: torch.Tensor) -> torch.Tensor:
    """Z_w y1 + S - Z_w y2."""
    return F.agg.broadcast(y1)[None] * F.weight + S - F.agg.broadcast(y2)[None] * F.weight


# -- launch geometry ------------------------------------------------------------


class SumGeometry(NamedTuple):
    """The aggregate sums' two launches: in the first, one thread per
    (aggregate row, chunk, lattice column) sums ``ch`` of the 8 fy (subclass,
    row) pairs of its column, and ``lw`` adjacent columns of one aggregate
    are summed in a warp; the second sums each aggregate's ``nch * fx / lw``
    partials with ``group`` threads."""

    nch: int
    ch: int
    lw: int
    group: int

    def partials(self, my: int, KX: int) -> int:
        return my * self.nch * KX // self.lw


def sum_geometry(KX: int, fy: int, fx: int, my: int,
                 threads: int = STAGE_ONE_THREADS) -> SumGeometry:
    """The geometry for an (my, KX // fx) aggregation of fy x fx sites:
    about ``threads`` first-launch threads, no empty chunk, ``lw`` the
    largest power of two up to 32 that divides fx, ``group`` a power of
    two up to 256 giving each thread about TERMS_PER_THREAD partials."""
    pairs = 8 * fy
    nch = max(1, min(pairs, -(-threads // (my * KX))))
    ch = -(-pairs // nch)
    nch = -(-pairs // ch)
    lw = 1
    while lw < 32 and fx % (2 * lw) == 0:
        lw *= 2
    terms = nch * (fx // lw)
    group = 1
    while group < 256 and group * TERMS_PER_THREAD < terms:
        group *= 2
    return SumGeometry(nch, ch, lw, group)


# -- the kernels ----------------------------------------------------------------


class _Params(ctypes.Structure):
    """``Params`` of csrc/deflation_apply.cu."""

    _fields_ = ([(name, ctypes.c_void_p) for name in
                 ("R", "w", "AZ", "Dinv", "y1", "y2", "out", "partial")]
                + [(name, ctypes.c_int) for name in
                   ("KY", "KX", "fy", "fx", "my", "mx", "sy1", "sx1", "sy2", "sx2", "syo",
                    "sxo", "nch", "ch", "lw", "group")]
                + [("shift", ctypes.c_int * 48), ("source", ctypes.c_int * 72)])


@lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype, nd: int):
    fn = getattr(build.load("deflation_apply"), f"deflation_apply_nd{nd}_{_DTYPES[dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _coarse_strides(F: FineLevel, yc: torch.Tensor) -> tuple:
    """Element strides (aggregate row, column) of a coarse vector."""
    if tuple(yc.shape) != F.agg.shape:
        raise ValueError(f"coarse vector must be {list(F.agg.shape)}, got {tuple(yc.shape)}")
    return F.agg.grid(yc).stride()


def _check(F: FineLevel, *tensors: torch.Tensor) -> None:
    """Dtypes, devices, the fields' shape and contiguity, and what the
    kernels are built for."""
    dtype, device = F.AZ.dtype, F.AZ.device
    if dtype not in _DTYPES:
        raise TypeError(f"the deflation apply takes float32 or float64, got {dtype}")
    if F.AZ.shape[1] not in KERNEL_ND:
        raise ValueError(f"the kernels are built for nd in {KERNEL_ND}, got nd = {F.AZ.shape[1]}")
    for t in (F.weight, F.Dinv) + tensors:
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"the deflation apply's tensors share dtype {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"AZ on {device} but a tensor on {t.device}")


def _field(F: FineLevel, V: torch.Tensor) -> torch.Tensor:
    if tuple(V.shape) != tuple(F.weight.shape):
        raise ValueError(f"field must be {list(F.weight.shape)}, got {tuple(V.shape)}")
    if V.device.type != "cpu" and not V.is_contiguous():
        raise ValueError("the deflation kernels take contiguous fields")
    return V


def _launch(F: FineLevel, pass_name: str, out: torch.Tensor, V: torch.Tensor,
            y1: Optional[torch.Tensor] = None, y2: Optional[torch.Tensor] = None) -> None:
    """One pass on CUDA tensors that ``_check`` passed."""
    if F.AZ.device.type != "cuda":
        raise ValueError(f"unsupported device {F.AZ.device}")
    agg, (KY, KX), nd = F.agg, F.AZ.shape[-2:], F.AZ.shape[1]
    p = _Params(R=V.data_ptr(), w=F.weight.data_ptr(), AZ=F.AZ.data_ptr(),
                Dinv=0 if F.Dinv is None else F.Dinv.data_ptr(), out=out.data_ptr(), KY=KY,
                KX=KX, fy=agg.fy, fx=agg.fx, my=agg.my, mx=agg.mx)
    for k in range(8):
        for s in range(3):
            p.shift[(k * 3 + s) * 2: (k * 3 + s) * 2 + 2] = F.plan[k][s][1:]
    for s in range(3):
        for ks in range(8):
            p.source[(s * 8 + ks) * 3: (s * 8 + ks) * 3 + 3] = F.sources[s][ks]
    if y1 is not None:
        p.y1, (p.sy1, p.sx1) = y1.data_ptr(), _coarse_strides(F, y1)
    if y2 is not None:
        p.y2, (p.sy2, p.sx2) = y2.data_ptr(), _coarse_strides(F, y2)
    partial = None
    if pass_name in ("weighted_sums", "zt_a"):
        p.syo, p.sxo = _coarse_strides(F, out)
        g = sum_geometry(KX, agg.fy, agg.fx, agg.my)
        partial = torch.empty(g.partials(agg.my, KX), dtype=V.dtype, device=V.device)
        p.partial, p.nch, p.ch, p.lw, p.group = partial.data_ptr(), *g
    stream = torch.cuda.current_stream(V.device).cuda_stream
    err = _kernel(V.dtype, nd)(_PASSES[pass_name], ctypes.addressof(p), V.device.index, stream)
    if err != 0:
        raise RuntimeError(f"deflation_apply {pass_name} launch failed: cudaError {err}")
    count_launch(f"deflation_apply.{pass_name}")


def _coarse_empty(F: FineLevel, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(F.agg.shape, dtype=like.dtype, device=like.device)


def weighted_sums(F: FineLevel, R: torch.Tensor) -> torch.Tensor:
    """Z_w^T R in the coarse layout (see the module docstring)."""
    _check(F, R)
    R = _field(F, R)
    if R.device.type == "cpu":
        return weighted_sums_reference(F, R)
    out = _coarse_empty(F, R)
    _launch(F, "weighted_sums", out, R)
    return out


def residual(F: FineLevel, R: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """Dinv (R - A Z_w yc), or R - A Z_w yc where ``F.Dinv`` is None."""
    _check(F, R, yc)
    R = _field(F, R)
    if R.device.type == "cpu":
        return residual_reference(F, R, yc)
    out = torch.empty_like(R)
    _launch(F, "defect" if F.Dinv is None else "residual", out, R, y1=yc)
    return out


def zt_a(F: FineLevel, S: torch.Tensor) -> torch.Tensor:
    """Z_w^T A S in the coarse layout."""
    _check(F, S)
    S = _field(F, S)
    if S.device.type == "cpu":
        return zt_a_reference(F, S)
    out = _coarse_empty(F, S)
    _launch(F, "zt_a", out, S)
    return out


def combine(F: FineLevel, y1: torch.Tensor, S: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """Z_w y1 + S - Z_w y2."""
    _check(F, y1, S, y2)
    S = _field(F, S)
    if S.device.type == "cpu":
        return combine_reference(F, y1, S, y2)
    out = torch.empty_like(S)
    _launch(F, "combine", out, S, y1=y1, y2=y2)
    return out
