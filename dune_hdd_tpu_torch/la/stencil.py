"""SoA stencil form of the structured block operator, its symmetric form,
its smoothers (block Jacobi, Chebyshev), its two- and multi-level deflation
preconditioners with their coarse solves (dense LU, BCR, and the factored
BCR for coarse spaces above 4096 aggregates) and the mixed-precision
refined PCG.

Counterpart of ``dune_hdd_tpu/la/stencil.py``.  The operator lives as
planes W[slot, i, j, subclass, KY, KX] (slot 0 = self) and vectors as
X[nd, 8, KY, KX]; for a subclass-k cell at lattice position (iy, ix) its
geometric slot-s neighbour is the subclass-``k_src`` cell at
(iy+dy, ix+dx).  Reads that wrap around a lattice axis meet zero blocks
(domain boundary), so the per-axis wrap is harmless.

The SpMVs are the hand-written kernels ``kernels/plane_spmv`` and, for the
half-storage symmetric operator, ``kernels/sym_plane_spmv``; the block-Jacobi
apply is ``kernels/block_jacobi`` and the fine level of the deflation apply
``kernels/deflation_apply``; everything else is plain torch on the planes'
device.

Spans and counters (``utils/profiling.py``; recorded only while recording):
``pcg`` around each ``stencil_pcg`` with its ``pcg.iterations``,
``precond.apply`` and ``matvec`` around each application of M and A in it
where it runs op by op, ``refine.residual`` around each float64 residual of
the refinement, and ``host.syncs`` at each point where the host waits for
the device: a read of a device value, ``torch.linalg``'s check of its
result, and a copy from host memory to the device.  The PCG is one loop,
`_Pcg`, which on CUDA runs as CUDA graphs (``pcg.graph.capture`` and the
``pcg.graph.*`` counters).  `stencil_deflation_preconditioner` builds in a
``deflation.build`` span, counts the coarse branch it took
(``deflation.coarse.<dense|factored_bcr|multilevel>``) and the coarse
unknowns (``deflation.aggregates``) once per build, and each application
of M in ``deflation.applies`` (its fine level's passes count in
``kernel.deflation_apply.*``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.block_jacobi import block_jacobi
from ..kernels.deflation_apply import (FineLevel, combine, fine_level, residual,
                                       weighted_sums, zt_a)
from ..kernels.plane_spmv import plane_spmv
from ..kernels.sym_plane_spmv import half_storage, spmv_pairs, sym_forward_edges
from ..utils.profiling import (SyncInCapture, captured_counts, capturing, count, host_read,
                               span, upload)
from .block_ell import BlockEllMatrix, StructuredBlockEll, inv3x3

__all__ = [
    "StencilBlockEll",
    "symmetric_planes",
    "stencil_plan",
    "soa_index_maps",
    "jacobi_smoother",
    "estimate_lambda_max",
    "chebyshev_smoother",
    "stencil_deflation_preconditioner",
    "stencil_pcg",
    "stencil_refined_solve",
]


def _inv(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv``, which reads its result's error code on the host
    (a wait for the device, counted in ``host.syncs``)."""
    count("host.syncs")
    return torch.linalg.inv(A)


def stencil_plan(order) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """Per (subclass k, slot s): (k_src, dy, dx) with the slot-s neighbour
    field of subclass k equal to roll2d(X[k_src], (-dy, -dx))."""
    KY, KX = order.lattice
    L = KY * KX
    NC = order.num_cells
    plan = []
    for k in range(8):
        row = []
        for s in range(3):
            o = int(order.offsets[k][s]) % NC
            oc = ((o + NC // 2) % NC) - NC // 2
            dk = int(np.round(oc / L))
            r = oc - dk * L
            dy = int(np.round(r / KX))
            dx = r - dy * KX
            if abs(dy) > 2 or abs(dx) > 2:
                raise ValueError(
                    f"offset {oc} for subclass {k} slot {s} is not a small "
                    f"lattice shift (dy={dy}, dx={dx})")
            row.append(((k + dk) % 8, dy, dx))
        plan.append(tuple(row))
    return tuple(plan)


class _SoAMaps(NamedTuple):
    to_soa: np.ndarray    # [nd*NC] flat gather: soa_flat = x[to_soa]
    from_soa: np.ndarray  # [NC*nd] flat gather: x = soa_flat[from_soa]


def soa_index_maps(order, nd: int) -> _SoAMaps:
    """Index maps between the flat cell-major vector in the ORIGINAL cell
    order and the SoA [nd, 8, KY, KX] layout (flattened)."""
    NC = order.num_cells
    inv = np.asarray(order.inv)   # new -> old
    perm = np.asarray(order.perm)  # old -> new
    # soa position (j, new) <- old flat index inv[new]*nd + j
    to_soa = (inv[None, :] * nd + np.arange(nd)[:, None]).reshape(-1)
    # old flat (old, j) <- soa flat j*NC + perm[old]
    from_soa = (np.arange(nd)[None, :] * NC + perm[:, None]).reshape(-1)
    return _SoAMaps(to_soa.astype(np.int32), from_soa.astype(np.int32))


class StencilBlockEll:
    """planes [4, nd, nd, 8, KY, KX] (slot 0 = self); plan: 8x3 static
    (k_src, dy, dx) lattice shifts.  ``spmv(planes, X, plan)`` is the one
    SpMV :meth:`matvec` applies: the hand-written kernel unless a caller
    substitutes its plain version.

    :meth:`symmetrized` swaps it for the half-storage partner of its family
    (``kernels/sym_plane_spmv.half_storage``: ``sym_plane_spmv`` or its
    plain version, the reference's ``_matvec_sym``): the SWIPDG operator is
    symmetric, so each undirected coupling edge (k, s) ~ (k_src, s')
    satisfies W[s'+1, j, i, k_src] == roll(W[s+1, i, j, k], (dy, dx)) up to
    assembly roundoff.  The symmetric matvec reads only the 12 forward-edge
    plane sets and the upper triangle of the self blocks of the same
    ``planes`` and applies each stored plane twice (forward, and transposed
    at the inverse shift).  The result is the exactly symmetrized operator
    (:func:`symmetric_planes` materializes it); it differs from the
    assembled one within assembly roundoff.

    ``planes64``: where the operator was assembled in float64 and ``planes``
    are its float32 rounding, the float64 planes themselves, which
    :meth:`astype` returns for float64 (else the planes are cast)."""

    def __init__(self, planes: torch.Tensor, plan, spmv: Callable = plane_spmv,
                 planes64: Optional[torch.Tensor] = None):
        self.planes = planes
        self.plan = tuple(tuple(tuple(int(v) for v in e) for e in row)
                          for row in plan)
        self.spmv = spmv
        self.planes64 = planes64

    @classmethod
    def from_block_ell(cls, A: BlockEllMatrix, order) -> "StencilBlockEll":
        """The plane layout of a BlockEllMatrix on a structured grid: one
        gather of the block array into structured order (set-up, ~1 pass
        over the operator)."""
        return cls.from_structured(StructuredBlockEll.from_block_ell(A, order), order)

    @classmethod
    def from_structured(cls, A_st: StructuredBlockEll, order) -> "StencilBlockEll":
        """The plane layout of a StructuredBlockEll: its SoA planes
        [4, nd, nd, nc] viewed on the (subclass, KY, KX) lattice (no copy)."""
        KY, KX = order.lattice
        nd = A_st.nd
        return cls(A_st.planes.reshape(4, nd, nd, 8, KY, KX), stencil_plan(order))

    @property
    def sym(self) -> bool:
        """Whether :meth:`matvec` applies the half-storage symmetric form."""
        return any(self.spmv is half for _, half in spmv_pairs())

    @property
    def nd(self) -> int:
        return self.planes.shape[1]

    @property
    def lattice(self) -> Tuple[int, int]:
        return self.planes.shape[-2], self.planes.shape[-1]

    @property
    def num_cells(self) -> int:
        return 8 * self.planes.shape[-2] * self.planes.shape[-1]

    def with_planes(self, planes: torch.Tensor) -> "StencilBlockEll":
        return StencilBlockEll(planes, self.plan, self.spmv)

    def astype(self, dtype: torch.dtype) -> "StencilBlockEll":
        if dtype == torch.float64 and self.planes64 is not None:
            return self.with_planes(self.planes64)
        return self.with_planes(self.planes.to(dtype))

    def symmetrized(self) -> "StencilBlockEll":
        """Same planes, half-storage symmetric matvec (see class docstring)."""
        return StencilBlockEll(self.planes, self.plan, half_storage(self.spmv), self.planes64)

    def neighbor_fields(self, X: torch.Tensor):
        """[4][nd, 8, KY, KX] neighbour fields (self + 3 slots) of X."""
        fields = [X]
        for s in range(3):
            per_k = []
            for k in range(8):
                ks, dy, dx = self.plan[k][s]
                per_k.append(torch.roll(X[:, ks], shifts=(-dy, -dx), dims=(1, 2)))
            fields.append(torch.stack(per_k, dim=1))
        return fields

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """X [nd, 8, KY, KX] -> A X in the same layout (the half-storage
        symmetric operator when ``sym``)."""
        return self.spmv(self.planes, X.contiguous(), self.plan)

    def diagonal_blocks(self) -> torch.Tensor:
        """[nd, nd, 8, KY, KX]."""
        return self.planes[0]

    def row_sums(self) -> torch.Tensor:
        """[4, nd, 8, KY, KX] with AZ[s,i,c] = sum_j W[s,i,j,c]."""
        return self.planes.sum(dim=2)


def symmetric_planes(S: StencilBlockEll) -> torch.Tensor:
    """The exactly symmetric operator that ``S.symmetrized()`` applies,
    materialized as full planes: the self block's upper triangle used both
    ways, and for each forward edge (k, s) ~ (ks, sp) with shift (dy, dx)
    the reverse slot Wsym[sp+1, j, i, ks] = roll(W[s+1, i, j, k], (dy, dx)).
    A second plane array: for operators that only take full planes (the
    sharded x-slab solver)."""
    W = S.planes
    Ws = torch.empty_like(W)
    for i in range(S.nd):
        for j in range(S.nd):
            Ws[0, i, j] = W[0, min(i, j), max(i, j)]
    for (k, s), (ks, sp) in sym_forward_edges(S.plan):
        _, dy, dx = S.plan[k][s]
        Ws[s + 1, :, :, k] = W[s + 1, :, :, k]
        Ws[sp + 1, :, :, ks] = torch.roll(W[s + 1, :, :, k], shifts=(dy, dx),
                                          dims=(-2, -1)).transpose(0, 1)
    return Ws


# -- smoother ----------------------------------------------------------------


def _block_inverse(A: StencilBlockEll) -> torch.Tensor:
    """Blockwise inverse of the diagonal nd x nd blocks, SoA layout (the
    closed-form 3x3 inverse for P1, ``torch.linalg.inv`` above), as one
    contiguous [nd, nd, 8, KY, KX] array."""
    D = torch.movedim(A.diagonal_blocks(), (0, 1), (-2, -1))  # [8, KY, KX, nd, nd]
    return torch.movedim(inv3x3(D) if A.nd == 3 else _inv(D), (-2, -1), (0, 1)).contiguous()


def jacobi_smoother(A: StencilBlockEll) -> Callable:
    """The block-Jacobi smoother: `_block_inverse` applied by ``block_jacobi``."""
    Dinv = _block_inverse(A)

    def apply(R: torch.Tensor) -> torch.Tensor:
        return block_jacobi(Dinv, R.contiguous())

    return apply


def estimate_lambda_max(A: StencilBlockEll, smoother: Callable, iters: int = 12,
                        seed: int = 0) -> torch.Tensor:
    """Power iteration on smoother o A from the reference's numpy start
    vector (set-up time; ``iters`` + 1 matvecs)."""
    KY, KX = A.lattice
    return _power_lambda_max(A.matvec, smoother, (A.nd, 8, KY, KX), A.planes.dtype,
                             device=A.planes.device, iters=iters, seed=seed)


def chebyshev_smoother(A: StencilBlockEll, degree: int = 3,
                       lmax: Optional[torch.Tensor] = None, ratio: float = 8.0,
                       lmax_safety: float = 1.1) -> Callable:
    """Chebyshev polynomial smoother in M_J^-1 A on [lmax/ratio, lmax], M_J
    the block-Jacobi smoother: a fixed symmetric positive operator, safe
    inside CG.  ``lmax`` defaults to :func:`estimate_lambda_max`."""
    Mj = jacobi_smoother(A)
    if lmax is None:
        lmax = estimate_lambda_max(A, Mj)
    return _cheb_apply(A.matvec, Mj, degree, torch.as_tensor(lmax), ratio=ratio,
                       lmax_safety=lmax_safety)


# -- aggregation, coarse bands and coarse solves in plane layout -------------


class _Aggregation2D(NamedTuple):
    """Fine plane layout -> 2D coarse lattice field [my, mx] (rows = y)."""

    aggsum: Callable      # [.., 8, KY, KX] -> [my, mx] (sums leading dims too)
    broadcast: Callable   # [my, mx] -> [8, KY, KX]
    mx: int
    my: int
    fy: int
    fx: int
    shape: tuple          # of a coarse vector: (my, mx)
    grid: Callable        # coarse vector -> its [my, mx] view (itself)


def _aggregation2d(A: StencilBlockEll, macro_shape) -> Optional[_Aggregation2D]:
    """Piecewise-constant aggregation onto the (mx, my) lattice, kept as a
    2D [my, mx] field (the middle levels' layout)."""
    KY, KX = A.lattice
    mx, my = int(macro_shape[0]), int(macro_shape[1])
    if KX % mx or KY % my:
        return None
    fy, fx = KY // my, KX // mx

    def aggsum(R):
        lead = R.shape[:-3]
        nl = len(lead)
        rc = R.reshape(lead + (8, my, fy, mx, fx))
        return rc.sum(dim=tuple(range(nl)) + (nl, nl + 2, nl + 4))

    def broadcast(yc):
        return yc[None, :, None, :, None].expand(8, my, fy, mx, fx).reshape(8, my * fy, mx * fx)

    return _Aggregation2D(aggsum, broadcast, mx, my, fy, fx, (my, mx), lambda yc: yc)


class _Aggregation(NamedTuple):
    aggsum: Callable      # [.., 8, KY, KX] -> [n_agg] (sums leading dims too)
    broadcast: Callable   # [n_agg] -> [8, KY, KX] scalar field
    mx: int
    my: int
    fy: int
    fx: int
    shape: tuple          # of a coarse vector: (n_agg,)
    grid: Callable        # coarse vector -> its [my, mx] view


def _aggregation(A: StencilBlockEll, macro_shape) -> Optional[_Aggregation]:
    """Piecewise-constant aggregation onto the (mx, my) macro lattice, with
    aggregate id = ix_macro * my + iy_macro (x-major: the block cyclic
    reduction of the coarse solve depends on this order)."""
    agg = _aggregation2d(A, macro_shape)
    if agg is None:
        return None
    mx, my = agg.mx, agg.my

    def aggsum(R):
        return agg.aggsum(R).t().reshape(-1)  # [my,mx] -> [mx,my] flat

    def grid(yc):
        return yc.view(mx, my).t()

    def broadcast(yc):
        return agg.broadcast(grid(yc))

    return _Aggregation(aggsum, broadcast, mx, my, agg.fy, agg.fx, (mx * my,), grid)


def _crossing_masks(f: int, d: int, n: int) -> dict:
    """{v: bool[n]} partition of lattice positions i by the aggregate offset
    v = (i+d)//f - i//f that the shift d produces under f-fold aggregation.
    Out-of-domain targets keep their arithmetic v: their stencil weights are
    zero, so they contribute nothing."""
    i = np.arange(n)
    dA = (i + d) // f - i // f
    return {int(v): (dA == v) for v in np.unique(dA)}


@lru_cache(maxsize=None)
def _mask_vectors(f: int, d: int, n: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """((v, 0/1 mask on the device), ...) of ``_crossing_masks``, copied to
    the device once per lattice (a copy from the host waits for the device)."""
    return tuple((v, upload(m, device, dtype))
                 for v, m in _crossing_masks(f, d, n).items())


def _masked_fields(field: torch.Tensor, f: Tuple[int, int], d: Tuple[int, int]):
    """[(vy, vx), field * mask] for every aggregate offset the 2D shift d
    produces under the (fy, fx) aggregation of field's last two axes."""
    (fy, fx), (dy, dx) = f, d
    n_y, n_x = field.shape[-2:]
    out = []
    for vy, wy in _mask_vectors(fy, dy, n_y, field.dtype, field.device):
        for vx, wx in _mask_vectors(fx, dx, n_x, field.dtype, field.device):
            out.append(((vy, vx), field * wy[:, None] * wx[None, :]))
    return out


def _ordered_sum(terms) -> torch.Tensor:
    """Sum over the leading axis (or a list), one term after the other: the
    order of the reference's XLA reductions.  The coarse operators are
    ill-conditioned, so their rounding shows in the coarse solves."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _block_sums(field: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """[..., my*fy, mx*fx] -> [..., my, mx]: sums over each fy x fx block in
    row-major order (``_ordered_sum``)."""
    ny, nx = field.shape[-2:]
    t = field.reshape(field.shape[:-2] + (ny // fy, fy, nx // fx, fx))
    return _ordered_sum([t[..., a, :, b] for a in range(fy) for b in range(fx)])


def _accumulate(keys, contribs) -> dict:
    """{key: sum of its contributions}, keys in first-seen order, each sum
    taken in order (the reference's ``bands.get(key, 0) + contrib``)."""
    out: dict = {}
    for key, c in zip(keys, contribs):
        out[key] = out[key] + c if key in out else c
    return out


def _coarse_bands(A: StencilBlockEll, agg: _Aggregation, P: torch.Tensor) -> dict:
    """Bands of E = Z_w^T A Z_w keyed by aggregate offset (vy, vx), each a
    [n_agg] vector in x-major order: each (subclass, slot) family
    contributes to at most 4 aggregate offsets (crossing 0/1 macro
    boundaries per axis).  ``P`` [4, 8, KY, KX]: the (weighted) pairing
    sums of the planes."""
    my, fy, mx, fx = agg.my, agg.fy, agg.mx, agg.fx

    def x_major(v):  # [..., my, mx] -> [..., mx * my]
        return v.transpose(-1, -2).reshape(v.shape[:-2] + (mx * my,))

    # self slot: sum over (subclass, fy, fx) in row-major order
    self_terms = P[0].reshape(8, my, fy, mx, fx).permute(0, 2, 4, 1, 3).reshape(-1, my, mx)
    # every (subclass, slot) family's masked pairing field, then all their
    # aggregate sums at once
    keys, fields = [(0, 0)], []
    for s in range(3):
        for k in range(8):
            for key, field in _masked_fields(P[s + 1, k], (fy, fx), A.plan[k][s][1:]):
                keys.append(key)
                fields.append(field)
    vecs = x_major(_block_sums(torch.stack(fields), fy, fx))  # [n_fields, n_agg]
    return _accumulate(keys, [x_major(_ordered_sum(self_terms))] + list(vecs))


def _stencil_bands(A: StencilBlockEll, agg: _Aggregation2D,
                   P: Optional[torch.Tensor] = None) -> dict:
    """Galerkin coarse operator E = Z^T A Z of the piecewise-constant
    aggregation as stencil bands {(vy, vx): [my, mx]} on the coarse lattice
    (E[a, a+v] = band[v][a]), applied with rolls.  ``P`` [4, 8, KY, KX]: the
    per-(slot, subclass) pairing sums (default 1^T W 1; the w-weighted sums
    for a weighted deflation space Z_w)."""
    fy, fx = agg.fy, agg.fx
    if P is None:
        P = A.planes.sum(dim=(1, 2))
    keys, fields = [], []
    for s in range(3):
        for k in range(8):
            for key, field in _masked_fields(P[s + 1, k], (fy, fx), A.plan[k][s][1:]):
                keys.append(key)
                fields.append(field)
    contribs = _block_sums(torch.stack(fields), fy, fx)  # [n_fields, my, mx]
    self_band = _block_sums(_ordered_sum(P[0]), fy, fx)
    return _accumulate([(0, 0)] + keys, [self_band] + list(contribs))


def _band_matvec(bands: dict) -> Callable:
    """y[a] = sum_v band[v][a] * x[a+v] via 2-axis rolls (band entries whose
    target is out of domain are zero, so the wrap reads are harmless)."""
    diag = bands[(0, 0)]
    off = [(v, b) for v, b in bands.items() if v != (0, 0)]

    def mv(x):
        out = diag * x
        for (vy, vx), b in off:
            out = torch.addcmul(out, b, torch.roll(x, shifts=(-vy, -vx), dims=(0, 1)))
        return out

    return mv


def _aggregate_bands(bands: dict, my: int, mx: int, gy: int, gx: int) -> dict:
    """Re-aggregate stencil bands on an [my, mx] lattice by (gy, gx) -> bands
    on the [my//gy, mx//gx] lattice (Galerkin: Z2^T E Z2)."""
    keys, fields = [], []
    for v, b in bands.items():
        for key, field in _masked_fields(b, (gy, gx), v):
            keys.append(key)
            fields.append(field)
    return _accumulate(keys, list(_block_sums(torch.stack(fields), gy, gx)))


def _bands_to_dense(bands: dict, my: int, mx: int) -> torch.Tensor:
    """Dense float32 [mx*my, mx*my] operator from stencil bands, in the
    x-major flat ordering id = ax*my + ay of ``_coarse_inverse_bcr``.  Each
    entry comes from one band (a key fixes the column offset), so one
    scatter of all bands writes E; its indices cross from the host once."""
    ay, ax = np.mgrid[0:my, 0:mx]
    n = mx * my
    src, dst = [], []
    for i, (vy, vx) in enumerate(bands):
        by, bx = ay + vy, ax + vx
        valid = (by >= 0) & (by < my) & (bx >= 0) & (bx < mx)
        src.append(i * n + np.flatnonzero(valid))  # in the stacked [n_bands, my, mx]
        dst.append((ax * my + ay)[valid] * n + (bx * my + by)[valid])
    vals = torch.stack(list(bands.values())).to(torch.float32).reshape(-1)
    idx = upload(np.stack([np.concatenate(src), np.concatenate(dst)]), vals.device)
    E = torch.zeros(n * n, dtype=torch.float32, device=vals.device)
    E[idx[1]] = vals[idx[0]]
    return E.reshape(n, n)


def _coarse_E_banded(A: StencilBlockEll, agg: _Aggregation, P: torch.Tensor) -> torch.Tensor:
    """Dense E = Z_w^T A Z_w from `_coarse_bands` (small coarse spaces only)."""
    mx, my = agg.mx, agg.my
    n = mx * my
    bands = _coarse_bands(A, agg, P)
    E = torch.zeros((n, n), dtype=A.planes.dtype, device=A.planes.device)
    a = torch.arange(n, device=A.planes.device)
    amx, amy = a // my, a % my
    for (vy, vx), vec in bands.items():
        off = vx * my + vy
        valid = ((amx + vx >= 0) & (amx + vx < mx)
                 & (amy + vy >= 0) & (amy + vy < my))
        # E[a, a + off] += vec[a] on valid rows; valid rows keep a + off in
        # range, so the band is exactly one diagonal of E
        vals = torch.where(valid, vec, torch.zeros_like(vec))
        E = E + torch.diag(vals[max(0, -off): n - max(0, off)], off)
    return E


def _shift_down(T: torch.Tensor) -> torch.Tensor:
    """[T[n-1] dropped, zero block first]: block i gets T[i-1]."""
    return torch.cat([torch.zeros_like(T[:1]), T[:-1]])


def _shift_up(T: torch.Tensor) -> torch.Tensor:
    """Block i gets T[i+1], the last a zero block."""
    return torch.cat([T[1:], torch.zeros_like(T[:1])])


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[even[0], odd[0], even[1], odd[1], ...] along the first axis."""
    return torch.stack([even, odd], dim=1).reshape((2 * even.shape[0],) + tuple(even.shape[1:]))


def _block_tridiag_solve(B: torch.Tensor, C: torch.Tensor,
                         R: torch.Tensor) -> torch.Tensor:
    """Solve the symmetric block-tridiagonal system

        C_{i-1}^T y_{i-1} + B_i y_i + C_i y_{i+1} = r_i,  i = 0..n-1

    for a batch of right-hand sides by block cyclic reduction: log2(n)
    levels of batched [m,m] x [m,N] products.  B [n,m,m], C [n,m,m] with
    C[n-1] == 0, R [n,m,N]; n must be a power of two."""
    n = B.shape[0]
    if n == 1:
        count("host.syncs")  # torch.linalg.solve checks its result on the host
        return torch.linalg.solve(B[0], R[0])[None]
    Binv_odd = _inv(B[1::2])   # [n/2, m, m]
    CL = C[0::2]   # C[2e]   : even 2e   -> odd 2e+1
    CRo = C[1::2]  # C[2e+1] : odd 2e+1  -> even 2e+2  (last is C[n-1] = 0)
    G = CL @ Binv_odd
    H = CRo.transpose(-1, -2) @ Binv_odd
    B_new = B[0::2] - G @ CL.transpose(-1, -2) - _shift_down(H @ CRo)
    C_new = -(G @ CRo)
    R_odd = R[1::2]
    R_new = R[0::2] - G @ R_odd - _shift_down(H @ R_odd)
    y_even = _block_tridiag_solve(B_new, C_new, R_new)
    # back-substitute odds: y[2e+1] = Binv (r - CL^T y[2e] - CRo y[2e+2])
    return _interleave(y_even, Binv_odd @ (R_odd - CL.transpose(-1, -2) @ y_even
                                           - CRo @ _shift_up(y_even)))


def _newton_schulz(Es: torch.Tensor, Einv: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` Newton-Schulz polish passes, then exact symmetrization."""
    two_eye = 2.0 * torch.eye(Es.shape[0], dtype=Es.dtype, device=Es.device)
    for _ in range(steps):
        Einv = Einv @ (two_eye - Es @ Einv)
    return 0.5 * (Einv + Einv.t())


def _coarse_inverse_bcr(E: torch.Tensor, mx: int, my: int,
                        newton_schulz: int = 2) -> Callable:
    """Dense symmetrized inverse of the diagonally-scaled coarse operator via
    block cyclic reduction (the x-major coarse lattice is block-tridiagonal
    with mx blocks of size my) + Newton-Schulz polish, in float32."""
    n_agg = mx * my
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30))
    Es = ((E / d[:, None]) / d[None, :]).to(torch.float32)
    E4 = Es.reshape(mx, my, mx, my)
    ix = torch.arange(mx, device=E.device)
    B = E4[ix, :, ix, :]                     # [mx, my, my]
    C = torch.cat([E4[ix[:-1], :, ix[:-1] + 1, :],
                   torch.zeros((1, my, my), dtype=Es.dtype, device=Es.device)])
    # pad mx to a power of two with decoupled identity blocks
    n2 = 1 << (mx - 1).bit_length()
    R = torch.eye(n_agg, dtype=Es.dtype, device=Es.device).reshape(mx, my, n_agg)
    if n2 != mx:
        eye = torch.eye(my, dtype=Es.dtype, device=Es.device).expand(n2 - mx, my, my)
        B = torch.cat([B, eye])
        C = torch.cat([C, torch.zeros((n2 - mx, my, my), dtype=Es.dtype, device=Es.device)])
        R = torch.cat([R, torch.zeros((n2 - mx, my, n_agg), dtype=Es.dtype,
                                      device=Es.device)])
    Einv = _block_tridiag_solve(B, C, R)[:mx].reshape(n_agg, n_agg)
    Einv = _newton_schulz(Es, Einv, newton_schulz)

    def solve(rc):
        y = Einv @ (rc / d).to(torch.float32)
        return (y / d).to(rc.dtype)

    return solve


def _coarse_inverse(E: torch.Tensor, newton_schulz: int = 3) -> Callable:
    """Dense symmetrized inverse of the diagonally-scaled coarse operator
    (float32 LU + Newton-Schulz polish)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30))
    Es = ((E / d[:, None]) / d[None, :]).to(torch.float32)
    Einv = _newton_schulz(Es, _inv(Es), newton_schulz)

    def solve(rc):
        y = Einv @ (rc / d).to(torch.float32)
        return (y / d).to(rc.dtype)

    return solve


def _coarse_E(A: StencilBlockEll, agg: _Aggregation,
              P: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense E = Z^T A Z via one scatter-add (the sorting accumulate, the
    same in every build) of the plane pairing sums (set-up; equal to
    `_coarse_E_banded` up to summation order).  ``P``
    [4, 8, KY, KX]: the (weighted) pairing sums, default 1^T W 1."""
    KY, KX = A.lattice
    mx, my, fy, fx = agg.mx, agg.my, agg.fy, agg.fx
    n_agg = mx * my
    iy, ix = np.meshgrid(np.arange(KY), np.arange(KX), indexing="ij")
    agg_field = (ix // fx) * my + (iy // fy)  # [KY, KX]
    rows = np.broadcast_to(agg_field, (4, 8, KY, KX))
    cols = np.empty((4, 8, KY, KX), dtype=np.int64)
    cols[0] = agg_field
    valid = np.ones((4, 8, KY, KX), dtype=bool)
    for s in range(3):
        for k in range(8):
            _, dy, dx = A.plan[k][s]
            cols[s + 1, k] = np.roll(agg_field, (-dy, -dx), axis=(0, 1))
            # wrapped entries carry zero blocks; masked all the same
            if dy:
                valid[s + 1, k, slice(KY - dy, None) if dy > 0 else slice(None, -dy)] = False
            if dx:
                valid[s + 1, k, :, slice(KX - dx, None) if dx > 0 else slice(None, -dx)] = False
    if P is None:
        P = A.planes.sum(dim=(1, 2))
    dev = P.device
    flat = upload((rows * n_agg + cols).reshape(-1), dev)
    sums = P.reshape(-1) * upload(valid.reshape(-1), dev, P.dtype)
    E = torch.zeros(n_agg * n_agg, dtype=P.dtype, device=dev)
    return E.index_put_((flat,), sums, accumulate=True).reshape(n_agg, n_agg)


def _bands_to_blocktridiag(bands: dict, mx: int, my: int):
    """(B, C) [mx, my, my] block-tridiagonal form of the x-major banded E
    (|vx| <= 1, i.e. aggregation factor fx >= 2).  C_i couples block i to
    i + 1; it averages the two assembled copies of each coupling (the +1
    and the -1 band, equal up to assembly rounding since E is symmetric),
    so the cyclic reduction's C / C^T convention holds exactly."""
    vec0 = next(iter(bands.values()))
    dt, dev = vec0.dtype, vec0.device
    B = torch.zeros((mx, my, my), dtype=dt, device=dev)
    C_up = torch.zeros_like(B)
    C_lo = torch.zeros_like(B)
    ay = np.arange(my)
    for (vy, vx), vec in bands.items():
        if abs(vx) > 1:
            raise ValueError(f"band vx={vx}: coarse lattice not block-tridiagonal "
                             "(needs aggregation factor fx >= 2)")
        V = vec.reshape(mx, my)
        by = ay + vy
        ok = (by >= 0) & (by < my)
        r = upload(ay[ok], dev)
        c = upload(by[ok], dev)
        if vx == 0:
            B[:, r, c] += V[:, r]
        elif vx == 1:  # row (ax, ay) -> col (ax+1, ay+vy), stored at block ax
            C_up[:-1, r, c] += V[:-1, r]
        else:  # row (ax, ay) -> col (ax-1, ay+vy): C[ax-1][ay+vy, ay]
            C_lo[:-1, c, r] += V[1:, r]
    return B, 0.5 * (C_up + C_lo)


def _block_tridiag_factor(B: torch.Tensor, C: torch.Tensor) -> list:
    """Factor phase of block cyclic reduction (see `_block_tridiag_solve`):
    per level the elimination tensors (Binv_odd, G, H, CL, CRo), then the
    inverse of the last block.  O(n m^2) memory, so each later solve
    streams far less than a dense inverse would."""
    levels = []
    while B.shape[0] > 1:
        Binv_odd = _inv(B[1::2])
        CL, CRo = C[0::2], C[1::2]
        G = CL @ Binv_odd
        H = CRo.transpose(-1, -2) @ Binv_odd
        B = B[0::2] - G @ CL.transpose(-1, -2) - _shift_down(H @ CRo)
        C = -(G @ CRo)
        levels.append((Binv_odd, G, H, CL, CRo))
    levels.append(_inv(B[0]))
    return levels


def _block_tridiag_apply(levels: list, R: torch.Tensor) -> torch.Tensor:
    """Solve with `_block_tridiag_factor` levels; R [n, m, N]."""
    stack = []
    for _Binv_odd, G, H, _CL, _CRo in levels[:-1]:
        R_odd = R[1::2]
        R = R[0::2] - G @ R_odd - _shift_down(H @ R_odd)
        stack.append(R_odd)
    y = (levels[-1] @ R[0])[None]
    for (Binv_odd, _G, _H, CL, CRo), R_odd in zip(reversed(levels[:-1]), reversed(stack)):
        y = _interleave(y, Binv_odd @ (R_odd - CL.transpose(-1, -2) @ y - CRo @ _shift_up(y)))
    return y


def _factored_tridiag_solve(Bs: torch.Tensor, Cs: torch.Tensor, refine: int,
                            residual_dtype: torch.dtype) -> Callable:
    """Direct solve of the scaled block-tridiagonal system (Bs, Cs) [mx, m, m]
    for one right-hand side r [mx, m, 1] by factored cyclic reduction, mx
    padded to a power of two with identity blocks.  ``refine`` defect
    corrections follow, each with the residual in ``residual_dtype``: with a
    float64 residual each squares the float32 solve's error; with a float32
    one they are skipped (its residual is noise-limited), as they are for
    an operator that is not float32."""
    mx, my, wdt = Bs.shape[0], Bs.shape[1], Bs.dtype
    n2 = 1 << (mx - 1).bit_length()
    pad = Bs.new_zeros((n2 - mx, my, 1))
    eye = torch.eye(my, dtype=wdt, device=Bs.device).expand(n2 - mx, my, my)
    levels = _block_tridiag_factor(torch.cat([Bs, eye]), torch.cat([Cs, pad.new_zeros(
        (n2 - mx, my, my))]))
    nref = 0 if (residual_dtype == torch.float32 or wdt != torch.float32) else refine
    if nref:
        Br, Cr = Bs.to(residual_dtype), Cs.to(residual_dtype)
        CpT = _shift_down(Cr).transpose(-1, -2)

    def apply(r):
        return _block_tridiag_apply(levels, torch.cat([r, pad]))[:mx]

    def solve(r):
        y = apply(r)
        if nref:
            r_hi = r.to(residual_dtype)
        for _ in range(nref):
            y_hi = y.to(residual_dtype)
            res = r_hi - (Br @ y_hi + Cr @ _shift_up(y_hi) + CpT @ _shift_down(y_hi))
            y = y + apply(res.to(wdt))
        return y

    return solve


def _factored_bcr_solve_from_blocks(B: torch.Tensor, C: torch.Tensor, mx: int, my: int,
                                    refine: int = 1,
                                    residual_dtype: torch.dtype = torch.float64) -> Callable:
    """Coarse solve from the block-tridiagonal (B, C) directly, never dense
    (the (200, 40) coarse space is 8000 aggregates): blockwise symmetric
    diagonal scaling, then `_factored_tridiag_solve`.  Returns the solve of
    a flat x-major [mx * my] right-hand side."""
    d = torch.sqrt(torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1).abs(), min=1e-30))  # [mx, my]
    Bs = B / (d[:, :, None] * d[:, None, :])
    d_next = torch.cat([d[1:], torch.ones_like(d[:1])])  # C[mx - 1] = 0 couples nothing
    Cs = C / (d[:, :, None] * d_next[:, None, :])
    tri = _factored_tridiag_solve(Bs, Cs, refine, residual_dtype)

    def solve(rc):
        y = tri((rc.reshape(mx, my) / d).to(B.dtype)[:, :, None])
        return (y[:, :, 0] / d).reshape(-1).to(rc.dtype)

    return solve


def _coarse_inverse_bcr_factored(E: torch.Tensor, mx: int, my: int, refine: int = 1,
                                 residual_dtype: torch.dtype = torch.float64) -> Callable:
    """Coarse solve of a dense x-major E by factored block cyclic reduction
    on its diagonally scaled block-tridiagonal part: a direct solve per
    application, in E's dtype, with ``refine`` defect corrections whose
    residual is taken in ``residual_dtype`` (`_factored_tridiag_solve`)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30))
    E4 = ((E / d[:, None]) / d[None, :]).reshape(mx, my, mx, my)
    ix = torch.arange(mx, device=E.device)
    B = E4[ix, :, ix, :]
    C = torch.cat([E4[ix[:-1], :, ix[:-1] + 1, :], E.new_zeros((1, my, my))])
    tri = _factored_tridiag_solve(B, C, refine, residual_dtype)

    def solve(rc):
        y = tri((rc / d).to(E.dtype).reshape(mx, my, 1))
        return (y.reshape(-1) / d).to(rc.dtype)

    return solve


def _exact_inverse(E: torch.Tensor, mx: int, my: int, fx: int, newton_schulz: int,
                   residual_dtype: torch.dtype) -> Callable:
    """The exact coarse solve of a dense x-major E: factored BCR above 4096
    aggregates and dense BCR up to it when the aggregation factor in x is
    >= 2 (the coarse lattice is then block-tridiagonal), the dense LU
    inverse when fx == 1 (|dx| = 2 shifts couple macro columns two apart,
    which BCR would drop)."""
    if fx >= 2 and mx * my > 4096:
        return _coarse_inverse_bcr_factored(E, mx, my, residual_dtype=residual_dtype)
    if fx >= 2:
        return _coarse_inverse_bcr(E, mx, my, newton_schulz)
    return _coarse_inverse(E, newton_schulz)


# -- Chebyshev acceleration and the middle levels ----------------------------


def _power_lambda_max(matvec: Callable, precond: Callable, shape, dtype,
                      device=None, iters: int = 12, seed: int = 0) -> torch.Tensor:
    """Power iteration for lambda_max(precond o matvec) from the reference's
    numpy start vector (set-up time)."""
    rng = np.random.default_rng(seed)
    v = upload(rng.standard_normal(shape), device, dtype)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = precond(matvec(v))
        v = w / torch.linalg.norm(w)
    w = precond(matvec(v))
    return _dot(v, w) / _dot(v, v)


def _cheb_apply(matvec: Callable, precond: Callable, degree: int, lmax,
                ratio: float = 8.0, lmax_safety: float = 1.1) -> Callable:
    """Chebyshev polynomial approximation of (matvec)^-1 preconditioned by
    ``precond`` on the spectral interval [lmax/ratio, lmax] of
    precond o matvec: a fixed symmetric positive operator, safe as (part of)
    a PCG preconditioner.  The recurrence's scalars are taken once, on the
    host, in lmax's precision (one sync at set-up)."""
    f = np.float32 if lmax.dtype == torch.float32 else np.float64
    lmax = f(host_read(lmax)) * f(lmax_safety)
    lmin = lmax / f(ratio)
    theta = f(0.5) * (lmax + lmin)
    delta = f(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f(1.0) / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        coeffs.append((float(rho_new * rho), float(f(2.0) * rho_new / delta)))
        rho = rho_new
    theta = float(theta)

    def apply(R):
        d = precond(R) / theta
        x = d
        for c_d, c_p in coeffs:
            r = R - matvec(x)
            d = torch.add(c_d * d, precond(r), alpha=c_p)
            x = x + d
        return x

    return apply


def _middle_inverse(bands1: dict, my1: int, mx1: int, macro_shape,
                    newton_schulz: int = 2, cheb_degree: int = 2, cheb_ratio: float = 8.0,
                    dtype=torch.float32,
                    residual_dtype: torch.dtype = torch.float64) -> Callable:
    """Approximate inverse of the middle-level stencil operator E1 (bands on
    an [my1, mx1] lattice): the balanced two-level operator with the exact
    ``macro_shape`` coarse solve, Chebyshev-wrapped (`_multilevel_inverse`
    with one level below)."""
    return _multilevel_inverse(bands1, my1, mx1, [tuple(macro_shape)],
                               newton_schulz=newton_schulz, cheb_degree=cheb_degree,
                               cheb_ratio=cheb_ratio, dtype=dtype,
                               residual_dtype=residual_dtype)


def _multilevel_inverse(bands1: dict, my1: int, mx1: int, shapes,
                        newton_schulz: int = 2, cheb_degree: int = 2,
                        cheb_ratio: float = 8.0, dtype=torch.float32,
                        residual_dtype: torch.dtype = torch.float64) -> Callable:
    """Approximate inverse of the stencil operator E1 (bands on an [my1, mx1]
    lattice).  ``shapes``: successively coarser (mx, my) lattices below it;
    the last one is solved exactly (`_exact_inverse`; ``residual_dtype`` is
    its factored BCR's defect-correction precision), every intermediate one
    by recursion.  Each level is the balanced two-level operator (Jacobi on
    the band diagonal + the next level's inverse as its coarse solve),
    Chebyshev-wrapped for ``cheb_degree`` >= 2, so the chain is a fixed SPD
    operator and the enclosing PCG stays a valid PCG.  Raises ValueError
    where a lattice does not tile the one above it."""
    mx2, my2 = int(shapes[0][0]), int(shapes[0][1])
    if mx1 % mx2 or my1 % my2:
        raise ValueError(f"lattice {(mx2, my2)} does not tile {(mx1, my1)}")
    gy, gx = my1 // my2, mx1 // mx2
    bands2 = _aggregate_bands(bands1, my1, mx1, gy, gx)
    if len(shapes) == 1:
        E2 = _bands_to_dense(bands2, my2, mx2)
        coarse2_flat = _exact_inverse(E2, mx2, my2, gx, newton_schulz, residual_dtype)

        def coarse2(r2d):  # [my2, mx2] -> [my2, mx2] via the x-major flat solve
            return coarse2_flat(r2d.t().reshape(-1)).reshape(mx2, my2).t()
    else:
        coarse2 = _multilevel_inverse(bands2, my2, mx2, shapes[1:],
                                      newton_schulz=newton_schulz, cheb_degree=cheb_degree,
                                      cheb_ratio=cheb_ratio, dtype=dtype,
                                      residual_dtype=residual_dtype)
    E1mv = _band_matvec(bands1)
    d1 = bands1[(0, 0)]
    Dinv = torch.where(d1 != 0, 1.0 / torch.where(d1 != 0, d1, torch.ones_like(d1)),
                       torch.zeros_like(d1))

    def Q2(r):  # aggregate sums, coarse solve, broadcast back
        yc = coarse2(r.reshape(my2, gy, mx2, gx).sum(dim=(1, 3)))
        return yc[:, None, :, None].expand(my2, gy, mx2, gx).reshape(my1, mx1)

    def P1(r):
        qr = Q2(r)
        s = Dinv * (r - E1mv(qr))
        return qr + s - Q2(E1mv(s))

    if cheb_degree < 2:
        return P1
    lmax = _power_lambda_max(E1mv, P1, (my1, mx1), dtype, device=d1.device)
    return _cheb_apply(E1mv, P1, cheb_degree, lmax, ratio=cheb_ratio)


def stencil_deflation_preconditioner(A: StencilBlockEll, macro_shape,
                                     weight: torch.Tensor,
                                     smoother: Optional[Callable] = None,
                                     newton_schulz: int = 3, mid_shape=None,
                                     mid_cheb: int = 2,
                                     residual_dtype: torch.dtype = torch.float64) -> Callable:
    """Balanced two- or three-level preconditioner in the plane layout,

        M^-1 r = Q r + (I - Q A) S (I - A Q) r,   Q = Z_w E^-1 Z_w^T,

    with S the ``smoother`` (block Jacobi by default) and Z_w = diag(w) Z the weighted
    piecewise-constant aggregation onto ``macro_shape``.  ``weight``
    [nd, 8, KY, KX] is sqrt(diag A) = 1/s for a diagonally scaled system, so
    the coarse space contains the scaled near-kernel D^{1/2} 1.  The
    A-projections ride precomputed weighted AZ planes
    (AZ[s,i] = sum_j W[s,i,j] w_j(neighbour)) instead of full matvecs.

    ``mid_shape=(mx1, my1)``, or a finest-first list of such shapes: the
    three-level (multi-level) form for lattices where the ``macro_shape``
    space alone degrades.  Z_w aggregates onto the first mid lattice; its
    Galerkin operator E1 is a 9-point stencil of bands, inverted
    approximately by ``_multilevel_inverse`` down to the exact
    ``macro_shape`` level, Chebyshev-wrapped with degree ``mid_cheb``.

    The exact level: dense LU (fx == 1), dense BCR up to 4096 aggregates,
    above that (two-level) the factored BCR straight from the coarse bands,
    never densified; ``residual_dtype`` is the precision of the factored
    solves' defect correction (float32: none).  The preconditioner is built
    from ``A.planes``, the assembled operator, also when A applies the
    symmetric form."""
    with span("deflation.build", device=True):
        # weighted pairing sums P_w[s,k] = sum_ij w_i W[s,i,j] w_j(neighbour)
        wnbr = A.neighbor_fields(weight)  # [4][nd, 8, KY, KX]
        Pw = torch.stack([(weight[:, None] * A.planes[s] * wnbr[s][None, :]).sum(dim=(0, 1))
                          for s in range(4)])  # [4, 8, KY, KX]
        if mid_shape is not None:
            mids = ([tuple(mid_shape)] if isinstance(mid_shape[0], (int, np.integer))
                    else [tuple(m) for m in mid_shape])
            agg = _aggregation2d(A, mids[0])
        else:
            agg = _aggregation(A, macro_shape)
        if agg is None:
            raise ValueError(f"aggregation lattice {tuple(mid_shape or macro_shape)} does not "
                             f"tile the stencil lattice {A.lattice}")
        count("deflation.aggregates", agg.mx * agg.my)
        if mid_shape is not None:
            count("deflation.coarse.multilevel")
            coarse = _multilevel_inverse(_stencil_bands(A, agg, Pw), agg.my, agg.mx,
                                         mids[1:] + [tuple(macro_shape)],
                                         newton_schulz=newton_schulz, cheb_degree=mid_cheb,
                                         dtype=A.planes.dtype, residual_dtype=residual_dtype)
        elif agg.fx >= 2 and agg.mx * agg.my > 4096:
            count("deflation.coarse.factored_bcr")
            Bb, Cb = _bands_to_blocktridiag(_coarse_bands(A, agg, Pw), agg.mx, agg.my)
            coarse = _factored_bcr_solve_from_blocks(Bb, Cb, agg.mx, agg.my,
                                                     residual_dtype=residual_dtype)
        else:
            count("deflation.coarse.dense")
            coarse = _exact_inverse(_coarse_E_banded(A, agg, Pw), agg.mx, agg.my, agg.fx,
                                    newton_schulz, residual_dtype)

        AZ = torch.stack([(A.planes[s] * wnbr[s][None, :]).sum(dim=1)
                          for s in range(4)])  # [4, nd, 8, KY, KX]
        fine = fine_level(AZ, weight, A.plan, agg,
                          Dinv=_block_inverse(A) if smoother is None else None)
        return _deflation_apply(fine, coarse, smoother)


def _deflation_apply(fine: FineLevel, coarse: Callable,
                     smoother: Optional[Callable] = None) -> Callable:
    """M^-1 r = Z_w y1 + S - Z_w y2 with y1 = E^-1 Z_w^T r, S the smoothed
    residual and y2 = E^-1 Z_w^T A S: the fine level's four passes
    (``kernels/deflation_apply``) around two coarse solves.  Block Jacobi
    (``smoother`` None) is fused into the residual pass; a caller's
    smoother is applied to the residual it writes."""

    def apply(R):
        count("deflation.applies")
        R = R.contiguous()
        yc = coarse(weighted_sums(fine, R))
        s = residual(fine, R, yc)
        if smoother is not None:
            s = smoother(s)
        return combine(fine, yc, s, coarse(zt_a(fine, s)))

    return apply


# -- mixed-precision refined PCG ---------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _applied(op: Callable, V: torch.Tensor, adt: torch.dtype, vdt: torch.dtype) -> torch.Tensor:
    """``op`` applied to V in ``adt``, the result in ``vdt``."""
    return op(V.to(adt)).to(vdt)


def _vdot(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return _dot(a.to(dt), b.to(dt))


def _ratio(num: torch.Tensor, den: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """num / den where den > 0, else 0, in ``dtype``: PCG's alpha and beta."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(den)).to(dtype)


class _Pcg:
    """The PCG in the plane layout for one (A, M) pair: a loop over fixed
    buffers X, R, P and rz with two bodies, ``_init`` (X = 0, Z = M(R),
    P = Z, rz = (R, Z)) and ``_step`` (one iteration, updated in place:
    X += alpha P, R -= alpha AP, P = beta P + Z).  A and M are applied in
    ``adt``, the Krylov vectors kept in ``vdt``, the dots taken in ``dt``.
    The caller loads each rhs into R.

    On CUDA tensors both bodies are captured as CUDA graphs at the first
    ``pcg`` and replayed by every later one.  On the CPU, and where M asks
    for a host synchronization during the capture (``SyncInCapture``), the
    same bodies run directly on the same buffers.

    Outside a capture each application of M runs in a ``precond.apply``
    span and of A in a ``matvec`` span; a replay opens none.  Counters:
    ``pcg.graph.captures`` (one per graph), ``pcg.graph.replays`` (init and
    step), ``pcg.graph.eager_fallbacks``; the capture runs in a
    ``pcg.graph.capture`` span, and the counts made while capturing (the
    kernels' launches) count again at each replay."""

    def __init__(self, A: StencilBlockEll, M: Callable, shape, adt: torch.dtype,
                 vdt: torch.dtype, dt: torch.dtype, device: torch.device):
        self.A, self.M, self.adt, self.vdt, self.dt = A, M, adt, vdt, dt
        self.X = torch.empty(shape, dtype=vdt, device=device)
        self.R = torch.empty_like(self.X)
        self.P = torch.empty_like(self.X)
        self.rz = torch.empty((), dtype=dt, device=device)
        self.bodies = None  # (init, step) once chosen: the bodies or their graphs' replays

    def _apply(self, name: str, op: Callable, V: torch.Tensor) -> torch.Tensor:
        """``op`` applied to V in ``adt``, the result in ``vdt``; in a span
        ``name`` outside a capture."""
        if capturing():
            return _applied(op, V, self.adt, self.vdt)
        with span(name):
            return _applied(op, V, self.adt, self.vdt)

    def _init(self):
        self.X.zero_()
        Z = self._apply("precond.apply", self.M, self.R)
        self.P.copy_(Z)
        self.rz.copy_(_vdot(self.R, Z, self.dt))

    def _step(self):
        X, R, P, rz, vdt, dt = self.X, self.R, self.P, self.rz, self.vdt, self.dt
        AP = self._apply("matvec", self.A.matvec, P)
        alpha = _ratio(rz, _vdot(P, AP, dt), vdt)
        X.add_(alpha * P)
        R.sub_(alpha * AP)
        Z = self._apply("precond.apply", self.M, R)
        rz_new = _vdot(R, Z, dt)
        beta = _ratio(rz_new, rz, vdt)
        P.mul_(beta).add_(Z)
        rz.copy_(rz_new)

    def _capture(self):
        """Captures init and step into one private memory pool on a side
        stream and returns their replays, or the bodies themselves where M
        cannot be captured.  The cuBLAS workspaces are dropped before and
        after, so the one the capture takes lives in that pool, is freed
        with the graphs, and no workspace is held from outside it."""
        current = torch.cuda.current_stream(self.X.device)
        stream = torch.cuda.Stream(self.X.device)
        stream.wait_stream(current)
        pool = torch.cuda.graph_pool_handle()
        replays = []
        with span("pcg.graph.capture"):
            torch._C._cuda_clearCublasWorkspaces()
            try:
                with torch.cuda.stream(stream):
                    for body in (self._init, self._step):
                        graph = torch.cuda.CUDAGraph()
                        with captured_counts() as counts:
                            graph.capture_begin(pool=pool)
                            try:
                                body()
                            finally:
                                graph.capture_end()
                        replays.append(_replay(graph, counts))
                        count("pcg.graph.captures")
            except SyncInCapture:
                count("pcg.graph.eager_fallbacks")
                return self._init, self._step
            finally:
                torch._C._cuda_clearCublasWorkspaces()
                current.wait_stream(stream)
        return tuple(replays)

    def pcg(self, rtol: float, maxiter: int, unroll: int, B: Optional[torch.Tensor] = None):
        """`stencil_pcg` on the rhs in R (``B`` loaded into it first where
        given); returns (X, iterations), X the buffer that the next call
        overwrites."""
        with span("pcg", device=True):
            if B is not None:
                self.R.copy_(B)
            if self.bodies is None:
                self.bodies = self._capture() if self.X.is_cuda else (self._init, self._step)
            init, step = self.bodies
            stop2 = torch.tensor(rtol * rtol, dtype=self.dt).item()  # rounded like the dots (host)
            init()
            k = 0
            while k < maxiter and host_read(_vdot(self.R, self.R, self.dt)) > stop2:
                for _ in range(max(1, int(unroll))):
                    step()
                    k += 1
            count("pcg.iterations", k)
        return self.X, k


def _replay(graph, counts: dict) -> Callable:
    """Replays ``graph`` and counts it, with the counts made while capturing it."""

    def replay():
        graph.replay()
        count("pcg.graph.replays")
        for name, n in counts.items():
            count(name, n)

    return replay


def stencil_pcg(A: StencilBlockEll, B: torch.Tensor, M: Callable,
                rtol: float = 1e-5, maxiter: int = 150, unroll: int = 4,
                dot_dtype: Optional[torch.dtype] = None,
                vec_dtype: Optional[torch.dtype] = None):
    """PCG in SoA layout; returns (X, iterations).  The rhs is assumed
    pre-scaled to ||B|| = 1 so the recurrence residual is relative.  The
    matvec and the preconditioner run in B's dtype; ``vec_dtype`` (default
    B's) is the dtype of the Krylov vectors X, R, Z, P and their updates, and
    ``dot_dtype`` (default B's) that of the three inner products.

    Convergence is checked (one host sync) before every block of ``unroll``
    iterations, so the count is a multiple of ``unroll`` and may pass
    ``maxiter`` by less than ``unroll``.  One `_Pcg` loop runs it: replayed
    as CUDA graphs on CUDA tensors, op by op on the CPU, to the same
    iterates.  Runs in a ``pcg`` span (op by op, each application of M in a
    ``precond.apply`` span and of A in a ``matvec`` span); counts its
    iterations in ``pcg.iterations``."""
    adt = B.dtype
    return _Pcg(A, M, B.shape, adt, vec_dtype or adt, dot_dtype or adt,
                B.device).pcg(rtol, maxiter, unroll, B)


def stencil_refined_solve(A: StencilBlockEll, B: torch.Tensor, M: Callable,
                          tol: float = 1e-6, inner_iters: int = 150,
                          inner_rtol: float = 1e-5, outer_max: int = 6,
                          unroll: int = 4, dot_dtype: Optional[torch.dtype] = None,
                          vec_dtype: Optional[torch.dtype] = None):
    """float32 deflated PCG inside float64 iterative refinement.  Returns
    (X float64, true relative residual, total inner iterations, outer
    sweeps).  Each sweep solves for the correction of the exact float64
    residual, which is recomputed with the float64 SpMV (of the symmetric
    operator when A is symmetric), in a ``refine.residual`` span.
    ``dot_dtype``/``vec_dtype`` are :func:`stencil_pcg`'s.  Every sweep runs
    the one `_Pcg` loop of the solve with its scaled residual loaded into the
    loop's R: on CUDA the graphs captured in the first sweep are replayed."""
    A64 = A.astype(torch.float64)
    B64 = B.to(torch.float64)
    bnorm = host_read(torch.linalg.norm(B64))
    target = tol * max(bnorm, 1e-300)
    X = torch.zeros_like(B64)
    R64 = B64
    rnorm = bnorm
    sweeps = iters = 0
    f32 = torch.float32
    loop = _Pcg(A, M, B.shape, f32, vec_dtype or f32, dot_dtype or f32, B.device)
    while rnorm > target and sweeps < outer_max:
        scale = rnorm
        loop.R.copy_((R64 / scale).to(f32))
        dX, ki = loop.pcg(inner_rtol, inner_iters, unroll)
        X = X + dX.to(torch.float64) * scale
        with span("refine.residual", device=True):
            with span("matvec"):
                AX = A64.matvec(X)
            R64 = B64 - AX
            rnorm = host_read(torch.linalg.norm(R64))
        sweeps += 1
        iters += ki
    return X, rnorm / max(bnorm, 1e-300), iters, sweeps
