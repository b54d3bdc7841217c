"""Two-level (deflation) preconditioning for high-contrast SPD systems in
block-ELL layout.

Counterpart of ``dune_hdd_tpu/la/deflation.py``.  The SPE10 permeability is
piecewise constant on the 100 x 20 macro grid, so one piecewise-constant
coarse vector per macro cell (aggregate) captures the near-kernel of the
Jacobi-preconditioned operator.  The balancing preconditioner

    M^-1 = Q + (I - Q A)^T M_J^-1 (I - A Q),   Q = Z E^-1 Z^T,  E = Z^T A Z,

is SPD, so it runs inside CG.  Two forms: ``deflation_preconditioner`` on a
general ``BlockEllMatrix`` (aggregate sums as ``index_add_``, the
A-projections through precomputed A Z rows), and
``structured_deflation_preconditioner`` on a ``StructuredBlockEll``, where
the aggregation is a reshape-sum and every fine matvec is the hand-written
``structured_spmv``.  ``refined_deflated_solve`` wraps float32 deflated PCG
in float64 iterative refinement.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .block_ell import BlockEllMatrix, block_jacobi_preconditioner
from .stencil import _dot, _newton_schulz

__all__ = [
    "aggregate_map_from_points",
    "coarse_operator",
    "deflation_preconditioner",
    "refined_deflated_solve",
    "structured_aggregation",
    "structured_deflation_preconditioner",
]


def structured_aggregation(order, macro_shape):
    """(aggsum, broadcast, cell_agg_new) for a StructuredOrder whose
    subclass lattices the (mx, my) macro grid tiles: Z^T r and Z yc are a
    reshape-sum and a broadcast of the flat cell-major vector.  Aggregate
    ids follow ``aggregate_map_from_points``: agg = ix_macro * my + iy_macro.
    None if the macro grid does not tile the lattice."""
    plan = order.aggregate_plan(macro_shape)
    if plan is None:
        return None
    fy, fx = plan
    mx, my = int(macro_shape[0]), int(macro_shape[1])
    ky, kx = order.lattice
    nc = order.num_cells

    def aggsum(r, nd):
        # [8, MY, fy, MX, fx, nd] -> [MY, MX] -> aggregate order (MX-major)
        return r.reshape(8, my, fy, mx, fx, nd).sum(dim=(0, 2, 4, 5)).t().reshape(-1)

    def broadcast(yc, nd):
        g = yc.reshape(mx, my).t()  # [MY, MX]
        return g[None, :, None, :, None, None].expand(8, my, fy, mx, fx, nd).reshape(nc * nd)

    # aggregate id per structured cell id (for the coarse operator build)
    iy = np.repeat(np.arange(ky), kx)
    ix = np.tile(np.arange(kx), ky)
    cell_agg_new = np.tile((ix // fx) * my + (iy // fy), 8)
    return aggsum, broadcast, cell_agg_new


def aggregate_map_from_points(points: np.ndarray, lower, upper, shape) -> np.ndarray:
    """Aggregate id per point by binning into a structured (nx, ny) box grid
    over [lower, upper]: for SPE10 the 100 x 20 macro-permeability grid, so
    aggregates align with the coefficient."""
    lower = np.asarray(lower, dtype=float)
    upper = np.asarray(upper, dtype=float)
    shape = np.asarray(shape, dtype=int)
    rel = (points - lower) / (upper - lower)
    ij = np.clip(np.floor(rel * shape).astype(np.int64), 0, shape - 1)
    return ij[:, 0] * shape[1] + ij[:, 1]


def _dof_aggregates(matrix: BlockEllMatrix, cell_agg: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(cell_agg, dtype=np.int64), matrix.nd)


def coarse_operator(matrix, cell_agg: np.ndarray, n_agg: int) -> torch.Tensor:
    """E = Z^T A Z for the piecewise-constant basis Z[i, a] = 1{agg(i) = a}:
    each (cell, slot) block's sum added at (agg(cell), agg(neighbour)), by
    the sorting accumulate, so E (and the preconditioner) is the same in
    every build (``index_add_``'s atomics on the card are not)."""
    cell_agg = np.asarray(cell_agg, dtype=np.int64)
    rows = np.repeat(cell_agg[:, None], matrix.neighbors.shape[1], axis=1)
    cols = cell_agg[np.asarray(matrix.neighbors, dtype=np.int64)]
    dev = matrix.blocks.device
    flat = torch.as_tensor((rows * n_agg + cols).reshape(-1)).to(dev)
    sums = matrix.blocks.sum(dim=(-2, -1)).reshape(-1)  # [NC * B]
    E = torch.zeros(n_agg * n_agg, dtype=matrix.blocks.dtype, device=dev)
    return E.index_put_((flat,), sums, accumulate=True).reshape(n_agg, n_agg)


def _coarse_inverse(E: torch.Tensor, coarse_dtype: Optional[torch.dtype]) -> Callable:
    """Solve with the dense symmetrized inverse of the diagonally scaled
    coarse operator: float32 LU, two Newton-Schulz polish steps; the
    scaling and the apply in ``coarse_dtype`` (default E's)."""
    cdt = coarse_dtype or E.dtype
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30)).to(cdt)
    Es = ((E.to(cdt) / d[:, None]) / d[None, :]).to(torch.float32)
    Einv = _newton_schulz(Es, torch.linalg.inv(Es), 2).to(cdt)

    def coarse_solve(rc):
        return ((Einv @ (rc.to(cdt) / d)) / d).to(rc.dtype)

    return coarse_solve


def deflation_preconditioner(matrix: BlockEllMatrix, cell_agg: np.ndarray, n_agg: int,
                             smoother: Optional[Callable] = None,
                             coarse_dtype: Optional[torch.dtype] = None) -> Callable:
    """M^-1 r = Q r + (I - Q A) M_J^-1 (I - A Q) r on a general block-ELL
    matrix, M_J the ``smoother`` (block Jacobi by default).  A Z is kept as
    row sums [NC, B, nd] with the neighbours' aggregate ids, so A (Q r) and
    Z^T A s = (A Z)^T s (A symmetric) cost gathers and aggregate sums over an
    array 1/nd the size of the operator, not two fine matvecs.
    ``coarse_dtype``: the dtype of the coarse scaling and apply."""
    if smoother is None:
        smoother = block_jacobi_preconditioner(matrix)
    dev = matrix.blocks.device
    dof_agg = torch.as_tensor(_dof_aggregates(matrix, cell_agg)).to(dev)
    coarse_solve = _coarse_inverse(coarse_operator(matrix, cell_agg, n_agg), coarse_dtype)
    AZ = matrix.blocks.sum(dim=-1)  # [NC, B, nd]
    agg_nb = torch.as_tensor(np.asarray(cell_agg, dtype=np.int64)[
        np.asarray(matrix.neighbors, dtype=np.int64)]).to(dev)  # [NC, B]
    nd = matrix.nd

    def segment_sum(v, ids):
        return v.new_zeros(n_agg).index_add_(0, ids, v)

    def apply(r):
        yc = coarse_solve(segment_sum(r, dof_agg))
        aqr = (AZ * yc[agg_nb][:, :, None]).sum(dim=1).reshape(-1)  # A Q r
        s = smoother(r - aqr)
        zas = segment_sum((AZ * s.reshape(-1, 1, nd)).sum(dim=-1).reshape(-1),
                          agg_nb.reshape(-1))  # Z^T A s
        return yc[dof_agg] + s - coarse_solve(zas)[dof_agg]

    return apply


def structured_deflation_preconditioner(matrix, order, macro_shape,
                                        smoother: Optional[Callable] = None,
                                        coarse_dtype: Optional[torch.dtype] = None,
                                        variant: str = "balanced") -> Callable:
    """The two-level preconditioner on a StructuredBlockEll with regular
    per-iteration work only: aggregate reshape-sums, broadcasts and the
    structured SpMV.  variant="balanced": M^-1 r = Qr + (I - QA) M_J^-1
    (I - AQ) r with the A-projections as matvecs of the broadcast coarse
    fields (Z^T A s = Z^T (A s), A symmetric); variant="additive":
    M^-1 = M_J^-1 + Q.  Raises ValueError if the macro grid does not tile
    the structured lattice."""
    agg = structured_aggregation(order, macro_shape)
    if agg is None:
        raise ValueError(f"macro {tuple(macro_shape)} does not tile the structured "
                         f"lattice {order.lattice}")
    if variant not in ("balanced", "additive"):
        raise ValueError(f"variant must be 'balanced' or 'additive', got {variant!r}")
    aggsum, broadcast, cell_agg_new = agg
    n_agg = int(macro_shape[0]) * int(macro_shape[1])
    if smoother is None:
        smoother = block_jacobi_preconditioner(matrix)
    nd = matrix.nd
    coarse_solve = _coarse_inverse(coarse_operator(matrix, cell_agg_new, n_agg), coarse_dtype)

    def Q(r):
        return broadcast(coarse_solve(aggsum(r, nd)), nd)

    if variant == "additive":
        return lambda r: smoother(r) + Q(r)

    def apply_balanced(r):
        qr = Q(r)
        s = smoother(r - matrix.matvec(qr))
        return qr + s - Q(matrix.matvec(s))

    return apply_balanced


def refined_deflated_solve(matrix, b: torch.Tensor, cell_agg: Optional[np.ndarray], n_agg: int,
                           tol: float = 1e-6, inner_iters: int = 150, outer_max: int = 6,
                           coarse_dtype: Optional[torch.dtype] = None, inner_rtol: float = 1e-5,
                           M: Optional[Callable] = None, unroll: int = 1):
    """Solve the float32 system (A, b) to a true float64 relative residual
    <= tol: float32 deflated PCG (``M``, default ``deflation_preconditioner``
    on ``cell_agg`` with a float64 coarse apply) on the residual equation of
    float64 iterative refinement, whose residual b - A x is recomputed each
    sweep with the float64 copy of A's blocks (the block-ELL gather SpMV;
    A's float32 values are exact in float64).  Each inner solve starts from
    the rhs scaled to norm 1 and stops at ``inner_rtol`` or ``inner_iters``;
    its stop test is read on the host before every block of ``unroll``
    iterations, so its count is a multiple of ``unroll``.  Returns (x
    float64, true relative residual, total inner iterations, sweeps)."""
    if M is None:
        M = deflation_preconditioner(matrix, cell_agg, n_agg,
                                     coarse_dtype=coarse_dtype or torch.float64)
    A64 = BlockEllMatrix(matrix.neighbors, matrix.blocks.to(torch.float64))
    b64 = b.to(torch.float64)
    bnorm = torch.linalg.norm(b64).item()
    target = tol * max(bnorm, 1e-300)
    stop2 = torch.tensor(inner_rtol ** 2, dtype=torch.float32).item()

    def inner(r32):
        x = torch.zeros_like(r32)
        r = r32
        z = M(r)
        p = z
        rz = _dot(r, z)
        k = 0
        while k < inner_iters and _dot(r, r).item() > stop2:
            for _ in range(max(1, int(unroll))):
                ap = matrix.matvec(p)
                pap = _dot(p, ap)
                # 0/0 guards: unrolled steps may run past exact convergence
                ok = pap > 0
                alpha = torch.where(ok, rz / torch.where(ok, pap, torch.ones_like(pap)),
                                    torch.zeros_like(pap))
                x = x + alpha * p
                r = r - alpha * ap
                z = M(r)
                rz_new = _dot(r, z)
                ok = rz > 0
                beta = torch.where(ok, rz_new / torch.where(ok, rz, torch.ones_like(rz)),
                                   torch.zeros_like(rz))
                p = z + beta * p
                rz = rz_new
                k += 1
        return x, k

    x = torch.zeros_like(b64)
    r64, rnorm = b64, bnorm
    sweeps = iters = 0
    while rnorm > target and sweeps < outer_max:
        dx, ki = inner((r64 / rnorm).to(torch.float32))
        x = x + dx.to(torch.float64) * rnorm
        r64 = b64 - A64.matvec(x)
        rnorm = torch.linalg.norm(r64).item()
        sweeps += 1
        iters += ki
    return x, rnorm / max(bnorm, 1e-300), iters, sweeps
