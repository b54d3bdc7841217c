"""Aggregation multigrid in the plane layout.

Counterpart of ``dune_hdd_tpu/la/stencil_multigrid.py``: a V(1,1) cycle
whose operators are rolls and elementwise products and whose transfers are
reshape-sums (restriction) and broadcasts (prolongation).

  level 0   the block system in planes [nd, 8, KY, KX] (``plane_spmv``)
  level 1   its piecewise-constant aggregation to the scalar cell lattice
            [KY, KX]: 9-point stencil bands (``la/stencil._stencil_bands``)
  level l+1 2 x 2 re-aggregation of level l's bands
  coarsest  dense inverse (BCR or LU with Newton-Schulz polish)

With damped Jacobi smoothing and restriction = prolongation^T the cycle is
a fixed symmetric operator, usable as the PCG preconditioner.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .stencil import (
    StencilBlockEll,
    _aggregate_bands,
    _aggregation2d,
    _band_matvec,
    _bands_to_dense,
    _coarse_inverse,
    _coarse_inverse_bcr,
    _stencil_bands,
    jacobi_smoother,
)

__all__ = ["stencil_multigrid_preconditioner"]


def _damped_jacobi_bands(bands: dict, omega: float) -> Callable:
    d = bands[(0, 0)]
    # a tensor numerator: a Python scalar over a tensor is a reciprocal and a
    # product, two roundings
    dinv = torch.where(d != 0,
                       torch.full_like(d, omega) / torch.where(d != 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))
    return lambda r: dinv * r


def _restrict2(x: torch.Tensor) -> torch.Tensor:
    my, mx = x.shape
    return x.reshape(my // 2, 2, mx // 2, 2).sum(dim=(1, 3))


def _prolong2(xc: torch.Tensor) -> torch.Tensor:
    my2, mx2 = xc.shape
    return xc[:, None, :, None].expand(my2, 2, mx2, 2).reshape(my2 * 2, mx2 * 2)


def stencil_multigrid_preconditioner(S: StencilBlockEll, coarsest_max: int = 4096,
                                     omega: float = 0.7, newton_schulz: int = 2,
                                     smoother: Optional[Callable] = None) -> Callable:
    """Symmetric V(1,1)-cycle preconditioner for the plane-layout system:
    the top level smoothed by ``smoother`` (default: block Jacobi damped by
    ``omega``), the band levels by damped point Jacobi, halving both axes
    while they stay even and the lattice exceeds ``coarsest_max`` cells."""
    KY, KX = S.lattice
    agg = _aggregation2d(S, (KX, KY))  # factor (1, 1): planes -> cell lattice
    levels = [(_stencil_bands(S, agg), KY, KX)]
    my, mx = KY, KX
    while my * mx > coarsest_max and my % 2 == 0 and mx % 2 == 0:
        levels.append((_aggregate_bands(levels[-1][0], my, mx, 2, 2), my // 2, mx // 2))
        my, mx = my // 2, mx // 2

    bands_c, my_c, mx_c = levels[-1]
    E_c = _bands_to_dense(bands_c, my_c, mx_c)
    if mx_c >= 2 and all(abs(vx) <= 1 for (_vy, vx) in bands_c):
        coarse = _coarse_inverse_bcr(E_c, mx_c, my_c, newton_schulz)
    else:
        coarse = _coarse_inverse(E_c, newton_schulz)

    def coarse_solve(r):  # [my_c, mx_c] -> [my_c, mx_c]; the solve's order is x-major
        return coarse(r.t().reshape(-1)).reshape(mx_c, my_c).t()

    mats = [_band_matvec(b) for b, _, _ in levels]
    smooths = [_damped_jacobi_bands(b, omega) for b, _, _ in levels]

    def band_vcycle(lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == len(levels) - 1:
            return coarse_solve(r)
        x = smooths[lvl](r)
        x = x + _prolong2(band_vcycle(lvl + 1, _restrict2(r - mats[lvl](x))))
        return x + smooths[lvl](r - mats[lvl](x))

    if smoother is None:
        bj = jacobi_smoother(S)
        smoother = lambda r: omega * bj(r)  # noqa: E731 - damped

    def apply(R: torch.Tensor) -> torch.Tensor:  # [nd, 8, KY, KX]
        x = smoother(R)
        xc = band_vcycle(0, agg.aggsum(R - S.matvec(x)))
        x = x + agg.broadcast(xc)[None]
        return x + smoother(R - S.matvec(x))

    return apply
