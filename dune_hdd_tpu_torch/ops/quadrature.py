"""Quadrature rules (host numpy).

Counterpart of ``dune_hdd_tpu/ops/quadrature.py``: the dune-geometry
conical-product triangle rule and Gauss-Legendre edge rule.

Reference-element conventions:
* triangle: {(x,y) : x,y >= 0, x+y <= 1}, weights sum to 1/2
* edge: [0,1], weights sum to 1
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["tri_rule", "edge_rule", "gauss_jacobi_10"]


@lru_cache(maxsize=None)
def edge_rule(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0,1], exact for polynomials of degree <= order."""
    n = max(1, (int(order) + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def gauss_jacobi_10(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule with weight (1-x) on [0,1] (Golub-Welsch
    on the monic Jacobi(1,0) recurrence)."""
    n = int(n)
    k = np.arange(n, dtype=float)
    a = -1.0 / ((2 * k + 1) * (2 * k + 3))
    kk = k[1:]
    b = kk * (kk + 1) / (2 * kk + 1) ** 2
    J = np.diag(a) + np.diag(np.sqrt(b), 1) + np.diag(np.sqrt(b), -1)
    t, V = np.linalg.eigh(J)
    mu0 = 2.0  # int_{-1}^{1} (1-t) dt
    w_t = mu0 * V[0, :] ** 2
    # map [-1,1] -> [0,1] with weight (1-x): factor 1/4 (dx and (1-x) halve)
    return 0.5 * (t + 1.0), 0.25 * w_t


@lru_cache(maxsize=None)
def tri_rule(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """dune-geometry SimplexQuadratureRule<ct,2>: conical product with
    n = order//2 + 1 points per direction, Gauss-Jacobi(1,0) in x and
    Gauss-Legendre in y.  Exact for total degree <= 2n-1 >= order."""
    n = max(0, int(order)) // 2 + 1
    xj, wj = gauss_jacobi_10(n)
    yl, wl = np.polynomial.legendre.leggauss(n)
    yl = 0.5 * (yl + 1.0)
    wl = 0.5 * wl
    X = np.repeat(xj, n)
    Y = np.tile(yl, n) * (1.0 - X)
    W = np.repeat(wj, n) * np.tile(wl, n)
    return np.stack([X, Y], axis=-1), W
