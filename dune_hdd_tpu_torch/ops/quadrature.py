"""Quadrature rules (host numpy).

Counterpart of ``dune_hdd_tpu/ops/quadrature.py``: the dune-geometry
conical-product triangle rule (and the Dunavant / Duffy family), the
tensor-Gauss quad rule and the Gauss-Legendre edge rule.

Reference-element conventions:
* triangle: {(x,y) : x,y >= 0, x+y <= 1}, weights sum to 1/2
* quad: [0,1]^2, weights sum to 1
* edge: [0,1], weights sum to 1
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

__all__ = ["tri_rule", "quad_rule", "edge_rule", "gauss_jacobi_10"]


@lru_cache(maxsize=None)
def edge_rule(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0,1], exact for polynomials of degree <= order."""
    n = max(1, (int(order) + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def quad_rule(order: int) -> Tuple[np.ndarray, np.ndarray]:
    x, w = edge_rule(order)
    X, Y = np.meshgrid(x, x, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    return pts, np.outer(w, w).ravel()


_DUNAVANT = {
    1: [(1 / 3, 1 / 3, 1.0)],
    2: [(1 / 6, 1 / 6, 1 / 3), (2 / 3, 1 / 6, 1 / 3), (1 / 6, 2 / 3, 1 / 3)],
    3: [(1 / 3, 1 / 3, -27 / 48), (0.6, 0.2, 25 / 48), (0.2, 0.6, 25 / 48),
        (0.2, 0.2, 25 / 48)],
}


def _dunavant_orbits(centre, orbits):
    pts = [] if centre is None else [centre]
    for c, w in orbits:
        pts += [(c, c, w), (1 - 2 * c, c, w), (c, 1 - 2 * c, w)]
    return pts


_DUNAVANT[4] = _dunavant_orbits(None, ((0.445948490915965, 0.223381589678011),
                                       (0.091576213509771, 0.109951743655322)))
_DUNAVANT[5] = _dunavant_orbits((1 / 3, 1 / 3, 0.225),
                                ((0.470142064105115, 0.132394152788506),
                                 (0.101286507323456, 0.125939180544827)))


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
def tri_rule(order: int, family: str = "dune") -> Tuple[np.ndarray, np.ndarray]:
    """``family="dune"``: dune-geometry SimplexQuadratureRule<ct,2>, a conical
    product with n = order//2 + 1 points per direction, Gauss-Jacobi(1,0) in
    x and Gauss-Legendre in y, exact for total degree <= 2n-1 >= order.
    Any other family: Dunavant up to order 5, a Duffy-collapsed tensor Gauss
    rule above."""
    order = max(0, int(order))
    if family != "dune":
        order = max(1, order)
        if order in _DUNAVANT:
            data = np.asarray(_DUNAVANT[order], dtype=float)
            return data[:, :2].copy(), 0.5 * data[:, 2].copy()
        n = (order + 4) // 2
        x, w = np.polynomial.legendre.leggauss(n)
        x, w = 0.5 * (x + 1.0), 0.5 * w
        U, V = np.meshgrid(x, x, indexing="ij")
        pts = np.stack([U.ravel(), (V * (1.0 - U)).ravel()], axis=-1)
        return pts, (np.outer(w, w) * (1.0 - U)).ravel()
    n = order // 2 + 1
    xj, wj = gauss_jacobi_10(n)
    yl, wl = np.polynomial.legendre.leggauss(n)
    yl = 0.5 * (yl + 1.0)
    wl = 0.5 * wl
    X = np.repeat(xj, n)
    Y = np.tile(yl, n) * (1.0 - X)
    W = np.repeat(wj, n) * np.tile(wl, n)
    return np.stack([X, Y], axis=-1), W
