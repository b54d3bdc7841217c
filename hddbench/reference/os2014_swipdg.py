"""The reference system of the OS2014 parametric test case: P1 SWIPDG of

    -div(lambda(x; mu) grad u) = f  on [-1, 1]^2,   u = 0 on the boundary,
    lambda(x; mu) = 1 + 0.75 (1 - mu) sin(4 pi (x0 + x1 / 2)),
    f(x) = (pi^2 / 2) cos(pi x0 / 2) cos(pi x1 / 2),

on the bisected 4 x 4 criss grid (``swipdg_p1.criss_grid``), in float64.

Written from the discretization's definition (``swipdg_p1``'s module
docstring), with the diffusion evaluated at the quadrature points rather
than per cell, and assembled from lambda(mu) itself, not as a sum of
per-component operators:

* volume: int_K lambda grad phi_j . grad phi_i;
* interior face e with sides (-, +), n from - to +: the one-sided values
  delta-, delta+ of lambda at each point give the weights
  w- = delta+ / (delta- + delta+), w+ = delta- / (delta- + delta+) and
  gamma = delta- delta+ / (delta- + delta+), the penalty 8 gamma / |e| and
  the flux {lambda grad u . n}_w = w- lambda- grad u- . n + w+ lambda+ grad u+ . n;
* Dirichlet face: penalty 14 delta / |e| and the one-sided flux;
* rhs: int_K f phi_i (the Dirichlet data are 0).

A one-sided value is lambda read at the face point moved 1e-7 of the way
towards the side's cell centroid: the trace convention of the discretization
under test, which reads coefficients that jump at a face this way.  For this
continuous lambda the two sides differ by ~1e-9 relative; the exact trace
would put that into ``op_rel``.

Quadrature (the rules the discretization's orders select: lambda and f are
of order 3, so order 5 on cells and 6 on faces):

* cells: the conical product rule of degree 5 (dune-geometry's
  SimplexQuadratureRule): 3 Gauss-Jacobi points with weight 1 - x in the
  first reference coordinate x (Abramowitz & Stegun, Table 25.8, the
  3-point rule for int_0^1 x g(x) dx, mirrored x -> 1 - x), 3 Gauss-Legendre
  points in the second, scaled by 1 - x; reference point (x, y) maps to
  v0 + x (v1 - v0) + y (v2 - v0) in the cell's vertex order;
* faces: 4-point Gauss-Legendre (Abramowitz & Stegun, Table 25.4).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .swipdg_p1 import (SIGMA_BOUNDARY, SIGMA_INNER, Operator, _barycentric, _gradients,
                        criss_grid)

__all__ = ["Reference", "diffusion", "force", "cell_rule", "face_rule"]

SIDE_SHIFT = 1e-7


# Gauss-Legendre moved from [-1, 1] to [0, 1]: 3 points (degree 5), 4 points (degree 7)
_R3 = math.sqrt(0.6)
GL3 = (0.5 + 0.5 * np.array([-_R3, 0.0, _R3]), np.array([5.0, 8.0, 5.0]) / 18.0)
_R4 = (math.sqrt(3.0 / 7.0 - 2.0 / 7.0 * math.sqrt(1.2)),
       math.sqrt(3.0 / 7.0 + 2.0 / 7.0 * math.sqrt(1.2)))
_W4 = ((18.0 + math.sqrt(30.0)) / 72.0, (18.0 - math.sqrt(30.0)) / 72.0)
GL4 = (0.5 + 0.5 * np.array([-_R4[1], -_R4[0], _R4[0], _R4[1]]),
       np.array([_W4[1], _W4[0], _W4[0], _W4[1]]))
# Gauss-Jacobi on [0, 1] with weight 1 - x, 3 points (degree 5)
GJ3 = (np.array([0.08858795951270394739555, 0.4094668644407347108649,
                 0.7876594617608470560252]),
       np.array([0.2009319137389596307722, 0.2292411063595862466939,
                 0.06982697990145412253388]))


def cell_rule():
    """(points [9, 2], weights [9]) on the reference triangle (weights sum to 1/2)."""
    (xj, wj), (yl, wl) = GJ3, GL3
    X = np.repeat(xj, len(yl))
    Y = np.tile(yl, len(xj)) * (1.0 - X)
    return np.stack([X, Y], axis=-1), np.repeat(wj, len(yl)) * np.tile(wl, len(xj))


def face_rule():
    """(points [4], weights [4]) on [0, 1]."""
    return GL4


def diffusion(x: torch.Tensor, mu: float) -> torch.Tensor:
    return 1.0 + 0.75 * (1.0 - mu) * torch.sin(4.0 * math.pi * (x[..., 0] + 0.5 * x[..., 1]))


def force(x: torch.Tensor) -> torch.Tensor:
    p = 0.5 * math.pi
    return (p * math.pi) * torch.cos(p * x[..., 0]) * torch.cos(p * x[..., 1])


def _faces(cells: np.ndarray, nv: int):
    """Local faces (cell * 3 + l, edge l from vertex l to l + 1) paired
    across the interior: (first sides, second sides, boundary faces)."""
    local = np.stack([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=1)
    key = (np.minimum(local[..., 0], local[..., 1]) * nv
           + np.maximum(local[..., 0], local[..., 1])).reshape(-1)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    pair = np.nonzero(sk[1:] == sk[:-1])[0]
    first, second = order[pair], order[pair + 1]
    paired = np.zeros(len(key), dtype=bool)
    paired[first] = paired[second] = True
    return first, second, np.nonzero(~paired)[0]


class Reference:
    """``system(mu)`` -> the assembled float64 system at ``mu`` (a float or
    a length-1 array).  What does not depend on mu (grid, quadrature points,
    basis values) is computed once."""

    def __init__(self, config: dict, device):
        lo, up = config["domain"]
        grid = criss_grid(lo, up, config["cubes"], int(config["bisections"]))
        f64 = dict(dtype=torch.float64, device=device)
        P = torch.as_tensor(grid.vertices[grid.cells], **f64)  # [NC, 3, 2]
        G = _gradients(P)
        e1, e2 = P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]
        det = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
        centroid = P.mean(dim=1)
        self.stiff = torch.einsum("cia,cja->cij", G, G)

        ref, w = (torch.as_tensor(a, **f64) for a in cell_rule())
        self.cell_x = (P[:, None, 0] + ref[None, :, 0:1] * e1[:, None]
                       + ref[None, :, 1:2] * e2[:, None])
        self.cell_w = w[None, :] * det[:, None]
        phi = torch.stack([1.0 - ref[:, 0] - ref[:, 1], ref[:, 0], ref[:, 1]], dim=-1)  # [Q, 3]
        self.rhs = torch.einsum("cq,cq,qi->ci", self.cell_w, force(self.cell_x), phi).reshape(-1)

        t, tw = (torch.as_tensor(a, **f64) for a in face_rule())
        first, second, single = _faces(grid.cells, len(grid.vertices))

        def side(entries: np.ndarray):
            """Cell, length, unit normal away from the cell, the face's
            quadrature points and weights."""
            c, l = np.divmod(entries, 3)
            c_t = torch.as_tensor(c, device=device)
            p0 = P[c_t, torch.as_tensor(l, device=device)]
            p1 = P[c_t, torch.as_tensor((l + 1) % 3, device=device)]
            d = p1 - p0
            h = torch.linalg.norm(d, dim=-1)
            n = torch.stack([d[:, 1], -d[:, 0]], dim=-1) / h[:, None]
            flip = torch.sign(((0.5 * (p0 + p1) - centroid[c_t]) * n).sum(-1))
            n = n * torch.where(flip == 0, torch.ones_like(flip), flip)[:, None]
            x = p0[:, None] + t[None, :, None] * d[:, None]
            return c_t, h, n, x, tw[None, :] * h[:, None]

        def one_sided(c, x):
            return x + SIDE_SHIFT * (centroid[c][:, None] - x)

        self.cm, self.h, n, x, self.qw = side(first)
        self.cp = torch.as_tensor(second // 3, device=device)
        self.x_sides = torch.stack([one_sided(self.cm, x), one_sided(self.cp, x)], dim=1)
        self.phi = torch.stack([_barycentric(P[self.cm], x), _barycentric(P[self.cp], x)],
                               dim=1)  # [F, 2, Q, 3]
        self.gn = torch.stack([torch.einsum("fia,fa->fi", G[self.cm], n),
                               torch.einsum("fia,fa->fi", G[self.cp], n)], dim=1)  # [F, 2, 3]
        self.cb, self.hb, nb, xb, self.qwb = side(single)
        self.xb = one_sided(self.cb, xb)
        self.phib = _barycentric(P[self.cb], xb)  # [Fb, Q, 3]
        self.gnb = torch.einsum("fia,fa->fi", G[self.cb], nb)

    def system(self, mu) -> Operator:
        mu = float(np.asarray(mu, dtype=np.float64).reshape(-1)[0])
        vol = torch.einsum("cq,cq->c", self.cell_w, diffusion(self.cell_x, mu))[:, None, None] \
            * self.stiff

        delta = diffusion(self.x_sides, mu)                   # [F, 2, Q]: delta-, delta+
        dm, dp = delta[:, 0], delta[:, 1]
        den = dm + dp
        w = torch.stack([dp / den, dm / den], dim=1)          # [F, 2, Q]
        gamma = dm * dp / den                                 # [F, Q]
        pen = SIGMA_INNER * gamma / self.h[:, None]           # [F, Q]
        flux = (w * delta)[..., None] * self.gn[:, :, None, :]  # [F, 2, Q, 3]
        sign = torch.tensor([1.0, -1.0], dtype=delta.dtype, device=delta.device)
        ss = sign[:, None] * sign[None, :]
        qw, phi = self.qw, self.phi
        inner = (torch.einsum("fq,st,fsqi,ftqj->fstij", qw * pen, ss, phi, phi)
                 - torch.einsum("fq,s,fsqi,ftqj->fstij", qw, sign, phi, flux)
                 - torch.einsum("fq,t,fsqi,ftqj->fstij", qw, sign, flux, phi))

        db = diffusion(self.xb, mu)                           # [Fb, Q]
        pen_b = SIGMA_BOUNDARY * db / self.hb[:, None]
        flux_b = db[..., None] * self.gnb[:, None, :]         # [Fb, Q, 3]
        bnd = (torch.einsum("fq,fqi,fqj->fij", self.qwb * pen_b, self.phib, self.phib)
               - torch.einsum("fq,fqi,fqj->fij", self.qwb, self.phib, flux_b)
               - torch.einsum("fq,fqi,fqj->fij", self.qwb, flux_b, self.phib))
        return Operator(vol, inner, bnd, self.cm, self.cp, self.cb, self.rhs.clone())
