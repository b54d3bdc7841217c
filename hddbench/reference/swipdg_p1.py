"""Plain PyTorch reference of the P1 SWIPDG system on a bisected criss grid.

The yardstick of the benchmark's check: written from the discretization's
definition, independent of the program under test, and run in float64.

* Grid: the criss triangulation of a rectangle (each square split along its
  (0,0)-(1,1) diagonal, the diagonal as refinement edge, the lower triangle
  first), then uniform newest-vertex bisection: a cell (a, b, c) with
  refinement edge (a, b) and midpoint m has the children (c, a, m) and
  (b, c, m), in this order.  This is ALUGrid's conforming refinement of
  the reference's cube grids; the cells keep this order and each cell its
  vertex order, so a P1 DG vector is read as [cell, vertex] nodal values.
* Discretization (symmetric weighted interior penalty, Ern/Stephansen/
  Zunino), for a diffusion tau and a weighting diffusion delta, both
  constant per cell:

      a(u, v) = sum_K int_K tau grad u . grad v
              - sum_e int_e {tau grad u . n}_w [v] + {tau grad v . n}_w [u]
              + sum_e int_e sigma_e [u][v],

  on an interior face with sides (-, +) and n from - to +:
  [u] = u- - u+, {q}_w = w- q- + w+ q+ with w- = delta+ / (delta- + delta+),
  w+ = delta- / (delta- + delta+), sigma_e = 8 gamma / |e| with
  gamma = delta- delta+ / (delta- + delta+); on a Dirichlet face (u = 0)
  the one-sided form with sigma_e = 14 delta- / |e|.  The penalty factors
  8 and 14 are dune-gdt's SIPDG factors for polynomial order 1.
* Right-hand side: int_K f phi_i for a force f constant per cell.

Face integrals use two-point Gauss quadrature, exact for the products of
two linear functions.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Grid", "criss_grid", "Geometry", "geometry", "Operator", "assemble",
           "cell_centroids"]

SIGMA_INNER = 8.0
SIGMA_BOUNDARY = 14.0


class Grid(NamedTuple):
    vertices: np.ndarray  # [NV, 2] float64
    cells: np.ndarray     # [NC, 3] int64 vertex ids


def criss_grid(lower, upper, num_elements, bisections: int) -> Grid:
    """The criss grid of the rectangle [lower, upper] with ``num_elements``
    (nx, ny) squares, bisected ``bisections`` times (module docstring)."""
    nx, ny = (int(n) for n in num_elements)
    xs = np.linspace(float(lower[0]), float(upper[0]), nx + 1)
    ys = np.linspace(float(lower[1]), float(upper[1]), ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)
    j, i = np.divmod(np.arange(nx * ny, dtype=np.int64), nx)
    v00 = j * (nx + 1) + i
    v10, v01 = v00 + 1, v00 + nx + 1
    v11 = v01 + 1
    cells = np.stack([np.stack([v00, v11, v10], -1), np.stack([v00, v11, v01], -1)],
                     axis=1).reshape(-1, 3)
    for _ in range(int(bisections)):
        nv = len(vertices)
        a, b, c = cells[:, 0], cells[:, 1], cells[:, 2]
        key = np.minimum(a, b) * nv + np.maximum(a, b)
        edges, inverse = np.unique(key, return_inverse=True)
        lo, hi = np.divmod(edges, nv)
        vertices = np.concatenate([vertices, 0.5 * (vertices[lo] + vertices[hi])])
        m = nv + inverse.reshape(-1)
        cells = np.stack([np.stack([c, a, m], -1), np.stack([b, c, m], -1)],
                         axis=1).reshape(-1, 3)
    return Grid(vertices, cells)


def cell_centroids(grid: Grid) -> np.ndarray:
    return grid.vertices[grid.cells].mean(axis=1)


class Geometry(NamedTuple):
    """What the system needs of the grid, on the device, in float64."""

    area: torch.Tensor    # [NC]
    stiff: torch.Tensor   # [NC, 3, 3] grad phi_i . grad phi_j
    cm: torch.Tensor      # [F] inside cell of each interior face
    cp: torch.Tensor      # [F] outside cell
    h: torch.Tensor       # [F] face length
    mass: torch.Tensor    # [F, 2, 2, 3, 3] int_e phi_s,i phi_t,j (s, t: -, +)
    mean: torch.Tensor    # [F, 2, 3] int_e phi_s,i
    gn: torch.Tensor      # [F, 2, 3] grad phi_s,i . n
    cb: torch.Tensor      # [Fb] cell of each boundary face
    hb: torch.Tensor      # [Fb]
    mass_b: torch.Tensor  # [Fb, 3, 3]
    mean_b: torch.Tensor  # [Fb, 3]
    gn_b: torch.Tensor    # [Fb, 3] (n outward)


def _barycentric(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P [F, 3, 2] triangles, x [F, Q, 2] points -> [F, Q, 3]."""
    e1 = P[:, 1] - P[:, 0]
    e2 = P[:, 2] - P[:, 0]
    det = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])[:, None]
    r = x - P[:, None, 0]
    l1 = (r[..., 0] * e2[:, None, 1] - r[..., 1] * e2[:, None, 0]) / det
    l2 = (e1[:, None, 0] * r[..., 1] - e1[:, None, 1] * r[..., 0]) / det
    return torch.stack([1.0 - l1 - l2, l1, l2], dim=-1)


def _gradients(P: torch.Tensor) -> torch.Tensor:
    """[NC, 3, 2] gradients of the barycentric basis."""
    e1 = P[:, 1] - P[:, 0]
    e2 = P[:, 2] - P[:, 0]
    det = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])[:, None]
    g1 = torch.stack([e2[:, 1], -e2[:, 0]], dim=-1) / det
    g2 = torch.stack([-e1[:, 1], e1[:, 0]], dim=-1) / det
    return torch.stack([-g1 - g2, g1, g2], dim=1)


def geometry(grid: Grid, device) -> Geometry:
    """Cell and face quantities of ``grid`` on ``device``."""
    cells = grid.cells
    nv, nc = len(grid.vertices), len(cells)
    local = np.stack([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=1)
    key = (np.minimum(local[..., 0], local[..., 1]) * nv
           + np.maximum(local[..., 0], local[..., 1])).reshape(-1)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    pair = np.nonzero(sk[1:] == sk[:-1])[0]
    first, second = order[pair], order[pair + 1]
    paired = np.zeros(len(key), dtype=bool)
    paired[first] = paired[second] = True
    single = np.nonzero(~paired)[0]

    f64 = dict(dtype=torch.float64, device=device)
    P = torch.as_tensor(grid.vertices[cells], **f64)  # [NC, 3, 2]
    G = _gradients(P)
    e1, e2 = P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]
    area = 0.5 * (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
    stiff = torch.einsum("cia,cja->cij", G, G)
    centroid = P.mean(dim=1)
    t = torch.tensor([0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0)], **f64)

    def face(entries: np.ndarray):
        """Endpoints, length, unit normal away from the owning cell, and
        the Gauss points of the local faces ``entries`` (cell * 3 + l)."""
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
        return c_t, h, n, x

    cm, h, n, x = face(first)
    cp = torch.as_tensor(second // 3, device=device)
    w = 0.5 * h[:, None]  # both Gauss weights
    phi = torch.stack([_barycentric(P[cm], x), _barycentric(P[cp], x)], dim=1)  # [F,2,Q,3]
    mass = torch.einsum("fq,fsqi,ftqj->fstij", w, phi, phi)
    mean = torch.einsum("fq,fsqi->fsi", w, phi)
    gn = torch.stack([torch.einsum("fia,fa->fi", G[cm], n),
                      torch.einsum("fia,fa->fi", G[cp], n)], dim=1)

    cb, hb, nb, xb = face(single)
    wb = 0.5 * hb[:, None]
    phib = _barycentric(P[cb], xb)
    mass_b = torch.einsum("fq,fqi,fqj->fij", wb, phib, phib)
    mean_b = torch.einsum("fq,fqi->fi", wb, phib)
    gn_b = torch.einsum("fia,fa->fi", G[cb], nb)
    return Geometry(area, stiff, cm, cp, h, mass, mean, gn, cb, hb, mass_b, mean_b, gn_b)


class Operator(NamedTuple):
    """The assembled system: volume, interior-face and boundary-face blocks."""

    vol: torch.Tensor    # [NC, 3, 3]
    inner: torch.Tensor  # [F, 2, 2, 3, 3] (test side, ansatz side)
    bnd: torch.Tensor    # [Fb, 3, 3]
    cm: torch.Tensor
    cp: torch.Tensor
    cb: torch.Tensor
    rhs: torch.Tensor    # [NC * 3]

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """A u for a flat [NC * 3] vector in the operator's dtype."""
        x = u.reshape(-1, 3).to(self.vol.dtype)
        y = torch.einsum("cij,cj->ci", self.vol, x)
        xm, xp = x[self.cm], x[self.cp]
        B = self.inner
        y.index_add_(0, self.cm, torch.einsum("fij,fj->fi", B[:, 0, 0], xm)
                     + torch.einsum("fij,fj->fi", B[:, 0, 1], xp))
        y.index_add_(0, self.cp, torch.einsum("fij,fj->fi", B[:, 1, 0], xm)
                     + torch.einsum("fij,fj->fi", B[:, 1, 1], xp))
        y.index_add_(0, self.cb, torch.einsum("fij,fj->fi", self.bnd, x[self.cb]))
        return y.reshape(-1)

    def diagonal(self) -> torch.Tensor:
        d = torch.diagonal(self.vol, dim1=-2, dim2=-1).clone()
        d.index_add_(0, self.cm, torch.diagonal(self.inner[:, 0, 0], dim1=-2, dim2=-1))
        d.index_add_(0, self.cp, torch.diagonal(self.inner[:, 1, 1], dim1=-2, dim2=-1))
        d.index_add_(0, self.cb, torch.diagonal(self.bnd, dim1=-2, dim2=-1))
        return d.reshape(-1)

    def to(self, dtype: torch.dtype) -> "Operator":
        """The blocks and the rhs rounded to ``dtype``."""
        return self._replace(vol=self.vol.to(dtype), inner=self.inner.to(dtype),
                             bnd=self.bnd.to(dtype), rhs=self.rhs.to(dtype))


def assemble(geo: Geometry, tau: torch.Tensor, delta: torch.Tensor,
             force: torch.Tensor) -> Operator:
    """The system for the per-cell diffusion ``tau``, weighting diffusion
    ``delta`` and force ``force`` ([NC] float64 on the geometry's device)."""
    vol = (tau * geo.area)[:, None, None] * geo.stiff
    tm, tp = tau[geo.cm], tau[geo.cp]
    dm, dp = delta[geo.cm], delta[geo.cp]
    den = dm + dp
    w = torch.stack([dp / den, dm / den], dim=1)                    # [F, 2]
    pen = SIGMA_INNER * dm * dp / den / geo.h                       # [F]
    flux = torch.stack([tm, tp], dim=1)[..., None] * geo.gn * w[..., None]  # [F, 2, 3]
    sign = torch.tensor([1.0, -1.0], dtype=tau.dtype, device=tau.device)
    ss = sign[:, None] * sign[None, :]                              # [2, 2]
    inner = (pen[:, None, None, None, None] * ss[None, :, :, None, None] * geo.mass
             - sign[None, :, None, None, None] * geo.mean[:, :, None, :, None]
             * flux[:, None, :, None, :]
             - sign[None, None, :, None, None] * flux[:, :, None, :, None]
             * geo.mean[:, None, :, None, :])
    tb, db = tau[geo.cb], delta[geo.cb]
    pen_b = SIGMA_BOUNDARY * db / geo.hb
    flux_b = tb[:, None] * geo.gn_b
    bnd = (pen_b[:, None, None] * geo.mass_b - geo.mean_b[:, :, None] * flux_b[:, None, :]
           - flux_b[:, :, None] * geo.mean_b[:, None, :])
    rhs = ((force * geo.area / 3.0)[:, None].expand(-1, 3)).reshape(-1).clone()
    return Operator(vol, inner, bnd, geo.cm, geo.cp, geo.cb, rhs)
