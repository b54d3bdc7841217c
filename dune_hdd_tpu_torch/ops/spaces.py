"""Finite element spaces as flat DoF-index arrays + batched shape evaluation.

Counterpart of ``dune_hdd_tpu/ops/spaces.py``: a ``Space`` is the DoF map
``cell_dofs[NC, nd]`` (host numpy) plus the device and dtype its tensors
live on.  Lagrange P1-P3 on triangles and intervals, Q1/Q2 on axis-aligned
rectangles and the total-degree-1 monomial DG basis on rectangles.  Shape
functions are evaluated in physical coordinates (barycentric on triangles,
tensor-Lagrange on rectangles), so face kernels evaluate both neighbour
bases at shared quadrature points.  ``tri_shape_values`` /
``tri_shape_grads`` take numpy arrays (the structured assembly's host
geometry) or tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..device import resolve_device
from ..grid.structured import INTERVAL, QUAD, TRIANGLE, Grid

__all__ = ["Space", "cg_space", "dg_space", "tri_shape_values", "tri_shape_grads"]


def _stack(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=axis)
    return np.stack(parts, axis=axis)


def tri_shape_values(cellverts, x):
    """Barycentric coordinates of x in the triangle == P1 shape values.

    cellverts [..., 3, 2], x [..., k, 2] -> [..., k, 3].
    """
    v0 = cellverts[..., 0, :]
    e1 = cellverts[..., 1, :] - v0
    e2 = cellverts[..., 2, :] - v0
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    r = x - v0[..., None, :]
    lam1 = (r[..., 0] * e2[..., None, 1] - r[..., 1] * e2[..., None, 0]) / det[..., None]
    lam2 = (e1[..., None, 0] * r[..., 1] - e1[..., None, 1] * r[..., 0]) / det[..., None]
    lam0 = 1.0 - lam1 - lam2
    return _stack([lam0, lam1, lam2], -1)


def tri_shape_grads(cellverts):
    """[..., 3, 2] constant physical gradients of the barycentric basis."""
    v0 = cellverts[..., 0, :]
    e1 = cellverts[..., 1, :] - v0
    e2 = cellverts[..., 2, :] - v0
    det = (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])[..., None]
    g1 = _stack([e2[..., 1], -e2[..., 0]], -1) / det
    g2 = _stack([-e1[..., 1], e1[..., 0]], -1) / det
    g0 = -g1 - g2
    return _stack([g0, g1, g2], -2)


@dataclass(frozen=True, eq=False)  # identity hash (holds numpy-array members)
class Space:
    """``basis``: "nodal" (Lagrange) or "p1" (total-degree monomials {1, xi,
    eta} on rectangles: dune-fem's DG space on quads, with which the SGrid
    tables were recorded).  ``device``: the card unless the caller asks for
    the CPU (raises without a card)."""

    grid: Grid
    continuous: bool  # CG (nodal dofs) vs DG (per-cell dofs)
    order: int = 1
    basis: str = "nodal"
    device: torch.device = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        if self.order not in (1, 2, 3):
            raise NotImplementedError("orders 1-3 implemented")
        if self.order == 3 and self.grid.cell_type not in (TRIANGLE, INTERVAL):
            raise NotImplementedError("order 3 is triangle/interval-only")
        if self.basis == "p1" and (self.continuous or self.order != 1):
            raise ValueError("monomial p1 basis is order-1 DG-only")
        if self.basis == "p1" and self.grid.cell_type == INTERVAL:
            raise ValueError("monomial p1 basis is quad-only")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape_count(self) -> int:
        """Local shape functions per cell."""
        ct = self.grid.cell_type
        if ct == INTERVAL:
            return self.order + 1
        if self.basis == "p1":
            return 3
        if self.order == 3:
            return 10  # P3 triangle: 3 vertices + 2 per edge + centre
        if self.order == 2:
            return 6 if ct == TRIANGLE else 9  # P2: + 3 edges; Q2: + 4 edges + centre
        return self.grid.vertices_per_cell

    @property
    def num_dofs(self) -> int:
        g = self.grid
        if not self.continuous:
            return g.num_cells * self.shape_count
        if g.cell_type == INTERVAL:  # vertices + (order-1) interior nodes per cell
            return g.num_vertices + (self.order - 1) * g.num_cells
        if self.order == 3:
            return g.num_vertices + 2 * g.num_faces + g.num_cells
        if self.order == 2:
            return g.num_vertices + g.num_faces + (g.num_cells if g.cell_type == QUAD else 0)
        return g.num_vertices

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """[NC, nd] global DoF indices.

        P2 local node order: (v0, v1, v2, e01, e12, e20), edge nodes in the
        local face numbering; Q2 adds the cell centre last.  P3: (v0, v1,
        v2, e01a, e01b, e12a, e12b, e20a, e20b, c) with node "a" at 2/3 of
        the local first vertex; the global DoF of an edge slot absorbs the
        edge orientation (canonical = ascending global vertex id), so shared
        edges are conforming."""
        g = self.grid
        if not self.continuous:
            nd = self.shape_count
            return (np.arange(g.num_cells, dtype=np.int32)[:, None] * nd
                    + np.arange(nd, dtype=np.int32)[None, :])
        cells = g.cells.astype(np.int64)
        nv, nf, nc = g.num_vertices, g.num_faces, g.num_cells
        if g.cell_type == INTERVAL:
            k = self.order - 1  # interior nodes per cell
            interior = (nv + k * np.arange(nc, dtype=np.int64)[:, None]
                        + np.arange(k, dtype=np.int64)[None, :])
            return np.concatenate([cells, interior], axis=1).astype(np.int32)
        if self.order == 3:
            out = np.empty((nc, 10), dtype=np.int64)
            out[:, :3] = cells
            for kf, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
                f = g.cell_faces[:, kf].astype(np.int64)
                fwd = cells[:, i] < cells[:, j]  # local direction == canonical
                out[:, 3 + 2 * kf] = nv + 2 * f + np.where(fwd, 0, 1)
                out[:, 4 + 2 * kf] = nv + 2 * f + np.where(fwd, 1, 0)
            out[:, 9] = nv + 2 * nf + np.arange(nc)
            return out.astype(np.int32)
        if self.order == 2:
            parts = [cells, nv + g.cell_faces.astype(np.int64)]
            if g.cell_type == QUAD:
                parts.append((nv + nf + np.arange(nc, dtype=np.int64))[:, None])
            return np.concatenate(parts, axis=1).astype(np.int32)
        return g.cells.astype(np.int32)

    @cached_property
    def nodal_points(self) -> np.ndarray:
        """[NC, nd, dim] physical positions of the local (nodal) basis points."""
        v = self.grid.cell_vertices
        if self.basis == "p1":
            raise NotImplementedError("monomial basis has no nodal points")
        if self.grid.cell_type == INTERVAL:
            r = _interval_ref_nodes(self.order)
            v0, v1 = v[:, 0, :], v[:, 1, :]
            return v0[:, None, :] + r[None, :, None] * (v1 - v0)[:, None, :]
        if self.order == 1:
            return v
        if self.order == 3:
            vn = np.roll(v, -1, axis=1)
            edge = np.stack([(2.0 * v + vn) / 3.0, (v + 2.0 * vn) / 3.0],
                            axis=2).reshape(v.shape[0], 6, 2)
            return np.concatenate([v, edge, v.mean(axis=1, keepdims=True)], axis=1)
        parts = [v, 0.5 * (v + np.roll(v, -1, axis=1))]  # vertices, face midpoints
        if self.grid.cell_type == QUAD:
            parts.append(v.mean(axis=1, keepdims=True))  # centre node
        return np.concatenate(parts, axis=1)

    def tensor(self, array) -> torch.Tensor:
        """A host array as a tensor on the space's device (floats in its dtype)."""
        a = np.asarray(array)
        dtype = self.dtype if a.dtype.kind == "f" else torch.long
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def shape_values(self, cellverts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[..., k, nd] values of the local basis at physical points."""
        ct = self.grid.cell_type
        if ct == INTERVAL:
            return _interval_values(cellverts, x, self.order)
        if self.basis == "p1" and ct == QUAD:
            return _p1_monomial_values(cellverts, x)
        if ct == TRIANGLE:
            lam = tri_shape_values(cellverts, x)
            if self.order == 3:
                return _tri_p3_values(lam)
            return _tri_p2_values(lam) if self.order == 2 else lam
        return _quad_q2_values(cellverts, x) if self.order == 2 else _quad_shape_values(
            cellverts, x)

    def shape_gradients(self, cellverts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[..., k, nd, dim] physical gradients at the points."""
        ct = self.grid.cell_type
        if ct == INTERVAL:
            return _interval_grads(cellverts, x, self.order)
        if self.basis == "p1" and ct == QUAD:
            return _p1_monomial_grads(cellverts, x)
        if ct == TRIANGLE:
            g = tri_shape_grads(cellverts)  # [..., 3, 2], constant in x
            if self.order == 3:
                return _tri_p3_grads(tri_shape_values(cellverts, x), g)
            if self.order == 2:
                return _tri_p2_grads(tri_shape_values(cellverts, x), g)
            return torch.broadcast_to(g[..., None, :, :], x.shape[:-1] + g.shape[-2:])
        return _quad_q2_grads(cellverts, x) if self.order == 2 else _quad_shape_grads(
            cellverts, x)

    def interpolate_vertex_function(self, values_at_vertices: torch.Tensor) -> torch.Tensor:
        """Nodal interpolation: vertex values -> DoF vector."""
        if self.basis != "nodal":
            raise NotImplementedError("nodal interpolation needs the nodal basis")
        if self.continuous:
            return values_at_vertices
        return values_at_vertices[self.tensor(self.grid.cells)].reshape(-1)

    def __repr__(self):
        kind = "CG" if self.continuous else "DG"
        return f"Space({kind} P{self.order} {self.grid.cell_type}, ndofs={self.num_dofs})"


def cg_space(grid: Grid, order: int = 1, device="cuda", dtype=torch.float64) -> Space:
    return Space(grid, continuous=True, order=order, device=device, dtype=dtype)


def dg_space(grid: Grid, order: int = 1, basis: str = "nodal", device="cuda",
             dtype=torch.float64) -> Space:
    """DG space (nodal Lagrange by default; ``basis="p1"`` on quads for the
    total-degree-1 monomial space) with its tensors on ``device``."""
    return Space(grid, continuous=False, order=order, basis=basis, device=device, dtype=dtype)


# -- physical-coordinate shape functions -------------------------------------


def _interval_ref_nodes(order: int) -> np.ndarray:
    """Reference nodes on [0,1], vertices first (the cell_dofs order)."""
    return {1: np.array([0.0, 1.0]), 2: np.array([0.0, 1.0, 0.5]),
            3: np.array([0.0, 1.0, 1.0 / 3.0, 2.0 / 3.0])}[order]


def _interval_rel(cellverts, x):
    """Reference coordinate r [..., k] in [0,1] and cell length h [...] for
    cellverts [..., 2, 1], x [..., k, 1]."""
    v0 = cellverts[..., 0, 0]
    h = cellverts[..., 1, 0] - v0
    return (x[..., 0] - v0[..., None]) / h[..., None], h


def _interval_values(cellverts, x, order: int):
    """[..., k, nd] Lagrange values on intervals (nodes vertices-first)."""
    r, _ = _interval_rel(cellverts, x)
    nodes = _interval_ref_nodes(order)
    cols = []
    for i, ni in enumerate(nodes):
        li = torch.ones_like(r)
        for j, nj in enumerate(nodes):
            if j != i:
                li = li * (r - nj) / (ni - nj)
        cols.append(li)
    return torch.stack(cols, dim=-1)


def _interval_grads(cellverts, x, order: int):
    """[..., k, nd, 1] physical derivatives of the interval Lagrange basis."""
    r, h = _interval_rel(cellverts, x)
    nodes = _interval_ref_nodes(order)
    cols = []
    for i, ni in enumerate(nodes):
        others = [nj for j, nj in enumerate(nodes) if j != i]
        denom = float(np.prod([ni - nj for nj in others]))
        dli = torch.zeros_like(r)
        for skip in range(len(others)):
            term = torch.ones_like(r)
            for j, nj in enumerate(others):
                if j != skip:
                    term = term * (r - nj)
            dli = dli + term
        cols.append(dli / denom)
    return (torch.stack(cols, dim=-1) / h[..., None, None])[..., None]


def _tri_p2_values(lam):
    """P2 from barycentrics lam [..., k, 3]: vertex i lam_i (2 lam_i - 1),
    edge (a,b) 4 lam_a lam_b."""
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    return torch.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                        4 * l0 * l1, 4 * l1 * l2, 4 * l2 * l0], dim=-1)


def _tri_p2_grads(lam, g):
    """P2 gradients: lam [..., k, 3], g [..., 3, 2] -> [..., k, 6, 2]."""
    gb = g[..., None, :, :]  # [..., 1, 3, 2]
    l = lam[..., None]  # [..., k, 3, 1]
    vertex = (4 * l - 1) * gb
    g0, g1, g2 = gb[..., 0, :], gb[..., 1, :], gb[..., 2, :]
    l0, l1, l2 = l[..., 0, :], l[..., 1, :], l[..., 2, :]
    edges = torch.stack([4 * (l0 * g1 + l1 * g0), 4 * (l1 * g2 + l2 * g1),
                         4 * (l2 * g0 + l0 * g2)], dim=-2)
    return torch.cat([vertex, edges], dim=-2)


def _tri_p3_values(lam):
    """P3 from barycentrics lam [..., k, 3], node order (v0, v1, v2, e01a,
    e01b, e12a, e12b, e20a, e20b, c), e_ij a at 2/3 v_i + 1/3 v_j."""
    l = [lam[..., i] for i in range(3)]
    out = [li * (3 * li - 1) * (3 * li - 2) / 2 for li in l]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        out.append(4.5 * l[i] * l[j] * (3 * l[i] - 1))
        out.append(4.5 * l[i] * l[j] * (3 * l[j] - 1))
    out.append(27.0 * l[0] * l[1] * l[2])
    return torch.stack(out, dim=-1)


def _tri_p3_grads(lam, g):
    """P3 gradients: lam [..., k, 3], g [..., 3, 2] -> [..., k, 10, 2]."""
    gb = g[..., None, :, :]
    l = [lam[..., i, None] for i in range(3)]
    gi = [gb[..., i, :] for i in range(3)]
    out = [((27 * l[i] * l[i] - 18 * l[i] + 2) / 2) * gi[i] for i in range(3)]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        out.append(4.5 * (l[j] * (6 * l[i] - 1) * gi[i] + l[i] * (3 * l[i] - 1) * gi[j]))
        out.append(4.5 * (l[j] * (3 * l[j] - 1) * gi[i] + l[i] * (6 * l[j] - 1) * gi[j]))
    out.append(27.0 * (l[1] * l[2] * gi[0] + l[0] * l[2] * gi[1] + l[0] * l[1] * gi[2]))
    return torch.stack(out, dim=-2)


def _rect_local(cellverts, x):
    """Cell-local coordinates t [..., k, 2] in [0,1]^2 and extents [..., 2]
    of an axis-aligned rectangle (v0 lower-left, v2 upper-right)."""
    lo = cellverts[..., 0, :]
    ext = cellverts[..., 2, :] - lo
    return (x - lo[..., None, :]) / ext[..., None, :], ext


def _p1_monomial_values(cellverts, x):
    """{1, xi - 1/2, eta - 1/2} in cell-local coordinates.  [..., k, 3]."""
    t, _ = _rect_local(cellverts, x)
    return torch.stack([torch.ones_like(t[..., 0]), t[..., 0] - 0.5, t[..., 1] - 0.5], dim=-1)


def _p1_monomial_grads(cellverts, x):
    _, ext = _rect_local(cellverts, x)
    zeros = x.new_zeros(x.shape[:-1])
    inv_x = torch.broadcast_to(1.0 / ext[..., None, 0], zeros.shape)
    inv_y = torch.broadcast_to(1.0 / ext[..., None, 1], zeros.shape)
    return torch.stack([torch.stack([zeros, zeros], dim=-1),
                        torch.stack([inv_x, zeros], dim=-1),
                        torch.stack([zeros, inv_y], dim=-1)], dim=-2)


def _quad_shape_values(cellverts, x):
    """Bilinear Q1 on axis-aligned rectangles, vertex order (v00, v10, v11,
    v01).  [..., k, 4]."""
    t, _ = _rect_local(cellverts, x)
    xi, eta = t[..., 0], t[..., 1]
    return torch.stack([(1 - xi) * (1 - eta), xi * (1 - eta), xi * eta, (1 - xi) * eta],
                       dim=-1)


def _quad_shape_grads(cellverts, x):
    t, ext = _rect_local(cellverts, x)
    xi, eta = t[..., 0], t[..., 1]
    dxi = torch.stack([-(1 - eta), (1 - eta), eta, -eta], dim=-1)
    deta = torch.stack([-(1 - xi), -xi, xi, (1 - xi)], dim=-1)
    return torch.stack([dxi / ext[..., None, 0:1], deta / ext[..., None, 1:2]], dim=-1)


def _q2_1d(t):
    """1D quadratic Lagrange basis at {0, 1/2, 1} and its derivatives."""
    return (((2 * t - 1) * (t - 1), 4 * t * (1 - t), t * (2 * t - 1)),
            (4 * t - 3, 4 - 8 * t, 4 * t - 1))


def _q2_tensor(ax, ay):
    """The 9 Q2 products in node order (v00, v10, v11, v01, e_bottom,
    e_right, e_top, e_left, centre) of 1D factors (A, B, C) per axis."""
    (Ax, Bx, Cx), (Ay, By, Cy) = ax, ay
    return torch.stack([Ax * Ay, Cx * Ay, Cx * Cy, Ax * Cy,
                        Bx * Ay, Cx * By, Bx * Cy, Ax * By, Bx * By], dim=-1)


def _quad_q2_values(cellverts, x):
    """Biquadratic Q2 on axis-aligned rectangles.  [..., k, 9]."""
    t, _ = _rect_local(cellverts, x)
    return _q2_tensor(_q2_1d(t[..., 0])[0], _q2_1d(t[..., 1])[0])


def _quad_q2_grads(cellverts, x):
    t, ext = _rect_local(cellverts, x)
    vx, dx = _q2_1d(t[..., 0])
    vy, dy = _q2_1d(t[..., 1])
    return torch.stack([_q2_tensor(dx, vy) / ext[..., None, 0:1],
                        _q2_tensor(vx, dy) / ext[..., None, 1:2]], dim=-1)
