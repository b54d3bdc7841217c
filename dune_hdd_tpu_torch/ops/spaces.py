"""Finite element spaces as flat DoF-index arrays + batched shape evaluation.

Counterpart of ``dune_hdd_tpu/ops/spaces.py`` for P1 on triangles: a
``Space`` is the DoF map ``cell_dofs[NC, nd]`` (host numpy) plus the device
and dtype its tensors live on.  Shape functions are evaluated in physical
coordinates (barycentric), so face kernels evaluate both neighbour bases at
shared quadrature points.  ``tri_shape_values`` / ``tri_shape_grads`` take
numpy arrays (the structured assembly's host geometry) or tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..device import resolve_device
from ..grid.structured import TRIANGLE, Grid

__all__ = ["Space", "cg_space", "dg_space", "tri_shape_values", "tri_shape_grads"]

NOT_PORTED = ("{what} is not ported yet (ROADMAP queue 1, slice 2: quads, P2/P3); "
              "the port's spaces are P1 on triangles")


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
    grid: Grid
    continuous: bool  # CG (vertex dofs) vs DG (per-cell dofs)
    order: int = 1
    basis: str = "nodal"
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        if self.grid.cell_type != TRIANGLE:
            raise NotImplementedError(NOT_PORTED.format(what=f"a {self.grid.cell_type} space"))
        if self.order != 1:
            raise NotImplementedError(NOT_PORTED.format(what=f"order {self.order}"))
        if self.basis != "nodal":
            raise NotImplementedError(NOT_PORTED.format(what=f"the {self.basis!r} basis"))

    @property
    def shape_count(self) -> int:
        """Local shape functions per cell."""
        return self.grid.vertices_per_cell

    @property
    def num_dofs(self) -> int:
        if self.continuous:
            return self.grid.num_vertices
        return self.grid.num_cells * self.shape_count

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """[NC, nd] global DoF indices."""
        if self.continuous:
            return self.grid.cells.astype(np.int32)
        nd = self.shape_count
        return (np.arange(self.grid.num_cells, dtype=np.int32)[:, None] * nd
                + np.arange(nd, dtype=np.int32)[None, :])

    @cached_property
    def nodal_points(self) -> np.ndarray:
        """[NC, nd, 2] physical positions of the local (nodal) basis points."""
        return self.grid.cell_vertices

    def tensor(self, array) -> torch.Tensor:
        """A host array as a tensor on the space's device (floats in its dtype)."""
        a = np.asarray(array)
        dtype = self.dtype if a.dtype.kind == "f" else torch.long
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    def shape_values(self, cellverts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[..., k, nd] values of the local basis at physical points."""
        return tri_shape_values(cellverts, x)

    def shape_gradients(self, cellverts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """[..., k, nd, 2] physical gradients at the points."""
        g = tri_shape_grads(cellverts)
        return torch.broadcast_to(g[..., None, :, :], x.shape[:-1] + g.shape[-2:])

    def interpolate_vertex_function(self, values_at_vertices: torch.Tensor) -> torch.Tensor:
        """Nodal interpolation: vertex values -> DoF vector."""
        if self.continuous:
            return values_at_vertices
        return values_at_vertices[self.tensor(self.grid.cells)].reshape(-1)

    def __repr__(self):
        kind = "CG" if self.continuous else "DG"
        return f"Space({kind} P{self.order} {self.grid.cell_type}, ndofs={self.num_dofs})"


def cg_space(grid: Grid, order: int = 1, device="cuda", dtype=torch.float64) -> Space:
    return Space(grid, continuous=True, order=order, device=resolve_device(device), dtype=dtype)


def dg_space(grid: Grid, order: int = 1, basis: str = "nodal", device="cuda",
             dtype=torch.float64) -> Space:
    """DG space (nodal P1 on triangles) with its tensors on ``device``."""
    return Space(grid, continuous=False, order=order, basis=basis,
                 device=resolve_device(device), dtype=dtype)
