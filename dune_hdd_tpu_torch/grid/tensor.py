"""Tensor-product interval grids in d = 1, 2, 3 dimensions (host numpy).

Counterpart of ``dune_hdd_tpu/grid/tensor.py``.  The reference instantiates
its CG discretization on SGrid<1,1> and SGrid<3,3> next to the 2D grids
(examples/linearelliptic/cg.cc:19-21); this module is the
dimension-generic counterpart of ``grid/structured.py``'s 2D quad grids:
axis-aligned boxes on a tensor lattice, with uniform refinement, boundary
facets and their classification.  The vertex order is lexicographic (last
axis fastest) and the corner order of a cell counts in binary over the axes
(axis 0 the most significant bit), as in the reference package.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np

__all__ = ["TensorGrid", "TensorFacets", "TensorBoundaryInfo", "make_tensor_boundary_info",
           "TensorGridHierarchy", "tensor_grid"]


@dataclass(frozen=True, eq=False)
class TensorGrid:
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    shape: Tuple[int, ...]  # cells per axis

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def vertex_shape(self) -> Tuple[int, ...]:
        return tuple(n + 1 for n in self.shape)

    @property
    def num_vertices(self) -> int:
        return int(np.prod(self.vertex_shape))

    @property
    def h(self) -> np.ndarray:
        return (np.asarray(self.upper) - np.asarray(self.lower)) / np.asarray(self.shape)

    @cached_property
    def vertices(self) -> np.ndarray:
        """[NV, d] lexicographic (last axis fastest)."""
        axes = [np.linspace(self.lower[a], self.upper[a], self.shape[a] + 1)
                for a in range(self.dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack([m.ravel() for m in mesh], axis=-1)

    @cached_property
    def cells(self) -> np.ndarray:
        """[NC, 2^d] vertex ids, corner order = binary counting over axes
        (bit a of the corner index = offset along axis a; axis 0 is the
        most significant bit, matching the lexicographic vertex order)."""
        vs = self.vertex_shape
        strides = np.cumprod([1] + list(vs[::-1]))[::-1][1:]  # vertex strides
        base_axes = [np.arange(n) for n in self.shape]
        mesh = np.meshgrid(*base_axes, indexing="ij")
        base = sum(m.ravel() * strides[a] for a, m in enumerate(mesh))
        d = self.dim
        corners = []
        for c in range(1 << d):
            off = sum(((c >> (d - 1 - a)) & 1) * strides[a] for a in range(d))
            corners.append(base + off)
        return np.stack(corners, axis=-1).astype(np.int64)

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        return self.vertices[self.cells]

    @cached_property
    def boundary_vertices(self) -> np.ndarray:
        """[NV] bool mask of vertices on the domain boundary."""
        vs = self.vertex_shape
        idx = np.unravel_index(np.arange(self.num_vertices), vs)
        mask = np.zeros(self.num_vertices, dtype=bool)
        for a in range(self.dim):
            mask |= (idx[a] == 0) | (idx[a] == vs[a] - 1)
        return mask

    def refine(self) -> "TensorGrid":
        return TensorGrid(self.lower, self.upper,
                          tuple(2 * n for n in self.shape))

    @cached_property
    def boundary_facets(self) -> "TensorFacets":
        """All boundary facets ((d-1)-dimensional sides of boundary cells):
        corner vertex ids in tensor order over the non-normal axes, the
        normal axis, the side (0 = lower, 1 = upper) and the facet measure.
        The reference's intersection walk restricted to the boundary
        (cg.hh:273-289 Neumann faces; boundary classification
        discreteproblem.hh:128-132)."""
        d = self.dim
        corners_list, axes_list, sides_list, measures = [], [], [], []
        cell_corners = self.cells  # [NC, 2^d]
        idx = np.unravel_index(np.arange(self.num_cells), self.shape)
        h = self.h
        for a in range(d):
            # corner ids of the facet: cell corners with bit a == side,
            # ordered by the remaining bits (tensor order of other axes)
            rest = [c for c in range(1 << d) if not (c >> (d - 1 - a)) & 1]
            for side in (0, 1):
                sel = np.nonzero(idx[a] == (0 if side == 0 else self.shape[a] - 1))[0]
                loc = [c | (side << (d - 1 - a)) for c in rest]
                corners_list.append(cell_corners[sel][:, loc])
                axes_list.append(np.full(len(sel), a, dtype=np.int64))
                sides_list.append(np.full(len(sel), side, dtype=np.int64))
                measures.append(np.full(
                    len(sel), float(np.prod(np.delete(h, a)))))
        return TensorFacets(
            corners=np.concatenate(corners_list, axis=0),
            axis=np.concatenate(axes_list),
            side=np.concatenate(sides_list),
            measure=np.concatenate(measures),
        )


@dataclass(frozen=True)
class TensorFacets:
    corners: np.ndarray   # [NF, 2^(d-1)] vertex ids
    axis: np.ndarray      # [NF] normal axis
    side: np.ndarray      # [NF] 0 = lower side, 1 = upper side
    measure: np.ndarray   # [NF] (d-1)-measure

    @property
    def num(self) -> int:
        return self.corners.shape[0]

    def normals(self, dim: int) -> np.ndarray:
        """[NF, d] outward unit normals (axis-aligned)."""
        n = np.zeros((self.num, dim))
        n[np.arange(self.num), self.axis] = np.where(self.side == 1, 1.0, -1.0)
        return n


@dataclass(frozen=True, eq=False)
class TensorBoundaryInfo:
    """Facet classification on a TensorGrid — the dimension-generic image of
    grid/boundaryinfo.py (Stuff::Grid::BoundaryInfoConfigs,
    discreteproblem.hh:128-132; NormalBased thermalblock.hh:480-484)."""

    grid: TensorGrid
    dirichlet_facets: np.ndarray  # [NF] bool over grid.boundary_facets
    neumann_facets: np.ndarray

    @property
    def has_dirichlet(self) -> bool:
        return bool(self.dirichlet_facets.any())

    @property
    def has_neumann(self) -> bool:
        return bool(self.neumann_facets.any())

    @cached_property
    def dirichlet_vertices(self) -> np.ndarray:
        """[NV] bool mask of vertices on any Dirichlet facet."""
        mask = np.zeros(self.grid.num_vertices, dtype=bool)
        f = self.grid.boundary_facets
        mask[f.corners[self.dirichlet_facets].reshape(-1)] = True
        return mask


def make_tensor_boundary_info(grid: TensorGrid, config=None) -> TensorBoundaryInfo:
    """config["type"] in {"stuff.grid.boundaryinfo.alldirichlet" (default),
    "...allneumann", "...normalbased"}; normalbased takes ``default`` plus
    ``dirichlet``/``neumann`` lists of outward normal directions."""
    if isinstance(config, TensorBoundaryInfo):
        return config
    cfg = dict(config or {})
    t = str(cfg.get("type", "stuff.grid.boundaryinfo.alldirichlet")).lower()
    f = grid.boundary_facets
    all_ = np.ones(f.num, dtype=bool)
    none = np.zeros(f.num, dtype=bool)
    if t.endswith("alldirichlet"):
        return TensorBoundaryInfo(grid, all_, none)
    if t.endswith("allneumann"):
        return TensorBoundaryInfo(grid, none, all_)
    if t.endswith("normalbased"):
        normals = f.normals(grid.dim)

        def direction_mask(dirs) -> np.ndarray:
            m = np.zeros(f.num, dtype=bool)
            for v in dirs:
                v = np.asarray(v, dtype=float)
                v = v / max(np.linalg.norm(v), 1e-300)
                m |= normals @ v > 0.5
            return m

        default = str(cfg.get("default", "dirichlet")).lower()
        neu = direction_mask(cfg.get("neumann", []))
        dir_ = direction_mask(cfg.get("dirichlet", []))
        if default.startswith("dirichlet"):
            dir_ = ~neu | dir_
        else:
            neu = ~dir_ | neu
        return TensorBoundaryInfo(grid, dir_, neu & ~dir_)
    raise ValueError(f"unknown boundary info type {t!r}")


class TensorGridHierarchy:
    """Refinement hierarchy of TensorGrids: levels 0..n are the study grids,
    one extra level is the reference grid (testcases/base.hh:92-103)."""

    def __init__(self, base: TensorGrid, num_levels: int):
        self.grids = [base]
        for _ in range(num_levels):
            self.grids.append(self.grids[-1].refine())

    def __len__(self) -> int:
        return len(self.grids)

    def __getitem__(self, r: int) -> TensorGrid:
        return self.grids[r]

    @property
    def reference(self) -> TensorGrid:
        return self.grids[-1]


def tensor_grid(lower, upper, shape) -> TensorGrid:
    lower = tuple(float(v) for v in np.atleast_1d(lower))
    upper = tuple(float(v) for v in np.atleast_1d(upper))
    shape = tuple(int(v) for v in np.atleast_1d(shape))
    assert len(lower) == len(upper) == len(shape)
    return TensorGrid(lower, upper, shape)
