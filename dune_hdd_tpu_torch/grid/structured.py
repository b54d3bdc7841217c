"""Flat-array triangle grids of the ALU-bisected cube (host numpy).

Counterpart of ``dune_hdd_tpu/grid/structured.py``, reduced to what the
SPE10 SWIPDG bench path needs: the criss triangulation of a rectangle and
uniform newest-vertex bisection.  A grid is a set of static index arrays;
the numbering is identical to the reference package's, so every derived
array (cell order, assembly plan) matches it bit for bit.

Conventions
-----------
* triangle cell (v0,v1,v2): local faces f0=(v0,v1), f1=(v1,v2), f2=(v2,v0)
* ``face_cells[f] = (inside, outside)`` with outside == -1 on the boundary;
  face normals point from inside to outside.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Tuple

import numpy as np

__all__ = ["Grid", "rectangle_grid", "bisect", "alu_cube_grid", "TRIANGLE"]

TRIANGLE = "triangle"


@dataclass(frozen=True, eq=False)  # identity equality/hash: grids are built once
class Grid:
    vertices: np.ndarray  # [NV, 2] float64
    cells: np.ndarray  # [NC, 3] int32
    cell_type: str  # TRIANGLE

    # connectivity (derived in __post_init__ via _build_connectivity)
    faces: np.ndarray = field(default=None)  # [NF, 2] vertex ids
    cell_faces: np.ndarray = field(default=None)  # [NC, 3]
    face_cells: np.ndarray = field(default=None)  # [NF, 2] (inside, outside|-1)
    face_local: np.ndarray = field(default=None)  # [NF, 2] local face idx in each cell

    def __post_init__(self):
        if self.cell_type != TRIANGLE:
            raise ValueError(f"only triangle grids are supported, got {self.cell_type!r}")
        if self.faces is None:
            f, cf, fc, fl = _build_connectivity(self.cells)
            object.__setattr__(self, "faces", f)
            object.__setattr__(self, "cell_faces", cf)
            object.__setattr__(self, "face_cells", fc)
            object.__setattr__(self, "face_local", fl)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def faces_per_cell(self) -> int:
        return self.cell_faces.shape[1]

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """[NC, 3, 2] coordinates of each cell's vertices."""
        return self.vertices[self.cells]

    @cached_property
    def cell_centroids(self) -> np.ndarray:
        return self.cell_vertices.mean(axis=1)

    @cached_property
    def face_vertices(self) -> np.ndarray:
        """[NF, 2, 2] coordinates of face endpoints."""
        return self.vertices[self.faces]

    @cached_property
    def face_centroids(self) -> np.ndarray:
        return self.face_vertices.mean(axis=1)

    @cached_property
    def face_normals(self) -> np.ndarray:
        """[NF, 2] unit normals oriented from inside cell to outside."""
        fv = self.face_vertices
        t = fv[:, 1] - fv[:, 0]
        n = np.stack([t[:, 1], -t[:, 0]], axis=-1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        # orient away from the inside cell's centroid
        inside = self.face_cells[:, 0]
        d = self.face_centroids - self.cell_centroids[inside]
        flip = np.sign(np.sum(n * d, axis=-1))
        flip[flip == 0] = 1.0
        return n * flip[:, None]

    @cached_property
    def boundary_faces(self) -> np.ndarray:
        """Boolean mask [NF]."""
        return self.face_cells[:, 1] < 0

    @cached_property
    def interior_faces(self) -> np.ndarray:
        return ~self.boundary_faces

    @cached_property
    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def __repr__(self):
        return (
            f"Grid({self.cell_type}, NV={self.num_vertices}, NC={self.num_cells}, "
            f"NF={self.num_faces})"
        )


def _build_connectivity(cells: np.ndarray):
    local = np.stack([cells[:, [a, b]] for a, b in ((0, 1), (1, 2), (2, 0))],
                     axis=1)  # [NC, 3, 2]
    nc, nfc, _ = local.shape
    flat = local.reshape(-1, 2)
    key = np.sort(flat, axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    nf = uniq.shape[0]

    cell_faces = inverse.reshape(nc, nfc).astype(np.int32)

    face_cells = np.full((nf, 2), -1, dtype=np.int32)
    face_local = np.full((nf, 2), -1, dtype=np.int32)
    owner_cell = np.repeat(np.arange(nc, dtype=np.int32), nfc)
    owner_local = np.tile(np.arange(nfc, dtype=np.int32), nc)
    # first toucher becomes "inside", second "outside": order by (face, cell)
    order = np.lexsort((owner_cell, inverse))
    f_sorted = inverse[order]
    first = np.ones(len(f_sorted), dtype=bool)
    first[1:] = f_sorted[1:] != f_sorted[:-1]
    face_cells[f_sorted[first], 0] = owner_cell[order][first]
    face_local[f_sorted[first], 0] = owner_local[order][first]
    second = ~first
    face_cells[f_sorted[second], 1] = owner_cell[order][second]
    face_local[f_sorted[second], 1] = owner_local[order][second]

    # store faces with the inside cell's orientation (so the normal convention
    # "inside -> outside" matches the local face direction of the inside cell)
    faces = local[face_cells[:, 0], face_local[:, 0]].astype(np.int32)
    return faces, cell_faces, face_cells, face_local


def rectangle_grid(lower=(0.0, 0.0), upper=(1.0, 1.0), num_elements=(4, 4)) -> Grid:
    """Triangulated rectangle: each square split along its (0,0)-(1,1)
    diagonal, lower triangle first."""
    lower = np.asarray(lower, dtype=float)
    upper = np.asarray(upper, dtype=float)
    nx, ny = int(num_elements[0]), int(num_elements[1])
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i, j = I.ravel(), J.ravel()
    v00, v10 = vid(i, j), vid(i + 1, j)
    v11, v01 = vid(i + 1, j + 1), vid(i, j + 1)
    lowert = np.stack([v00, v10, v11], axis=-1)
    uppert = np.stack([v00, v11, v01], axis=-1)
    cells = np.stack([lowert, uppert], axis=1).reshape(-1, 3)
    return Grid(vertices=vertices, cells=cells.astype(np.int32), cell_type=TRIANGLE)


def bisect(grid: Grid) -> Grid:
    """Uniform newest-vertex bisection: each cell's refinement edge is its
    local face 0; children of (a, b, c) with midpoint m of (a, b) are
    (c, a, m) and (b, c, m).  Raises if the bisection would create hanging
    nodes."""
    nv = grid.num_vertices
    ref_face = grid.cell_faces[:, 0]
    claims = np.bincount(ref_face, minlength=grid.num_faces)
    used = np.zeros(grid.num_faces, dtype=bool)
    used[ref_face] = True
    bad = used & grid.interior_faces & (claims != 2)
    if bad.any():
        raise ValueError(
            "uniform bisection would create hanging nodes "
            f"({int(bad.sum())} non-compatible refinement edges)"
        )
    ref_faces = np.unique(ref_face)
    new_vid_of_face = np.full(grid.num_faces, -1, dtype=np.int64)
    new_vid_of_face[ref_faces] = nv + np.arange(len(ref_faces))
    mid = grid.face_vertices[ref_faces].mean(axis=1)
    new_vertices = np.concatenate([grid.vertices, mid], axis=0)
    a, b, c = grid.cells[:, 0], grid.cells[:, 1], grid.cells[:, 2]
    m = new_vid_of_face[ref_face]
    ch0 = np.stack([c, a, m], axis=-1)
    ch1 = np.stack([b, c, m], axis=-1)
    new_cells = np.stack([ch0, ch1], axis=1).reshape(-1, 3)
    return Grid(vertices=new_vertices, cells=new_cells.astype(np.int32),
                cell_type=TRIANGLE)


def alu_cube_grid(lower=(0.0, 0.0), upper=(1.0, 1.0), num_elements=(4, 4),
                  refinements: int = 0) -> Grid:
    """Criss triangulation with the diagonal as refinement edge, then
    ``refinements`` uniform bisections (2 bisections halve h)."""
    g = rectangle_grid(lower, upper, num_elements)
    # lower tri (v00, v10, v11) -> (v00, v11, v10): refinement edge (v00, v11);
    # upper tri (v00, v11, v01) already has the diagonal as local face 0
    cells = g.cells.copy()
    lower_rows = np.arange(0, len(cells), 2)
    cells[lower_rows] = cells[lower_rows][:, [0, 2, 1]]
    g = Grid(vertices=g.vertices, cells=cells, cell_type=TRIANGLE)
    for _ in range(int(refinements)):
        g = bisect(g)
    return g
