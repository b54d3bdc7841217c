"""Flat-array 2D grids (triangle / quad) and 1D interval grids with
uniform refinement hierarchies (host numpy).

Counterpart of ``dune_hdd_tpu/grid/structured.py``: the criss
triangulation or the quad grid of a rectangle, the interval grid, uniform
newest-vertex bisection and uniform red refinement, each refinement with
its ``RefinementInfo``.  A grid is a set of static index arrays; the
numbering is identical to the reference package's, so every derived array
(cell order, assembly plan, DoF maps) matches it bit for bit.

Conventions
-----------
* triangle cell (v0,v1,v2): local faces f0=(v0,v1), f1=(v1,v2), f2=(v2,v0)
* quad cell (v0,v1,v2,v3) counter-clockwise: f0=(v0,v1), f1=(v1,v2),
  f2=(v2,v3), f3=(v3,v0)
* interval cell (v0,v1): vertices are [NV, 1]; a face is one shared vertex,
  stored as the degenerate pair (v, v)
* ``face_cells[f] = (inside, outside)`` with outside == -1 on the boundary;
  face normals point from inside to outside.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Tuple

import numpy as np

__all__ = ["Grid", "RefinementInfo", "rectangle_grid", "interval_grid", "refine", "bisect",
           "alu_cube_grid", "TRIANGLE", "QUAD", "INTERVAL"]

TRIANGLE = "triangle"
QUAD = "quad"
INTERVAL = "interval"
_LOCAL_FACES = {TRIANGLE: ((0, 1), (1, 2), (2, 0)),
                QUAD: ((0, 1), (1, 2), (2, 3), (3, 0)),
                INTERVAL: ((0, 0), (1, 1))}


@dataclass(frozen=True)
class RefinementInfo:
    """Maps between a grid and its uniform refinement.

    vertex_parents[nv, 2]: each fine vertex as midpoint of two coarse
    vertices (copied coarse vertices appear as (v, v); quad cell centres as
    the cell's diagonal pair).  parent_cell[nc_fine]:
    coarse cell containing each fine cell.  child_index[nc_fine]: position
    within the parent."""

    vertex_parents: np.ndarray
    parent_cell: np.ndarray
    child_index: np.ndarray


@dataclass(frozen=True, eq=False)  # identity equality/hash: grids are built once
class Grid:
    vertices: np.ndarray  # [NV, 2] float64 ([NV, 1] for intervals)
    cells: np.ndarray  # [NC, 3|4|2] int32
    cell_type: str  # TRIANGLE | QUAD | INTERVAL

    # connectivity (derived in __post_init__ via _build_connectivity)
    faces: np.ndarray = field(default=None)  # [NF, 2] vertex ids
    cell_faces: np.ndarray = field(default=None)  # [NC, nfc]
    face_cells: np.ndarray = field(default=None)  # [NF, 2] (inside, outside|-1)
    face_local: np.ndarray = field(default=None)  # [NF, 2] local face idx in each cell

    def __post_init__(self):
        if self.cell_type not in _LOCAL_FACES:
            raise ValueError(f"unknown cell type {self.cell_type!r}")
        if self.faces is None:
            f, cf, fc, fl = _build_connectivity(self.cells, self.cell_type)
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
    def vertices_per_cell(self) -> int:
        return self.cells.shape[1]

    @property
    def faces_per_cell(self) -> int:
        return self.cell_faces.shape[1]

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """[NC, nvc, dim] coordinates of each cell's vertices."""
        return self.vertices[self.cells]

    @cached_property
    def cell_centroids(self) -> np.ndarray:
        return self.cell_vertices.mean(axis=1)

    @cached_property
    def cell_volumes(self) -> np.ndarray:
        v = self.cell_vertices
        if self.cell_type == INTERVAL:
            return np.abs(v[:, 1, 0] - v[:, 0, 0])
        if self.cell_type == TRIANGLE:
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            return 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        # shoelace for (convex) quads
        x, y = v[..., 0], v[..., 1]
        xn, yn = np.roll(x, -1, axis=1), np.roll(y, -1, axis=1)
        return 0.5 * np.abs(np.sum(x * yn - xn * y, axis=1))

    @cached_property
    def cell_diameters(self) -> np.ndarray:
        v = self.cell_vertices
        if self.cell_type == INTERVAL:
            return self.cell_volumes
        if self.cell_type == TRIANGLE:
            e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1], v[:, 0] - v[:, 2]], axis=1)
            return np.linalg.norm(e, axis=-1).max(axis=1)
        d1 = np.linalg.norm(v[:, 2] - v[:, 0], axis=-1)
        d2 = np.linalg.norm(v[:, 3] - v[:, 1], axis=-1)
        return np.maximum(d1, d2)

    @cached_property
    def face_vertices(self) -> np.ndarray:
        """[NF, 2, 2] coordinates of face endpoints."""
        return self.vertices[self.faces]

    @cached_property
    def face_centroids(self) -> np.ndarray:
        return self.face_vertices.mean(axis=1)

    @cached_property
    def face_volumes(self) -> np.ndarray:
        """Face lengths |e|.  Intervals: a face is a point, and what the
        SWIPDG penalty needs is the local length scale, min(h_inside,
        h_outside) (the standard 1D IPDG choice)."""
        if self.cell_type == INTERVAL:
            h = self.cell_volumes[self.face_cells[:, 0]].copy()
            outside = self.face_cells[:, 1]
            has_out = outside >= 0
            h[has_out] = np.minimum(h[has_out], self.cell_volumes[outside[has_out]])
            return h
        fv = self.face_vertices
        return np.linalg.norm(fv[:, 1] - fv[:, 0], axis=-1)

    @cached_property
    def face_normals(self) -> np.ndarray:
        """[NF, dim] unit normals oriented from inside cell to outside."""
        if self.cell_type == INTERVAL:
            inside = self.face_cells[:, 0]
            n = np.sign(self.face_centroids[:, 0] - self.cell_centroids[inside, 0])
            n[n == 0] = 1.0
            return n[:, None]
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
    def boundary_vertices(self) -> np.ndarray:
        """Boolean mask [NV]: vertices lying on boundary faces."""
        mask = np.zeros(self.num_vertices, dtype=bool)
        mask[self.faces[self.boundary_faces].ravel()] = True
        return mask

    @cached_property
    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def __repr__(self):
        return (
            f"Grid({self.cell_type}, NV={self.num_vertices}, NC={self.num_cells}, "
            f"NF={self.num_faces})"
        )


def _build_connectivity(cells: np.ndarray, cell_type: str):
    local = np.stack([cells[:, [a, b]] for a, b in _LOCAL_FACES[cell_type]],
                     axis=1)  # [NC, nfc, 2]
    nc, nfc, _ = local.shape
    flat = local.reshape(-1, 2)
    key = np.sort(flat, axis=1).astype(np.int64)
    # rows (a, b) with a <= b sorted as the scalars a * NV + b: the order and
    # inverse of np.unique(key, axis=0), from a one-dimensional sort
    nv = int(cells.max()) + 1
    uniq, inverse = np.unique(key[:, 0] * nv + key[:, 1], return_inverse=True)
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


def rectangle_grid(lower=(0.0, 0.0), upper=(1.0, 1.0), num_elements=(4, 4),
                   cell_type: str = TRIANGLE) -> Grid:
    """Structured grid of a rectangle: quads (v00, v10, v11, v01), or each
    square split along its (0,0)-(1,1) diagonal, lower triangle first."""
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
    if cell_type == QUAD:
        cells = np.stack([v00, v10, v11, v01], axis=-1)
    elif cell_type == TRIANGLE:
        lowert = np.stack([v00, v10, v11], axis=-1)
        uppert = np.stack([v00, v11, v01], axis=-1)
        cells = np.stack([lowert, uppert], axis=1).reshape(-1, 3)
    else:
        raise ValueError(f"unknown cell type {cell_type!r}")
    return Grid(vertices=vertices, cells=cells.astype(np.int32), cell_type=cell_type)


def interval_grid(lower: float = 0.0, upper: float = 1.0, num_elements: int = 8) -> Grid:
    """Uniform 1D interval mesh (the reference's SGrid<1,1>)."""
    n = int(num_elements)
    vertices = np.linspace(float(lower), float(upper), n + 1)[:, None]
    ids = np.arange(n, dtype=np.int32)
    return Grid(vertices=vertices, cells=np.stack([ids, ids + 1], axis=-1),
                cell_type=INTERVAL)


def refine(grid: Grid) -> Tuple[Grid, RefinementInfo]:
    """Uniform red refinement: fine vertices are [coarse vertices] ++ [face
    midpoints (by face id)] (++ [quad cell centres (by cell id)]); the fine
    cells of coarse cell c occupy slots 4c..4c+3.  Intervals bisect: fine
    vertices [coarse vertices] ++ [cell midpoints], children in 2c, 2c+1."""
    nv, nf, nc = grid.num_vertices, grid.num_faces, grid.num_cells
    c = grid.cells.astype(np.int64)
    diag = np.stack([np.arange(nv)] * 2, axis=-1)
    if grid.cell_type == INTERVAL:
        centre_vid = nv + np.arange(nc, dtype=np.int64)
        new_vertices = np.concatenate([grid.vertices, grid.cell_vertices.mean(axis=1)], axis=0)
        vertex_parents = np.concatenate([diag, c], axis=0)
        ch0 = np.stack([c[:, 0], centre_vid], axis=-1)
        ch1 = np.stack([centre_vid, c[:, 1]], axis=-1)
        new_cells = np.stack([ch0, ch1], axis=1).reshape(-1, 2)
        info = RefinementInfo(vertex_parents=vertex_parents,
                              parent_cell=np.repeat(np.arange(nc, dtype=np.int64), 2),
                              child_index=np.tile(np.arange(2, dtype=np.int64), nc))
        return Grid(vertices=new_vertices, cells=new_cells.astype(np.int32),
                    cell_type=INTERVAL), info

    mid = grid.face_vertices.mean(axis=1)
    edge_vid = nv + np.arange(nf, dtype=np.int64)
    m = edge_vid[grid.cell_faces]  # [NC, nfc] midpoint of each local face
    if grid.cell_type == TRIANGLE:
        new_vertices = np.concatenate([grid.vertices, mid], axis=0)
        vertex_parents = np.concatenate([diag, grid.faces.astype(np.int64)], axis=0)
        m01, m12, m20 = m[:, 0], m[:, 1], m[:, 2]
        ch0 = np.stack([c[:, 0], m01, m20], axis=-1)
        ch1 = np.stack([m01, c[:, 1], m12], axis=-1)
        ch2 = np.stack([m20, m12, c[:, 2]], axis=-1)
        ch3 = np.stack([m01, m12, m20], axis=-1)  # centre triangle
    else:  # QUAD
        cc = nv + nf + np.arange(nc, dtype=np.int64)  # cell centres
        new_vertices = np.concatenate(
            [grid.vertices, mid, grid.cell_vertices.mean(axis=1)], axis=0)
        vertex_parents = np.concatenate(
            [diag, grid.faces.astype(np.int64), c[:, [0, 2]]], axis=0)  # diagonal pair
        m01, m12, m23, m30 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
        ch0 = np.stack([c[:, 0], m01, cc, m30], axis=-1)
        ch1 = np.stack([m01, c[:, 1], m12, cc], axis=-1)
        ch2 = np.stack([cc, m12, c[:, 2], m23], axis=-1)
        ch3 = np.stack([m30, cc, m23, c[:, 3]], axis=-1)
    new_cells = np.stack([ch0, ch1, ch2, ch3], axis=1).reshape(nc * 4, -1)
    info = RefinementInfo(
        vertex_parents=vertex_parents,
        parent_cell=np.repeat(np.arange(nc, dtype=np.int64), 4),
        child_index=np.tile(np.arange(4, dtype=np.int64), nc),
    )
    return Grid(vertices=new_vertices, cells=new_cells.astype(np.int32),
                cell_type=grid.cell_type), info


def bisect(grid: Grid) -> Tuple[Grid, RefinementInfo]:
    """Uniform newest-vertex bisection: each cell's refinement edge is its
    local face 0; children of (a, b, c) with midpoint m of (a, b) are
    (c, a, m) and (b, c, m).  Raises if the bisection would create hanging
    nodes."""
    if grid.cell_type != TRIANGLE:
        raise ValueError("bisection refinement is for triangle grids")
    nv, nc = grid.num_vertices, grid.num_cells
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
    vertex_parents = np.concatenate(
        [np.stack([np.arange(nv)] * 2, axis=-1), grid.faces[ref_faces].astype(np.int64)],
        axis=0)
    a, b, c = grid.cells[:, 0], grid.cells[:, 1], grid.cells[:, 2]
    m = new_vid_of_face[ref_face]
    ch0 = np.stack([c, a, m], axis=-1)
    ch1 = np.stack([b, c, m], axis=-1)
    new_cells = np.stack([ch0, ch1], axis=1).reshape(-1, 3)
    info = RefinementInfo(
        vertex_parents=vertex_parents,
        parent_cell=np.repeat(np.arange(nc, dtype=np.int64), 2),
        child_index=np.tile(np.arange(2, dtype=np.int64), nc),
    )
    return Grid(vertices=new_vertices, cells=new_cells.astype(np.int32),
                cell_type=TRIANGLE), info


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
        g, _ = bisect(g)
    return g
