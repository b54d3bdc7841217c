"""Partitioned ("multiscale") grid views for domain decomposition (host numpy).

Counterpart of ``dune_hdd_tpu/grid/multiscale.py``.  A MultiscaleGrid is a
cell -> subdomain labelling of a flat Grid (a ``num_partitions`` tensor
partition of its bounding box, x fastest) plus derived index sets: the cells
of each subdomain, its inner faces, the coupling faces of each neighbour
pair, its boundary faces, BFS-grown oversampled patches and the subdomain
diameters.  ``subdomain_table`` is the padded [S, max cells] gather table of
the cells by subdomain, through which the estimators reduce per-cell values
by subdomain without atomics.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .structured import Grid

__all__ = ["MultiscaleGrid", "extract_subgrid", "Subgrid"]


class MultiscaleGrid:
    def __init__(self, grid: Grid, num_partitions: Sequence[int],
                 oversampling_layers: int = 0):
        self.grid = grid
        self.num_partitions = (int(num_partitions[0]), int(num_partitions[1]))
        self.oversampling_layers = int(oversampling_layers)
        lo, hi = grid.bounding_box
        ns = np.asarray(self.num_partitions, dtype=float)
        rel = (grid.cell_centroids - lo) / (hi - lo)
        ij = np.minimum((rel * ns).astype(np.int64), np.asarray(self.num_partitions) - 1)
        #: subdomain index per cell, x fastest
        self.subdomain_of = (ij[:, 0] + self.num_partitions[0] * ij[:, 1]).astype(np.int32)

    def size(self) -> int:
        """Number of subdomains."""
        return self.num_partitions[0] * self.num_partitions[1]

    # -- cells ---------------------------------------------------------------
    @cached_property
    def _cells_per_subdomain(self) -> List[np.ndarray]:
        order = np.argsort(self.subdomain_of, kind="stable")
        counts = np.bincount(self.subdomain_of, minlength=self.size())
        return np.split(order, np.cumsum(counts)[:-1])

    def cells(self, ss: int) -> np.ndarray:
        return self._cells_per_subdomain[ss]

    def subdomain_of_cell(self, cell: int) -> int:
        return int(self.subdomain_of[cell])

    @cached_property
    def subdomain_table(self) -> np.ndarray:
        """[S, max cells] cell ids of each subdomain in ascending order,
        padded with ``grid.num_cells`` (the index of an appended neutral
        element)."""
        cells = self._cells_per_subdomain
        table = np.full((self.size(), max(len(c) for c in cells)), self.grid.num_cells,
                        dtype=np.int64)
        for ss, c in enumerate(cells):
            table[ss, :len(c)] = c
        return table

    # -- faces ---------------------------------------------------------------
    @cached_property
    def _face_subdomains(self) -> np.ndarray:
        """[NF, 2] subdomain of (inside, outside); -1 for boundary outside."""
        fc = self.grid.face_cells
        inside = self.subdomain_of[fc[:, 0]]
        outside = np.where(fc[:, 1] >= 0, self.subdomain_of[np.maximum(fc[:, 1], 0)], -1)
        return np.stack([inside, outside], axis=1)

    def inner_faces(self, ss: int) -> np.ndarray:
        """Interior faces with both sides in subdomain ss."""
        fs = self._face_subdomains
        return np.nonzero((fs[:, 0] == ss) & (fs[:, 1] == ss))[0]

    def coupling_faces(self, ss: int, nn: int) -> np.ndarray:
        """Faces between subdomains ss and nn (symmetric set; the global face
        normal may point either way)."""
        fs = self._face_subdomains
        mask = ((fs[:, 0] == ss) & (fs[:, 1] == nn)) | ((fs[:, 0] == nn) & (fs[:, 1] == ss))
        return np.nonzero(mask)[0]

    def boundary_faces(self, ss: int) -> np.ndarray:
        fs = self._face_subdomains
        return np.nonzero((fs[:, 0] == ss) & (fs[:, 1] == -1))[0]

    @cached_property
    def _neighbors(self) -> List[np.ndarray]:
        fs = self._face_subdomains
        pairs = fs[(fs[:, 1] >= 0) & (fs[:, 0] != fs[:, 1])]
        out: List[set] = [set() for _ in range(self.size())]
        for a, b in np.unique(pairs, axis=0):
            out[a].add(int(b))
            out[b].add(int(a))
        return [np.asarray(sorted(s), dtype=np.int64) for s in out]

    def neighbors_of(self, ss: int) -> np.ndarray:
        return self._neighbors[ss]

    def boundary_subdomains(self) -> np.ndarray:
        return np.unique(self._face_subdomains[self.grid.boundary_faces, 0])

    # -- oversampling --------------------------------------------------------
    @cached_property
    def _cell_adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        fc = self.grid.face_cells
        inner = fc[:, 1] >= 0
        a, b = fc[inner, 0], fc[inner, 1]
        return np.concatenate([a, b]), np.concatenate([b, a])

    def oversampled_cells(self, ss: int, layers: Optional[int] = None) -> np.ndarray:
        """Cells of ss plus ``layers`` BFS layers of face neighbours."""
        layers = self.oversampling_layers if layers is None else int(layers)
        mask = np.zeros(self.grid.num_cells, dtype=bool)
        mask[self.cells(ss)] = True
        src, dst = self._cell_adjacency
        for _ in range(layers):
            grow = np.zeros_like(mask)
            np.logical_or.at(grow, dst, mask[src])
            mask |= grow
        return np.nonzero(mask)[0]

    def subdomain_diameter(self, ss: int) -> float:
        """The bounding-box diagonal of the subdomain's vertices: its largest
        vertex distance, exact for the axis-aligned rectangular partitions
        built here (the OS2014 residual weighting)."""
        verts = self.grid.cell_vertices[self.cells(ss)].reshape(-1, 2)
        extent = verts.max(axis=0) - verts.min(axis=0)
        return float(np.sqrt(np.sum(extent**2)))

    def __repr__(self):
        return (f"MultiscaleGrid({self.grid!r}, partitions={self.num_partitions}, "
                f"oversampling={self.oversampling_layers})")


@dataclass(frozen=True, eq=False)
class Subgrid:
    """An extracted subdomain grid plus maps back to the parent."""

    grid: Grid
    cell_map: np.ndarray  # [nc_local] parent cell ids
    vertex_map: np.ndarray  # [nv_local] parent vertex ids


def extract_subgrid(parent: Grid, cell_ids: np.ndarray) -> Subgrid:
    """The local grid of a cell subset, its vertices renumbered in ascending
    parent order."""
    cell_ids = np.asarray(cell_ids, dtype=np.int64)
    cells = parent.cells[cell_ids]
    used = np.unique(cells.ravel())
    renumber = np.full(parent.num_vertices, -1, dtype=np.int64)
    renumber[used] = np.arange(len(used))
    local = Grid(vertices=parent.vertices[used], cells=renumber[cells].astype(np.int32),
                 cell_type=parent.cell_type)
    return Subgrid(grid=local, cell_map=cell_ids, vertex_map=used)
