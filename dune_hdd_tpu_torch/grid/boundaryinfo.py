"""Boundary classification (host numpy).

Counterpart of ``dune_hdd_tpu/grid/boundaryinfo.py`` for the one boundary
type the SPE10 bench uses: every boundary face is Dirichlet.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .structured import Grid

__all__ = ["BoundaryInfo", "make_boundary_info"]


class BoundaryInfo:
    """Masks over faces: dirichlet_faces & neumann_faces partition the
    boundary faces of a grid."""

    def __init__(self, grid: Grid, dirichlet_faces: np.ndarray, neumann_faces: np.ndarray):
        self.grid = grid
        self.dirichlet_faces = dirichlet_faces
        self.neumann_faces = neumann_faces


def make_boundary_info(grid: Grid, config: Optional[Mapping] = None) -> BoundaryInfo:
    """config["type"] must be "stuff.grid.boundaryinfo.alldirichlet" (the
    default); other types are not ported."""
    t = str(dict(config or {}).get("type", "stuff.grid.boundaryinfo.alldirichlet")).lower()
    if not t.endswith("alldirichlet"):
        raise ValueError(f"unsupported boundary info type {t!r}")
    return BoundaryInfo(grid, grid.boundary_faces.copy(),
                        np.zeros(grid.num_faces, dtype=bool))
