"""Boundary classification: which boundary faces are Dirichlet, which
Neumann (host numpy).  Counterpart of ``dune_hdd_tpu/grid/boundaryinfo.py``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .structured import Grid

__all__ = ["BoundaryInfo", "boundary_id_faces", "make_boundary_info"]


class BoundaryInfo:
    """Masks over faces: dirichlet_faces & neumann_faces partition the
    boundary faces of a grid."""

    def __init__(self, grid: Grid, dirichlet_faces: np.ndarray, neumann_faces: np.ndarray):
        self.grid = grid
        self.dirichlet_faces = dirichlet_faces
        self.neumann_faces = neumann_faces

    @property
    def dirichlet_vertices(self) -> np.ndarray:
        mask = np.zeros(self.grid.num_vertices, dtype=bool)
        mask[self.grid.faces[self.dirichlet_faces].ravel()] = True
        return mask

    @property
    def has_dirichlet(self) -> bool:
        return bool(self.dirichlet_faces.any())

    @property
    def has_neumann(self) -> bool:
        return bool(self.neumann_faces.any())


def _normal_direction_mask(grid: Grid, directions: Sequence[Sequence[float]],
                           tol: float = 1e-10) -> np.ndarray:
    """Boundary faces whose outward normal matches any given direction."""
    mask = np.zeros(grid.num_faces, dtype=bool)
    normals = grid.face_normals
    bnd = grid.boundary_faces
    for d in directions:
        d = np.asarray(d, dtype=float)
        d = d / np.linalg.norm(d)
        mask |= bnd & (np.abs(normals @ d - 1.0) < tol)
    return mask


def boundary_id_faces(grid: Grid) -> np.ndarray:
    """Per-face boundary id [NF] (0 on interior faces): the DUNE cube-grid
    convention, one id per axis-aligned side counted (min, max) per
    dimension (2D: left=1, right=2, bottom=3, top=4).  A grid may carry its
    own ``boundary_ids``."""
    custom = getattr(grid, "boundary_ids", None)
    if custom is not None:
        return np.asarray(custom)
    ids = np.zeros(grid.num_faces, dtype=np.int64)
    bnd = grid.boundary_faces
    normals = grid.face_normals
    for axis in range(normals.shape[1]):
        for sign, off in ((-1.0, 1), (1.0, 2)):
            ids[bnd & (np.abs(normals[:, axis] - sign) < 1e-10)] = 2 * axis + off
    return ids


def _parse_ids(value) -> set:
    """An id list, a single int, or a space/comma-separated string."""
    if value is None:
        return set()
    if isinstance(value, str):
        value = value.replace(",", " ").split()
    elif np.isscalar(value):
        value = [value]
    return {int(v) for v in value}


def make_boundary_info(grid: Grid, config: Optional[Mapping] = None) -> BoundaryInfo:
    """config["type"] in {"stuff.grid.boundaryinfo.alldirichlet" (default),
    "...allneumann", "...normalbased", "...idbased"}.  Normal-based takes
    ``default`` plus ``dirichlet``/``neumann`` lists of outward normals;
    id-based takes ``dirichlet``/``neumann`` boundary-id lists plus
    ``default`` for unlisted ids."""
    cfg = dict(config or {})
    t = str(cfg.get("type", "stuff.grid.boundaryinfo.alldirichlet")).lower()
    bnd = grid.boundary_faces
    none = np.zeros(grid.num_faces, dtype=bool)
    if t.endswith("alldirichlet"):
        return BoundaryInfo(grid, bnd.copy(), none)
    if t.endswith("allneumann"):
        return BoundaryInfo(grid, none, bnd.copy())
    if t.endswith("normalbased"):
        default = str(cfg.get("default", "dirichlet")).lower()
        neu = _normal_direction_mask(grid, cfg.get("neumann", []))
        dir_ = _normal_direction_mask(grid, cfg.get("dirichlet", []))
        if default.startswith("dirichlet"):
            dir_ = bnd & ~neu | dir_
        else:
            neu = bnd & ~dir_ | neu
        return BoundaryInfo(grid, dir_ & bnd, neu & bnd)
    if t.endswith("idbased"):
        default = str(cfg.get("default", "dirichlet")).lower()
        ids = boundary_id_faces(grid)
        dir_ids = _parse_ids(cfg.get("dirichlet"))
        neu_ids = _parse_ids(cfg.get("neumann"))
        overlap = dir_ids & neu_ids
        if overlap:
            raise ValueError(
                f"boundary ids {sorted(overlap)} listed as both dirichlet and neumann")
        dir_ = bnd & np.isin(ids, sorted(dir_ids))
        neu = bnd & np.isin(ids, sorted(neu_ids))
        rest = bnd & ~dir_ & ~neu
        if default.startswith("dirichlet"):
            dir_ |= rest
        else:
            neu |= rest
        return BoundaryInfo(grid, dir_, neu)
    raise ValueError(f"unknown boundary info type {t!r}")
