"""Bandwidth-ordered cell numbering for uniformly bisected cube grids (host
numpy).

Counterpart of ``dune_hdd_tpu/grid/structured_order.py``.  For grids from
``alu_cube_grid`` with an even number of bisections every cell is an
axis-aligned right triangle on a regular (NX, NY) half-quad lattice, and the
cells fall into 8 congruence subclasses (4 right-angle-corner orientations x
lattice-row parity).  Ordering cells subclass-major, then row-major on each
subclass's dense (KY, KX) lattice makes every face-neighbour relation a
constant offset per (subclass, geometric slot): the SpMV neighbour access
becomes a fixed lattice shift, and the SPE10 macro-cell aggregation a
reshape-sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..la.block_ell import block_ell_neighbors
from .structured import TRIANGLE, Grid

__all__ = ["StructuredOrder", "structured_cell_order"]

_EPS = 1e-12


@dataclass(frozen=True)
class StructuredOrder:
    """perm[old] = new cell id, inv[new] = old cell id.
    offsets[k, s]: new-id offset of the geo-slot-s neighbour of any cell in
    subclass k (mod NC; out-of-domain wraps land on zero blocks).
    slot_source[new, s]: local face index feeding geo slot s.
    lattice = (KY, KX): per-subclass dense lattice shape."""

    perm: np.ndarray
    inv: np.ndarray
    offsets: np.ndarray  # [8, 3] int64
    slot_source: np.ndarray  # [NC, 3] int8, in NEW cell order
    lattice: Tuple[int, int]
    nxy: Tuple[int, int]  # half-quad lattice (NX, NY)
    lower: Tuple[float, float]
    upper: Tuple[float, float]

    @property
    def num_cells(self) -> int:
        return self.perm.shape[0]

    def aggregate_plan(self, macro_shape: Tuple[int, int]) -> Optional[Tuple[int, int]]:
        """(fy, fx): fine half-quads per macro cell along each axis of each
        subclass lattice, or None if the (mx, my) macro cells don't tile
        the lattice."""
        mx, my = int(macro_shape[0]), int(macro_shape[1])
        ky, kx = self.lattice
        if kx % mx or ky % my:
            return None
        return ky // my, kx // mx


def _classify(grid: Grid, lower: np.ndarray, upper: np.ndarray):
    """(IX, IY, cls4, (NX, NY)) on the half-quad lattice, or None if the grid
    is not structured."""
    v = grid.cell_vertices  # [NC, 3, 2]
    nc = grid.num_cells
    # all cells must be congruent axis-aligned right triangles
    corner = np.full(nc, -1, dtype=np.int64)
    for i in range(3):
        e1 = v[:, (i + 1) % 3] - v[:, i]
        e2 = v[:, (i + 2) % 3] - v[:, i]
        ax1 = (np.abs(e1[:, 0]) < _EPS) | (np.abs(e1[:, 1]) < _EPS)
        ax2 = (np.abs(e2[:, 0]) < _EPS) | (np.abs(e2[:, 1]) < _EPS)
        corner[ax1 & ax2] = i
    if (corner < 0).any():
        return None
    # leg lengths per axis: horizontal faces have length hx, vertical hy
    e01 = v[:, 1] - v[:, 0]
    e12 = v[:, 2] - v[:, 1]
    e20 = v[:, 0] - v[:, 2]
    hx = hy = None
    for e in (e01, e12, e20):
        horz = np.abs(e[:, 1]) < _EPS
        vert = np.abs(e[:, 0]) < _EPS
        if horz.any():
            lens = np.abs(e[horz, 0])
            if hx is None:
                hx = lens[0]
            if not np.allclose(lens, hx, rtol=1e-9):
                return None
        if vert.any():
            lens = np.abs(e[vert, 1])
            if hy is None:
                hy = lens[0]
            if not np.allclose(lens, hy, rtol=1e-9):
                return None
    if hx is None or hy is None:
        return None
    ext = upper - lower
    nxy = ext / np.array([hx, hy])
    NX, NY = int(round(nxy[0])), int(round(nxy[1]))
    if (abs(nxy[0] - NX) > 1e-6 or abs(nxy[1] - NY) > 1e-6
            or NX * NY * 2 != nc or NX % 2 or NY % 2):
        return None
    cent = grid.cell_centroids
    h = ext / np.array([NX, NY])
    quad = np.floor((cent - lower) / h).astype(np.int64)
    IX = np.clip(quad[:, 0], 0, NX - 1)
    IY = np.clip(quad[:, 1], 0, NY - 1)
    rc = v[np.arange(nc), corner]
    d = rc - cent
    cls4 = (d[:, 0] > 0).astype(np.int64) + 2 * (d[:, 1] > 0).astype(np.int64)
    return IX, IY, cls4, (NX, NY)


def structured_cell_order(grid: Grid, lower=None, upper=None) -> Optional[StructuredOrder]:
    """Derive the structured numbering, or None if the grid doesn't qualify
    (non-uniform, odd number of bisections, or any neighbour offset turning
    out non-constant — all checked, never assumed)."""
    if grid.cell_type != TRIANGLE:
        return None
    lo, hi = grid.bounding_box
    lower = np.asarray(lower if lower is not None else lo, dtype=float)
    upper = np.asarray(upper if upper is not None else hi, dtype=float)
    out = _classify(grid, lower, upper)
    if out is None:
        return None
    IX, IY, cls4, (NX, NY) = out
    nc = grid.num_cells
    sub = cls4 * 2 + (IY % 2)
    KX, KY = NX // 2, NY // 2
    J, IY2 = IX // 2, IY // 2
    perm = np.full(nc, -1, dtype=np.int64)
    base = 0
    for k in range(8):
        sel = np.nonzero(sub == k)[0]
        if len(sel) != nc // 8:
            return None
        key = IY2[sel] * KX + J[sel]
        if len(np.unique(key)) != len(sel):
            return None
        perm[sel[np.argsort(key)]] = base + np.arange(len(sel))
        base += len(sel)

    # geometric slot of each local face: 0 = hypotenuse (diagonal),
    # 1 = vertical face (normal along x), 2 = horizontal face (normal along y)
    v = grid.cell_vertices
    geo = np.empty((nc, 3), dtype=np.int64)
    for kf in range(3):
        e = v[:, (kf + 1) % 3] - v[:, kf]
        vert = np.abs(e[:, 0]) < _EPS
        horz = np.abs(e[:, 1]) < _EPS
        geo[:, kf] = np.where(vert, 1, np.where(horz, 2, 0))
    if not (np.sort(geo, axis=1) == np.array([0, 1, 2])).all():
        return None

    nbr = block_ell_neighbors(grid)  # [NC, 4], slot 0 self; 1+kf local face kf
    self_mask = nbr[:, 1:] == np.arange(nc, dtype=nbr.dtype)[:, None]
    nbr_new = perm[nbr]
    cnew = perm[np.arange(nc)]

    offsets = np.zeros((8, 3), dtype=np.int64)
    for k in range(8):
        sel = sub == k
        for gs in range(3):
            offs = []
            for kf in range(3):
                m = sel & (geo[:, kf] == gs) & ~self_mask[:, kf]
                if m.any():
                    offs.append(np.unique(nbr_new[m, 1 + kf] - cnew[m]))
            if not offs:
                return None
            u = np.unique(np.concatenate(offs))
            if len(u) != 1:
                return None
            offsets[k, gs] = u[0]

    inv = np.argsort(perm)
    slot_source = np.empty((nc, 3), dtype=np.int8)
    for gs in range(3):
        # each cell has exactly one face per geo slot (checked above)
        src = np.argmax(geo == gs, axis=1)
        slot_source[cnew, gs] = src
    return StructuredOrder(
        perm=perm, inv=inv, offsets=offsets, slot_source=slot_source,
        lattice=(KY, KX), nxy=(NX, NY),
        lower=(float(lower[0]), float(lower[1])),
        upper=(float(upper[0]), float(upper[1])),
    )
