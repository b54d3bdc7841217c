"""Block-ELL pieces: the operator in the structured cell numbering, the
cell-neighbour table (host numpy) and the batched closed-form 3x3 inverse.

Counterpart of ``StructuredBlockEll``, ``block_ell_neighbors`` and
``inv3x3`` in ``dune_hdd_tpu/la/block_ell.py`` (``from_block_ell`` waits
for ``BlockEllMatrix``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.structured_spmv import structured_neighbor_fields, structured_spmv

__all__ = ["StructuredBlockEll", "block_ell_neighbors", "inv3x3"]


class StructuredBlockEll:
    """Block-ELL operator in the bandwidth-ordered structured numbering:
    cells subclass-major, slots geometric (0 = self, 1 = hypotenuse,
    2 = vertical face, 3 = horizontal face).  blocks [nc, 4, nd, nd];
    neighbors [nc, 4] host table kept for set-up code; offsets: 8 x 3 flat
    cell offsets of each (subclass, slot) neighbour, read modulo nc
    (wrapped reads meet zero blocks at the domain boundary).

    The SpMV reads the blocks as SoA planes [4, nd, nd, nc], made once here
    (no copy when ``blocks`` is already a permuted view of such planes)."""

    def __init__(self, neighbors, blocks: torch.Tensor, offsets):
        self.neighbors = neighbors
        self.blocks = blocks
        self.offsets = tuple(tuple(int(o) for o in row) for row in offsets)
        self.planes = blocks.permute(1, 2, 3, 0).contiguous()

    @property
    def num_cells(self) -> int:
        return self.blocks.shape[0]

    @property
    def nd(self) -> int:
        return self.blocks.shape[-1]

    def with_blocks(self, blocks: torch.Tensor) -> "StructuredBlockEll":
        return StructuredBlockEll(self.neighbors, blocks, self.offsets)

    def neighbor_fields(self, xc: torch.Tensor) -> torch.Tensor:
        """[nc, 4, nd]: x at self and at each geometric-slot neighbour."""
        return structured_neighbor_fields(xc, self.offsets)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x [nc * nd] cell-major -> A x, through ``structured_spmv``."""
        return structured_spmv(self.planes, x.contiguous(), self.offsets)

    def diagonal_blocks(self) -> torch.Tensor:
        return self.blocks[:, 0]


def block_ell_neighbors(grid) -> np.ndarray:
    """[NC, 1+nfc] neighbor table (slot 0 = self, padded slots = self)."""
    nc, nfc = grid.num_cells, grid.faces_per_cell
    neighbors = np.tile(np.arange(nc, dtype=np.int32)[:, None], (1, 1 + nfc))
    fi = np.nonzero(grid.interior_faces)[0]
    cin, cout = grid.face_cells[fi, 0], grid.face_cells[fi, 1]
    li, lo = grid.face_local[fi, 0], grid.face_local[fi, 1]
    neighbors[cin, 1 + li] = cout
    neighbors[cout, 1 + lo] = cin
    return neighbors


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate/det), m [..., 3, 3].

    Near-singular blocks (f32 high-contrast operators) get a diagonally
    scaled identity instead of inf/nan."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    scale = torch.clamp(m.abs().amax(dim=(-2, -1)), min=1e-30)
    tiny = det.abs() < 1e-12 * scale**3
    safe_det = torch.where(tiny, torch.ones_like(det), det)
    inv = adj / safe_det[..., None, None]
    fallback = torch.eye(3, dtype=m.dtype, device=m.device) / scale[..., None, None]
    return torch.where(tiny[..., None, None], fallback, inv)
