"""Block-ELL operators for DG spaces.

Counterpart of ``dune_hdd_tpu/la/block_ell.py``.  A DG-P1 SWIPDG operator
couples each cell only with itself and its face neighbours, so the matrix
is [NC, 1+nfc] dense nd x nd blocks.  ``BlockEllMatrix.matvec`` is a row
gather of [NC, B, nd] plus one batched einsum (plain torch, as the
reference leaves it to XLA); ``StructuredBlockEll`` is the same operator in
the bandwidth-ordered structured numbering, applied by the hand-written
``structured_spmv`` kernel; ``block_cg`` is block-Jacobi PCG on the device.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels.structured_spmv import structured_neighbor_fields, structured_spmv
from ..utils.logging import timed
from ..utils.profiling import upload

__all__ = [
    "BlockEllMatrix",
    "StructuredBlockEll",
    "block_ell_neighbors",
    "block_ell_from_sparse",
    "build_block_ell",
    "block_jacobi_preconditioner",
    "symmetric_diagonal_scaling",
    "block_cg",
    "inv3x3",
]

CHECK_EVERY = 8  # iterations between host reads of block_cg's stopping test


class BlockEllMatrix:
    """neighbors [NC, B] host table (slot 0 = self; padded slots point at
    self with a zero block), blocks [NC, B, nd, nd] on the device."""

    def __init__(self, neighbors: np.ndarray, blocks: torch.Tensor,
                 neighbors_on_device: Optional[torch.Tensor] = None):
        self.neighbors = neighbors
        self.blocks = blocks
        self._nbr = neighbors_on_device

    @property
    def num_cells(self) -> int:
        return self.blocks.shape[0]

    @property
    def nd(self) -> int:
        return self.blocks.shape[-1]

    @property
    def neighbor_index(self) -> torch.Tensor:
        """The neighbour table on the blocks' device, copied once."""
        if self._nbr is None or self._nbr.device != self.blocks.device:
            self._nbr = torch.as_tensor(np.asarray(self.neighbors, dtype=np.int64)).to(
                self.blocks.device)
        return self._nbr

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        # one broadcast product and one two-axis sum: torch.einsum would
        # permute the blocks and run NC tiny batched GEMMs
        xg = x.reshape(self.num_cells, self.nd)[self.neighbor_index]  # [NC, B, nd]
        return (self.blocks * xg[:, :, None, :]).sum(dim=(1, 3)).reshape(-1)

    __matmul__ = matvec

    def diagonal_blocks(self) -> torch.Tensor:
        return self.blocks[:, 0]

    def with_blocks(self, blocks: torch.Tensor) -> "BlockEllMatrix":
        return BlockEllMatrix(self.neighbors, blocks, self._nbr)

    def __mul__(self, s):
        return self.with_blocks(self.blocks * s)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, BlockEllMatrix):
            return self.with_blocks(self.blocks + other.blocks)
        return NotImplemented


class StructuredBlockEll:
    """Block-ELL operator in the bandwidth-ordered structured numbering:
    cells subclass-major, slots geometric (0 = self, 1 = hypotenuse,
    2 = vertical face, 3 = horizontal face).  blocks [nc, 4, nd, nd];
    neighbors [nc, 4] host table kept for set-up code; offsets: 8 x 3 flat
    cell offsets of each (subclass, slot) neighbour, read modulo nc
    (wrapped reads meet zero blocks at the domain boundary).

    The SpMV ``spmv(planes, x, offsets)`` (the hand-written kernel unless a
    caller substitutes its plain version) reads the blocks as SoA planes
    [4, nd, nd, nc], made once here (no copy when ``blocks`` is already a
    permuted view of such planes)."""

    def __init__(self, neighbors, blocks: torch.Tensor, offsets,
                 spmv: Callable = structured_spmv):
        self.neighbors = neighbors
        self.blocks = blocks
        self.offsets = tuple(tuple(int(o) for o in row) for row in offsets)
        self.planes = blocks.permute(1, 2, 3, 0).contiguous()
        self.spmv = spmv

    @property
    def num_cells(self) -> int:
        return self.blocks.shape[0]

    @property
    def nd(self) -> int:
        return self.blocks.shape[-1]

    def with_blocks(self, blocks: torch.Tensor) -> "StructuredBlockEll":
        return StructuredBlockEll(self.neighbors, blocks, self.offsets, self.spmv)

    @classmethod
    def from_block_ell(cls, A: BlockEllMatrix, order,
                       spmv: Callable = structured_spmv) -> "StructuredBlockEll":
        """Permute a BlockEllMatrix into structured order (one gather of the
        block array)."""
        cell_idx, slot_idx = _structured_gather(A, order)
        dev = A.blocks.device
        blocks = A.blocks[upload(cell_idx, dev), upload(slot_idx, dev)]
        neighbors = np.asarray(order.perm)[np.asarray(A.neighbors)[cell_idx, slot_idx]]
        return cls(neighbors.astype(np.int32), blocks, order.offsets, spmv)

    def neighbor_fields(self, xc: torch.Tensor) -> torch.Tensor:
        """[nc, 4, nd]: x at self and at each geometric-slot neighbour."""
        return structured_neighbor_fields(xc, self.offsets)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x [nc * nd] cell-major -> A x, through ``spmv``."""
        return self.spmv(self.planes, x.contiguous(), self.offsets)

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


def _structured_gather(A: BlockEllMatrix, order) -> Tuple[np.ndarray, np.ndarray]:
    """(cell [NC, 1], slot [NC, 4]) host indices: the original cell and slot
    feeding each (new cell, geometric slot) of the structured numbering."""
    nc, B = A.blocks.shape[:2]
    if B != 4:
        raise ValueError("the structured layout is for triangle grids (3 faces)")
    slot_idx = np.concatenate([np.zeros((nc, 1), dtype=np.int64),
                               1 + np.asarray(order.slot_source, dtype=np.int64)], axis=1)
    return np.asarray(order.inv)[:, None], slot_idx


def block_ell_from_sparse(space, sparse_matrix) -> BlockEllMatrix:
    """A DG SparseMatrix (scalar ELL, cell-block sparsity) in block-ELL
    layout.  The slot -> (cell, slot, i, j) map depends on the pattern only:
    it is found on the host once per pattern (a loop over the slots) and
    kept on the pattern, so each matrix is one scatter of its values."""
    p = sparse_matrix.pattern
    nd = space.shape_count
    cache = p.__dict__.setdefault("_block_ell_map", {})
    if "flat" not in cache:
        with timed("block_ell_from_sparse.slot_map"):
            neighbors = block_ell_neighbors(space.grid)
            B = neighbors.shape[1]
            rows = p.slot_rows.astype(np.int64)
            cols = p.slot_cols.astype(np.int64)
            c, i = rows // nd, rows % nd
            n, j = cols // nd, cols % nd
            b = np.zeros(len(rows), dtype=np.int64)
            found = np.zeros(len(rows), dtype=bool)
            # the first matching slot; self-couplings go to slot 0
            for bb in range(B):
                match = (~found) & (neighbors[c, bb] == n) & ((bb == 0) == (c == n))
                b[match] = bb
                found |= match
            if not found.all():
                raise ValueError("sparse matrix does not fit the cell-neighbour stencil")
            cache["neighbors"] = neighbors
            cache["flat"] = ((c * B + b) * nd + i) * nd + j
    dev = sparse_matrix.values.device
    key = str(dev)
    if key not in cache:
        cache[key] = (torch.as_tensor(cache["flat"]).to(dev),
                      torch.as_tensor(cache["neighbors"].astype(np.int64)).to(dev))
    flat, nbr = cache[key]
    neighbors = cache["neighbors"]
    nc, B = neighbors.shape
    blocks = sparse_matrix.values.new_zeros(nc * B * nd * nd)
    blocks[flat] = sparse_matrix.values
    return BlockEllMatrix(neighbors, blocks.reshape(nc, B, nd, nd), nbr)


def build_block_ell(space, vol_local: torch.Tensor, int_blocks: torch.Tensor,
                    bnd_blocks: torch.Tensor, interior_faces: np.ndarray,
                    boundary_faces: np.ndarray) -> BlockEllMatrix:
    """Assemble SWIPDG volume/face blocks into block-ELL layout.  The self
    blocks sum with ``index_add_``: atomics on CUDA, so the order of the up
    to 1 + nfc terms per self block varies from run to run (equal within a
    few ulps, not bitwise repeatable)."""
    grid = space.grid
    nc, nd, nfc = grid.num_cells, space.shape_count, grid.faces_per_cell
    B = 1 + nfc
    fi = np.asarray(interior_faces)
    fb = np.asarray(boundary_faces)
    dev = vol_local.device

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)

    neighbors = np.tile(np.arange(nc, dtype=np.int32)[:, None], (1, B))
    blocks = vol_local.new_zeros((nc, B, nd, nd))
    blocks[:, 0] += vol_local
    if len(fi):
        cin, cout = grid.face_cells[fi, 0], grid.face_cells[fi, 1]
        li, lo = grid.face_local[fi, 0], grid.face_local[fi, 1]
        neighbors[cin, 1 + li] = cout
        neighbors[cout, 1 + lo] = cin
        diag = blocks[:, 0]
        diag.index_add_(0, t(cin), int_blocks[:, 0, 0])
        diag.index_add_(0, t(cout), int_blocks[:, 1, 1])
        blocks[t(cin), t(1 + li)] = int_blocks[:, 0, 1]
        blocks[t(cout), t(1 + lo)] = int_blocks[:, 1, 0]
    if len(fb):
        blocks[:, 0].index_add_(0, t(grid.face_cells[fb, 0]), bnd_blocks)
    return BlockEllMatrix(neighbors, blocks)


def _block_inverse(blocks: torch.Tensor) -> torch.Tensor:
    if blocks.shape[-1] == 3:
        return inv3x3(blocks)
    return torch.linalg.inv(blocks)


def block_jacobi_preconditioner(matrix: BlockEllMatrix) -> Callable:
    """Inverse of the nd x nd diagonal blocks, applied blockwise."""
    inv = _block_inverse(matrix.diagonal_blocks())  # [NC, nd, nd]
    nd = matrix.nd

    def apply(r):
        return (inv * r.reshape(-1, 1, nd)).sum(dim=2).reshape(-1)

    return apply


def symmetric_diagonal_scaling(matrix: BlockEllMatrix, b: torch.Tensor):
    """(A, b) -> (S A S, S b, S) with S = diag(A)^{-1/2} as a vector."""
    diag = torch.diagonal(matrix.diagonal_blocks(), dim1=-2, dim2=-1)  # [NC, nd]
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    s_rows = s[:, None, :, None]  # scale test index i of cell c
    s_cols = s[matrix.neighbor_index][:, :, None, :]  # ansatz index j of neighbour
    s_flat = s.reshape(-1)
    return matrix.with_blocks(matrix.blocks * s_rows * s_cols), b * s_flat, s_flat


def block_cg(matrix: BlockEllMatrix, b: torch.Tensor, tol: float = 1e-6, maxiter: int = 500,
             M: Optional[Callable] = None,
             x0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Preconditioned CG on a BlockEllMatrix (block-Jacobi by default) with
    the reference's stopping test ||r||^2 > (tol max(||b||, 1e-30))^2 before
    every iteration, read on the host every ``CHECK_EVERY`` iterations
    (iterations past the stop are masked to no-ops on the device).  Returns
    (x, relative recurrence residual, iterations)."""
    if M is None:
        M = block_jacobi_preconditioner(matrix)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matrix.matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.clamp(torch.linalg.norm(b), min=1e-30)
    atol2 = (tol * bnorm) ** 2
    active = torch.dot(r, r) > atol2
    iters = torch.zeros((), dtype=torch.long, device=b.device)
    zero = b.new_zeros(())
    for k in range(int(maxiter)):
        if k % CHECK_EVERY == 0 and not bool(active):
            break
        ap = matrix.matvec(p)
        alpha = torch.where(active, rz / torch.dot(p, ap), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + torch.where(active, rz_new / rz, zero) * p
        rz = rz_new
        iters = iters + active
        active = active & (torch.dot(r, r) > atol2)
    return x, torch.linalg.norm(r) / bnorm, int(iters)


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
