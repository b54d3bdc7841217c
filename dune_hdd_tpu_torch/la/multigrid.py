"""Geometric multigrid for DG block-ELL operators on refinement hierarchies.

Counterpart of ``dune_hdd_tpu/la/multigrid.py``: a V-cycle over a
newest-vertex-bisection hierarchy.  The DG-P1 prolongation is a per-child
nd x nd interpolation (the children of coarse cell c are the fine cells
k c .. k c + k - 1, so restriction is a reshape-sum), the coarse operators
are Galerkin products P^T A P computed as batched nd x nd products, and the
smoother is damped block Jacobi with a per-level damping from a power
estimate.  A fixed linear operator, so usable as a CG preconditioner.
Plain torch on the operator's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..grid.structured import Grid
from ..ops.spaces import Space, dg_space
from .block_ell import BlockEllMatrix, _block_inverse, block_ell_neighbors

__all__ = ["DGProlongation", "build_dg_prolongation", "galerkin_rap",
           "MultigridHierarchy", "mg_preconditioner"]


@dataclass(frozen=True, eq=False)
class DGProlongation:
    """Coarse-DG -> fine-DG interpolation.  P_cell [NCf, nd, nd]: the
    child's nodal values from its parent's basis; parent [NCf] (host) with
    children contiguous, parent[k c + i] = c."""

    P_cell: torch.Tensor
    parent: np.ndarray
    children_per_parent: int

    @property
    def parent_index(self) -> torch.Tensor:
        """``parent`` on P_cell's device, copied once."""
        if "_parent" not in self.__dict__:
            object.__setattr__(self, "_parent", torch.as_tensor(self.parent).to(
                self.P_cell.device))
        return self.__dict__["_parent"]

    def prolong(self, x_coarse: torch.Tensor) -> torch.Tensor:
        nd = self.P_cell.shape[-1]
        xc = x_coarse.reshape(-1, nd)[self.parent_index]  # [NCf, nd]
        return (self.P_cell * xc[:, None, :]).sum(dim=-1).reshape(-1)

    def restrict(self, r_fine: torch.Tensor) -> torch.Tensor:
        nd = self.P_cell.shape[-1]
        contrib = (self.P_cell * r_fine.reshape(-1, nd, 1)).sum(dim=1)  # P^T r per fine cell
        return contrib.reshape(-1, self.children_per_parent, nd).sum(dim=1).reshape(-1)


def build_dg_prolongation(coarse: Grid, fine: Grid, space_fine: Space) -> DGProlongation:
    """The children of coarse cell c are fine cells k c .. k c + k - 1, for
    bisection (k = 2 per step) and red refinement (k = 4) alike."""
    k = fine.num_cells // coarse.num_cells
    parent = np.repeat(np.arange(coarse.num_cells, dtype=np.int64), k)
    P = space_fine.shape_values(space_fine.tensor(coarse.cell_vertices[parent]),
                                space_fine.tensor(fine.cell_vertices))  # [NCf, nd, nd]
    return DGProlongation(P_cell=P, parent=parent, children_per_parent=k)


def galerkin_rap(A_fine: BlockEllMatrix, prol: DGProlongation,
                 coarse_space: Space) -> BlockEllMatrix:
    """A_coarse = P^T A_fine P in block-ELL layout: the coarse slot of each
    (fine cell, fine slot) is matched on the host, then the batched products
    P_c^T A_cb P_nb are added into their coarse blocks."""
    grid_c = coarse_space.grid
    nc_c, nd = grid_c.num_cells, coarse_space.shape_count
    neighbors_c = block_ell_neighbors(grid_c)
    Bc = neighbors_c.shape[1]
    # coarse slot of (fine cell, fine slot): the position of parent[fine
    # neighbour] in the coarse neighbour list of parent[fine cell]
    pf = prol.parent
    pn = pf[np.asarray(A_fine.neighbors, dtype=np.int64)]  # [NCf, Bf]
    slot = np.full(pn.shape, -1, dtype=np.int64)
    for b in range(Bc):
        match = pn == neighbors_c[pf][:, b][:, None]
        slot[match & (slot < 0)] = b
    if (slot < 0).any():
        raise ValueError("fine neighbour's parent is not a coarse neighbour")
    P = prol.P_cell
    dev = P.device
    M = P.transpose(1, 2)[:, None] @ A_fine.blocks @ P[A_fine.neighbor_index]  # [NCf, Bf, nd, nd]
    rows = torch.as_tensor(np.broadcast_to(pf[:, None], slot.shape).copy()).to(dev)
    blocks_c = A_fine.blocks.new_zeros((nc_c, Bc, nd, nd))
    blocks_c.index_put_((rows, torch.as_tensor(slot).to(dev)), M, accumulate=True)
    return BlockEllMatrix(neighbors_c, blocks_c)


def _block_apply(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Blockwise product of [NC, nd, nd] blocks with a flat cell-major x."""
    return (blocks * x.reshape(-1, 1, blocks.shape[-1])).sum(dim=2).reshape(-1)


def _block_ell_to_dense(A: BlockEllMatrix) -> torch.Tensor:
    nc, B, nd, _ = A.blocks.shape
    rows = np.broadcast_to(np.arange(nc)[:, None, None, None] * nd
                           + np.arange(nd)[None, None, :, None], A.blocks.shape)
    cols = np.broadcast_to(np.asarray(A.neighbors, dtype=np.int64)[:, :, None, None] * nd
                           + np.arange(nd)[None, None, None, :], A.blocks.shape)
    dev = A.blocks.device
    out = A.blocks.new_zeros((nc * nd, nc * nd))
    out.index_put_((torch.as_tensor(rows.reshape(-1)).to(dev),
                    torch.as_tensor(cols.reshape(-1)).to(dev)),
                   A.blocks.reshape(-1), accumulate=True)
    return out


class MultigridHierarchy:
    """Levels fine -> coarse with Galerkin operators, damped block-Jacobi
    smoothing and a linear coarsest solve (dense up to
    ``coarse_dense_limit`` unknowns, else ``coarse_smooth_iters`` sweeps):
    a V-cycle usable directly or as a CG preconditioner."""

    def __init__(self, grids_fine_to_coarse: List[Grid], A_fine: BlockEllMatrix,
                 omega: float = 0.6, pre: int = 2, post: int = 2,
                 coarse_dense_limit: int = 4096, coarse_smooth_iters: int = 30):
        self.grids = grids_fine_to_coarse
        self.omega = omega
        self.pre = pre
        self.post = post
        self.coarse_smooth_iters = coarse_smooth_iters
        dev, dtype = A_fine.blocks.device, A_fine.blocks.dtype
        self.matrices: List[BlockEllMatrix] = [A_fine]
        self.prolongations: List[DGProlongation] = []
        for fine_g, coarse_g in zip(self.grids[:-1], self.grids[1:]):
            prol = build_dg_prolongation(coarse_g, fine_g,
                                         dg_space(fine_g, device=dev, dtype=dtype))
            self.prolongations.append(prol)
            self.matrices.append(galerkin_rap(self.matrices[-1], prol,
                                              dg_space(coarse_g, device=dev, dtype=dtype)))
        self.smoother_inv: List[torch.Tensor] = []
        self.omegas: List[torch.Tensor] = []
        for A in self.matrices:
            inv = _block_inverse(A.diagonal_blocks())
            self.smoother_inv.append(inv)
            # damped block Jacobi is stable for omega < 2 / rho(D^-1 A):
            # estimate rho with 12 power steps, target 0.7 (2 / rho), never
            # above the user's omega
            v = torch.ones(A.num_cells * A.nd, dtype=dtype, device=dev)
            rho = torch.ones((), dtype=dtype, device=dev)
            for _ in range(12):
                w = _block_apply(inv, A.matvec(v))
                rho = torch.linalg.norm(w) / torch.clamp(torch.linalg.norm(v), min=1e-30)
                v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
            self.omegas.append(torch.clamp(1.4 / torch.clamp(rho, min=1e-6), max=omega))
        n_coarse = self.matrices[-1].num_cells * self.matrices[-1].nd
        # the coarsest solve stays linear so the V-cycle is a fixed operator
        self.coarse_dense = (_block_ell_to_dense(self.matrices[-1])
                             if n_coarse <= coarse_dense_limit else None)

    def _smooth(self, lvl: int, A: BlockEllMatrix, x, b, iterations: int):
        inv, omega = self.smoother_inv[lvl], self.omegas[lvl]
        for _ in range(iterations):
            r = b - A.matvec(x)
            x = x + omega * _block_apply(inv, r)
        return x

    def v_cycle(self, b: torch.Tensor, x: Optional[torch.Tensor] = None,
                lvl: int = 0) -> torch.Tensor:
        A = self.matrices[lvl]
        if x is None:
            x = torch.zeros_like(b)
        if lvl == len(self.matrices) - 1:
            if self.coarse_dense is not None:
                return torch.linalg.solve(self.coarse_dense, b)
            return self._smooth(lvl, A, x, b, self.coarse_smooth_iters)
        x = self._smooth(lvl, A, x, b, self.pre)
        rc = self.prolongations[lvl].restrict(b - A.matvec(x))
        x = x + self.prolongations[lvl].prolong(self.v_cycle(rc, None, lvl + 1))
        return self._smooth(lvl, A, x, b, self.post)


def mg_preconditioner(hierarchy: MultigridHierarchy) -> Callable:
    """One V-cycle from zero: ``hierarchy.v_cycle`` (its ``__self__`` is
    the hierarchy)."""
    return hierarchy.v_cycle
