"""Dimension-generic Q1 space and kernels on TensorGrids (d = 1, 2, 3).

Counterpart of ``dune_hdd_tpu/ops/tensor_space.py``: multilinear Q1
elements on axis-aligned boxes, tensor Gauss quadrature, and every kernel
as a batched einsum over the cells on the space's device (the reference's
dimension-templated CG, examples/linearelliptic/cg.cc:19-21,
discretizations/cg.hh:95-419).

The cell kernels run over chunks of at most ``CHUNK_POINTS`` quadrature
points: the reference materializes its transients for the whole grid (the
diffusion tensor as [NC, k, d, d], the flux as [NC, k, nd, d]), which at
128^3 cells and 8 points are 1.2 and 3.2 GB per affine component in
float64.  Each cell's values are the same sums either way; only the
einsum's blocking may differ, in the last bits.

``TensorSpace`` duck-types ``ops.spaces.Space`` where the generic machinery
needs it: ``cell_dofs`` / ``num_dofs`` for the pattern and the scatters,
``device`` / ``dtype`` / ``tensor``, and ``shape_values`` /
``shape_gradients`` for ``ops.norms``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..functions.base import Function
from ..grid.tensor import TensorBoundaryInfo, TensorGrid

__all__ = [
    "CHUNK_POINTS",
    "TensorSpace",
    "tensor_q1_space",
    "q1_values",
    "q1_gradients",
    "tensor_cell_quadrature",
    "tensor_elliptic_cell_matrices",
    "tensor_l2_cell_matrices",
    "tensor_force_cell_vectors",
    "tensor_neumann_functional",
    "tensor_error_norms",
]

#: quadrature points per chunk of the cell kernels (4M: the elliptic flux
#: of a chunk is 0.8 GB in float64 at d = 3)
CHUNK_POINTS = 1 << 22


def _gauss_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(max(n, 1))
    return 0.5 * (x + 1.0), 0.5 * w


def _gauss_tensor(d: int, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor Gauss rule on [0,1]^d exact for (per-axis) degree ``order``:
    points [k, d], weights [k]."""
    n = max((order + 2) // 2, 1)
    x, w = _gauss_1d(n)
    if d == 0:
        return np.zeros((1, 0)), np.ones(1)
    mesh = np.meshgrid(*([x] * d), indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=-1)
    wt = np.ones(pts.shape[0])
    idx = np.unravel_index(np.arange(pts.shape[0]), (len(x),) * d)
    for a in range(d):
        wt = wt * w[idx[a]]
    return pts, wt


def q1_values(rel: torch.Tensor, d: int) -> torch.Tensor:
    """Multilinear Q1 basis at reference coordinates rel [..., d] ->
    [..., 2^d], corner order = TensorGrid.cells (axis 0 = MSB)."""
    vals = []
    for c in range(1 << d):
        v = torch.ones(rel.shape[:-1], dtype=rel.dtype, device=rel.device)
        for a in range(d):
            bit = (c >> (d - 1 - a)) & 1
            v = v * (rel[..., a] if bit else 1.0 - rel[..., a])
        vals.append(v)
    return torch.stack(vals, dim=-1)


def q1_gradients(rel: torch.Tensor, d: int) -> torch.Tensor:
    """Reference gradients [..., 2^d, d]."""
    grads = []
    for c in range(1 << d):
        comp = []
        for a in range(d):
            g = torch.ones(rel.shape[:-1], dtype=rel.dtype, device=rel.device)
            for b in range(d):
                bit = (c >> (d - 1 - b)) & 1
                if b == a:
                    g = g * (1.0 if bit else -1.0)
                else:
                    g = g * (rel[..., b] if bit else 1.0 - rel[..., b])
            comp.append(g)
        grads.append(torch.stack(comp, dim=-1))
    return torch.stack(grads, dim=-2)


@dataclass(frozen=True, eq=False)  # identity hash: caches live in __dict__
class TensorSpace:
    """Q1 CG space on a TensorGrid (cg.hh:140-144 SpaceProvider analog).
    ``device``: the card unless the caller asks for the CPU (raises without
    a card)."""

    grid: TensorGrid
    order: int = 1
    device: torch.device = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def num_dofs(self) -> int:
        return self.grid.num_vertices

    @property
    def cell_dofs(self) -> np.ndarray:
        return self.grid.cells

    @property
    def dim(self) -> int:
        return self.grid.dim

    def tensor(self, array) -> torch.Tensor:
        """A host array as a tensor on the space's device (floats in its dtype)."""
        a = np.asarray(array)
        dtype = self.dtype if a.dtype.kind == "f" else torch.long
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # -- point evaluation (ops.norms surface) -------------------------------
    def _rel(self, qp: torch.Tensor) -> torch.Tensor:
        lo = self.tensor(self.grid.cell_vertices[:, 0, :])
        return (qp - lo[:, None, :]) / self.tensor(self.grid.h)

    def shape_values(self, verts, qp: torch.Tensor) -> torch.Tensor:
        """Q1 values at per-cell physical points qp [NC, k, d] -> [NC, k, nd]
        (``verts`` accepted for the Space interface; the tensor geometry is
        affine per cell, so only the lower corner and h matter)."""
        return q1_values(self._rel(qp), self.dim)

    def shape_gradients(self, verts, qp: torch.Tensor) -> torch.Tensor:
        """Physical gradients [NC, k, nd, d]."""
        return q1_gradients(self._rel(qp), self.dim) / self.tensor(self.grid.h)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TensorSpace(Q1 d={self.dim}, ndofs={self.num_dofs})"


def tensor_q1_space(grid: TensorGrid, device="cuda", dtype=torch.float64) -> TensorSpace:
    """The grid's Q1 space on (device, dtype), one per grid: discretizations
    on one grid share its caches, the volume pattern among them."""
    device = resolve_device(device)
    key = ("_q1_space", str(device), dtype)
    if key not in grid.__dict__:
        grid.__dict__[key] = TensorSpace(grid, device=device, dtype=dtype)
    return grid.__dict__[key]


def _rule(grid: TensorGrid, order: int, device, dtype):
    """Reference points [k, d] (numpy), physical weights [k] (tensor; the
    cell-constant Jacobian folded in)."""
    pts, wts = _gauss_tensor(grid.dim, order)
    qw = torch.as_tensor(wts * float(np.prod(grid.h)), dtype=dtype).to(device)
    return pts, qw


def _cell_points(grid: TensorGrid, pts: np.ndarray, cells: slice, device, dtype):
    """Physical points [C, k, d] of the cells in ``cells``."""
    lo = torch.as_tensor(grid.cell_vertices[cells, 0, :], dtype=dtype).to(device)
    offs = torch.as_tensor(pts * grid.h, dtype=dtype).to(device)
    return lo[:, None, :] + offs[None, :, :]


def _chunks(num_cells: int, k: int):
    step = max(1, CHUNK_POINTS // max(k, 1))
    for start in range(0, num_cells, step):
        yield slice(start, min(start + step, num_cells))


def tensor_cell_quadrature(grid: TensorGrid, order: int, device, dtype=torch.float64):
    """(qp [NC, k, d], qw [k]) physical tensor Gauss rule for the whole
    grid; the weights fold in the (cell-constant) Jacobian determinant.
    Cached per (grid, order, device, dtype)."""
    key = ("_tensor_quadrature", int(order), str(device), dtype)
    if key not in grid.__dict__:
        pts, qw = _rule(grid, order, device, dtype)
        qp = _cell_points(grid, pts, slice(None), device, dtype)
        grid.__dict__[key] = (qp, qw)
    return grid.__dict__[key]


def _ref_shapes(space: TensorSpace, order: int):
    """Reference-rule Q1 values [k, nd] and PHYSICAL gradients [k, nd, d]
    (cell-independent on a tensor grid)."""
    pts, _ = _gauss_tensor(space.dim, order)
    rel = space.tensor(pts)
    return q1_values(rel, space.dim), q1_gradients(rel, space.dim) / space.tensor(space.grid.h)


def tensor_elliptic_cell_matrices(space: TensorSpace, diffusion_factor: Function,
                                  diffusion_tensor: Function,
                                  order: Optional[int] = None) -> torch.Tensor:
    """[NC, nd, nd] local stiffness int lam (kappa grad phi_j).grad phi_i
    (EllipticCG volume kernel, cg.hh:223-247), d-generic."""
    grid = space.grid
    qorder = (order if order is not None
              else diffusion_factor.order + diffusion_tensor.order + 2)
    pts, qw = _rule(grid, qorder, space.device, space.dtype)
    _, grads = _ref_shapes(space, qorder)  # [k, nd, d]
    nd = grads.shape[1]
    out = torch.empty((grid.num_cells, nd, nd), dtype=space.dtype, device=space.device)
    for cells in _chunks(grid.num_cells, len(qw)):
        qp = _cell_points(grid, pts, cells, space.device, space.dtype)
        lam = diffusion_factor(qp)  # [C, k]
        kap = diffusion_tensor(qp)  # [C, k, d, d]
        flux = torch.einsum("ckab,kjb->ckja", kap, grads)
        out[cells] = torch.einsum("ck,kia,ckja->cij", qw * lam, grads, flux)
    return out


def tensor_l2_cell_matrices(space: TensorSpace, weight: Optional[Function] = None,
                            order: Optional[int] = None) -> torch.Tensor:
    grid = space.grid
    worder = weight.order if weight is not None else 0
    qorder = order if order is not None else 2 + worder
    pts, qw = _rule(grid, qorder, space.device, space.dtype)
    vals, _ = _ref_shapes(space, qorder)  # [k, nd]
    if weight is None:
        local = torch.einsum("k,ki,kj->ij", qw, vals, vals)
        return local.expand((grid.num_cells,) + local.shape)
    nd = vals.shape[1]
    out = torch.empty((grid.num_cells, nd, nd), dtype=space.dtype, device=space.device)
    for cells in _chunks(grid.num_cells, len(qw)):
        wq = qw * weight(_cell_points(grid, pts, cells, space.device, space.dtype))
        out[cells] = torch.einsum("ck,ki,kj->cij", wq, vals, vals)
    return out


def tensor_force_cell_vectors(space: TensorSpace, f: Function,
                              order: Optional[int] = None) -> torch.Tensor:
    """[NC, nd] local L2-volume functionals (cg.hh:249-271)."""
    grid = space.grid
    qorder = order if order is not None else f.order + 2
    pts, qw = _rule(grid, qorder, space.device, space.dtype)
    vals, _ = _ref_shapes(space, qorder)
    out = torch.empty((grid.num_cells, vals.shape[1]), dtype=space.dtype, device=space.device)
    for cells in _chunks(grid.num_cells, len(qw)):
        fq = f(_cell_points(grid, pts, cells, space.device, space.dtype))
        out[cells] = torch.einsum("k,ck,ki->ci", qw, fq, vals)
    return out


def tensor_neumann_functional(space: TensorSpace, g: Function, binfo: TensorBoundaryInfo,
                              order: Optional[int] = None) -> torch.Tensor:
    """Global vector of int_e g phi_i over the Neumann facets (Neumann
    L2-face functional, cg.hh:273-289), d-generic: one batched facet
    quadrature per normal axis, added into the vector axis by axis with the
    sorted ``index_add_`` of ``ops.assembly.scatter_cell_vectors``."""
    grid = space.grid
    d = grid.dim
    qorder = order if order is not None else g.order + 2
    facets = grid.boundary_facets
    out = torch.zeros(space.num_dofs, dtype=space.dtype, device=space.device)
    pts, wts = _gauss_tensor(d - 1, qorder)  # [k, d-1], [k]
    vals = q1_values(space.tensor(pts), d - 1)  # [k, 2^(d-1)]
    for a in range(d):
        sel = np.nonzero(binfo.neumann_facets & (facets.axis == a))[0]
        if len(sel) == 0:
            continue
        corners = facets.corners[sel]  # [F, 2^(d-1)]
        lo = grid.vertices[corners[:, 0]]  # [F, d] facet lower corner
        rest = np.delete(np.arange(d), a)
        qp = np.repeat(lo[:, None, :], pts.shape[0], axis=1)
        qp[:, :, rest] = lo[:, None, rest] + pts[None, :, :] * grid.h[rest]
        gq = g(space.tensor(qp))  # [F, k]
        local = torch.einsum("f,k,fk,ki->fi", space.tensor(facets.measure[sel]),
                             space.tensor(wts), gq, vals)
        idx = corners.reshape(-1)
        perm = np.argsort(idx, kind="stable")
        out.index_add_(0, space.tensor(idx[perm]), local.reshape(-1)[space.tensor(perm)])
    return out


def tensor_error_norms(space: TensorSpace, u: torch.Tensor, exact: Function,
                       diffusion_factor: Optional[Function] = None,
                       diffusion_tensor: Optional[Function] = None,
                       order: int = 8) -> dict:
    """``ops.norms.error_norms`` on a TensorSpace, over cell chunks: L2 /
    H1_semi (/ energy if a diffusion is given) norms of (exact - u_h)."""
    grid = space.grid
    pts, qw = _rule(grid, order, space.device, space.dtype)
    vals, grads = _ref_shapes(space, order)  # [k, nd], [k, nd, d]
    sums = {"L2": 0.0, "H1_semi": 0.0, "energy": 0.0}
    with_energy = diffusion_factor is not None or diffusion_tensor is not None
    for cells in _chunks(grid.num_cells, len(qw)):
        qp = _cell_points(grid, pts, cells, space.device, space.dtype)
        u_loc = u[space.tensor(grid.cells[cells])]  # [C, nd]
        e_val = exact(qp) - torch.einsum("ki,ci->ck", vals, u_loc)
        e_grad = exact.gradient(qp) - torch.einsum("kia,ci->cka", grads, u_loc)
        sums["L2"] += float(torch.sum(qw * e_val**2))
        sums["H1_semi"] += float(torch.sum(qw * torch.sum(e_grad**2, dim=-1)))
        if with_energy:
            lam = diffusion_factor(qp) if diffusion_factor is not None else 1.0
            flux = (torch.einsum("ckab,ckb->cka", diffusion_tensor(qp), e_grad)
                    if diffusion_tensor is not None else e_grad)
            sums["energy"] += float(torch.sum(qw * lam * torch.sum(e_grad * flux, dim=-1)))
    out = {"L2": float(np.sqrt(sums["L2"])), "H1_semi": float(np.sqrt(sums["H1_semi"]))}
    if with_energy:
        out["energy"] = float(np.sqrt(sums["energy"]))
    return out
