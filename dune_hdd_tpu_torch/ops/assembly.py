"""Batched element/face integral kernels + global assembly.

Counterpart of ``dune_hdd_tpu/ops/assembly.py``.  Every integral is an
einsum over static cell/face batches on the space's device; global matrices
materialize through ``SparsityPattern.assemble`` (a sorted segment
reduction, no scatter contention), and global vectors through
``scatter_cell_vectors``.  Quadrature arrays and shape values are cached
per (grid or space, order, device, dtype).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..functions.base import Function
from ..grid.structured import INTERVAL, TRIANGLE, Grid
from ..la.sparse import SparseMatrix, SparsityPattern, build_pattern
from ..parameters import ProductFunctional
from .quadrature import edge_rule, quad_rule, tri_rule
from .spaces import Space

__all__ = [
    "cell_quadrature",
    "face_quadrature",
    "volume_pattern",
    "elliptic_cell_matrices",
    "l2_cell_matrices",
    "force_cell_vectors",
    "boundary_face_functional",
    "boundary_face_l2_matrices",
    "scatter_cell_vectors",
    "assemble_cell_matrix",
    "diffusion_pairs",
]


def _t(array, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(array), dtype=dtype).to(device)


def cell_quadrature(grid: Grid, order: int, device, dtype=torch.float64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Physical quadrature: points [NC, k, dim], weights [NC, k] (incl.
    |J|), cached per (grid, order, device, dtype); on a TensorGrid the
    weights are [k] (``ops.tensor_space.tensor_cell_quadrature``)."""
    from ..grid.tensor import TensorGrid

    if isinstance(grid, TensorGrid):  # d-generic Q1 path: weights [k]
        from .tensor_space import tensor_cell_quadrature

        return tensor_cell_quadrature(grid, order, device, dtype)
    key = ("_cell_quadrature", int(order), str(device), dtype)
    cached = grid.__dict__.get(key)
    if cached is not None:
        return cached
    verts = _t(grid.cell_vertices, device, dtype)
    if grid.cell_type == INTERVAL:
        t, w = edge_rule(order)
        t, w = _t(t, device, dtype), _t(w, device, dtype)
        v0, v1 = verts[:, 0, :], verts[:, 1, :]
        qp = v0[:, None, :] + t[None, :, None] * (v1 - v0)[:, None, :]
        qw = w[None, :] * torch.abs((v1 - v0)[:, 0])[:, None]
    elif grid.cell_type == TRIANGLE:
        ref, w = tri_rule(order)
        ref, w = _t(ref, device, dtype), _t(w, device, dtype)
        v0 = verts[:, 0, :]
        e1 = verts[:, 1, :] - v0
        e2 = verts[:, 2, :] - v0
        qp = (v0[:, None, :] + ref[None, :, 0:1] * e1[:, None, :]
              + ref[None, :, 1:2] * e2[:, None, :])
        detj = torch.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        qw = 2.0 * w[None, :] * detj[:, None] * 0.5  # w sums to 1/2; |J| = 2*area
    else:  # axis-aligned rectangles
        ref, w = quad_rule(order)
        ref, w = _t(ref, device, dtype), _t(w, device, dtype)
        lo = verts[:, 0, :]
        ext = verts[:, 2, :] - lo
        qp = lo[:, None, :] + ref[None, :, :] * ext[:, None, :]
        qw = w[None, :] * torch.abs(ext[:, 0] * ext[:, 1])[:, None]
    grid.__dict__[key] = (qp, qw)
    return qp, qw


def face_quadrature(grid: Grid, order: int, device, dtype=torch.float64,
                    face_ids: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points [F, k, dim] and weights [F, k] (incl. face length) on faces.
    Intervals: a face is a point, its integral a point evaluation (weight 1;
    the penalty length scale lives in ``grid.face_volumes``)."""
    fv = grid.face_vertices if face_ids is None else grid.face_vertices[np.asarray(face_ids)]
    fv = _t(fv, device, dtype)
    if grid.cell_type == INTERVAL:
        return fv[:, :1, :], fv.new_ones(fv.shape[:1] + (1,))
    t, w = edge_rule(order)
    t, w = _t(t, device, dtype), _t(w, device, dtype)
    a, b = fv[:, 0, :], fv[:, 1, :]
    qp = a[:, None, :] + t[None, :, None] * (b - a)[:, None, :]
    length = torch.linalg.norm(b - a, dim=-1)
    return qp, w[None, :] * length[:, None]


# -- local (per-cell) kernels ----------------------------------------------


def _cell_quadrature(space: Space, order: int):
    return cell_quadrature(space.grid, order, space.device, space.dtype)


def cell_shape_values(space: Space, qorder: int) -> torch.Tensor:
    """[NC, k, nd] basis values at the cell quadrature points (cached)."""
    key = ("_cell_shape_values", int(qorder))
    if key not in space.__dict__:
        qp, _ = _cell_quadrature(space, qorder)
        space.__dict__[key] = space.shape_values(space.tensor(space.grid.cell_vertices), qp)
    return space.__dict__[key]


def cell_shape_gradients(space: Space, qorder: int) -> torch.Tensor:
    """[NC, k, nd, dim] basis gradients at the cell quadrature points (cached)."""
    key = ("_cell_shape_gradients", int(qorder))
    if key not in space.__dict__:
        qp, _ = _cell_quadrature(space, qorder)
        space.__dict__[key] = space.shape_gradients(space.tensor(space.grid.cell_vertices), qp)
    return space.__dict__[key]


def elliptic_cell_matrices(space: Space, diffusion_factor: Function, diffusion_tensor: Function,
                           order: Optional[int] = None) -> torch.Tensor:
    """[NC, nd, nd] local stiffness: int lam (kappa grad phi_j) . grad phi_i."""
    qorder = order if order is not None else (diffusion_factor.order + diffusion_tensor.order
                                              + 2 * (space.order - 1) + 2)
    qp, qw = _cell_quadrature(space, qorder)
    grads = cell_shape_gradients(space, qorder)  # [NC, k, nd, 2]
    return elliptic_cells_core(qp, qw, grads, diffusion_factor, diffusion_tensor)


def elliptic_cells_core(qp, qw, grads, diffusion_factor, diffusion_tensor):
    """Array-form elliptic volume kernel on given quadrature/gradient arrays."""
    lam = diffusion_factor(qp)  # [NC, k]
    kap = diffusion_tensor(qp)  # [NC, k, 2, 2]
    flux = torch.einsum("ckab,ckjb->ckja", kap, grads)
    return torch.einsum("ck,ckia,ckja->cij", qw * lam, grads, flux)


def l2_cell_matrices(space: Space, weight: Optional[Function] = None,
                     order: Optional[int] = None) -> torch.Tensor:
    """[NC, nd, nd] local mass matrices (weighted L2 product)."""
    worder = weight.order if weight is not None else 0
    qorder = order if order is not None else 2 * space.order + worder
    qp, qw = _cell_quadrature(space, qorder)
    vals = cell_shape_values(space, qorder)  # [NC, k, nd]
    wq = qw * weight(qp) if weight is not None else qw
    return torch.einsum("ck,cki,ckj->cij", wq, vals, vals)


def force_cell_vectors(space: Space, f: Function, order: Optional[int] = None) -> torch.Tensor:
    """[NC, nd] local L2-volume functionals int f phi_i."""
    qorder = order if order is not None else f.order + space.order + 1
    qp, qw = _cell_quadrature(space, qorder)
    vals = cell_shape_values(space, qorder)
    return torch.einsum("ck,cki->ci", qw * f(qp), vals)


def boundary_face_functional(space: Space, g: Function, face_ids: np.ndarray,
                             order: Optional[int] = None) -> torch.Tensor:
    """Global vector of int_e g phi_i over the given boundary faces."""
    grid = space.grid
    if len(face_ids) == 0:
        return torch.zeros(space.num_dofs, dtype=space.dtype, device=space.device)
    qorder = order if order is not None else g.order + space.order + 1
    qp, qw = face_quadrature(grid, qorder, space.device, space.dtype, face_ids)
    inside = grid.face_cells[np.asarray(face_ids), 0]
    vals = space.shape_values(space.tensor(grid.cell_vertices[inside]), qp)  # [F, k, nd]
    local = torch.einsum("fk,fki->fi", qw * g(qp), vals)
    return scatter_cell_vectors(local, space.cell_dofs[inside], space.num_dofs)


def boundary_face_l2_matrices(space: Space, face_ids: np.ndarray,
                              weight_fn: Optional[Callable] = None,
                              order: Optional[int] = None) -> torch.Tensor:
    """[F, nd, nd] local face L2 matrices int_e w phi_i phi_j on the inside
    cell's basis; ``weight_fn(face_ids, qp)`` may give a per-face weight."""
    grid = space.grid
    qorder = order if order is not None else 2 * space.order + 1
    qp, qw = face_quadrature(grid, qorder, space.device, space.dtype, face_ids)
    inside = grid.face_cells[np.asarray(face_ids), 0]
    vals = space.shape_values(space.tensor(grid.cell_vertices[inside]), qp)
    w = qw if weight_fn is None else qw * weight_fn(face_ids, qp)
    return torch.einsum("fk,fki,fkj->fij", w, vals, vals)


# -- global assembly --------------------------------------------------------


def scatter_cell_vectors(local: torch.Tensor, dofs: np.ndarray, num_dofs: int) -> torch.Tensor:
    """[B, nd] local vectors + [B, nd] dof map -> [num_dofs] global vector.

    ``index_add_`` in sorted DoF order.  On the CPU it sums each DoF's
    entries in order; on CUDA it adds with atomics, so the summation order
    of a DoF shared by several entries varies from run to run: equal to the
    ordered sum within a few ulps (at most nd * faces-per-cell terms per
    DoF), not bitwise repeatable."""
    idx = np.asarray(dofs).reshape(-1)
    order = np.argsort(idx, kind="stable")
    out = local.new_zeros(num_dofs)
    dev = local.device
    return out.index_add_(0, torch.as_tensor(idx[order], dtype=torch.long).to(dev),
                          local.reshape(-1)[torch.as_tensor(order).to(dev)])


def volume_pattern(space: Space) -> SparsityPattern:
    """Sparsity pattern of cell-local couplings, cached per Space."""
    cached = space.__dict__.get("_volume_pattern")
    if cached is None:
        dofs = space.cell_dofs
        nd = dofs.shape[1]
        rows = np.repeat(dofs, nd, axis=1)  # entry (c,i,j) -> flat c*nd*nd + i*nd + j
        cols = np.tile(dofs, (1, nd))
        cached = build_pattern(rows, cols, (space.num_dofs, space.num_dofs))
        space.__dict__["_volume_pattern"] = cached
    return cached


def assemble_cell_matrix(space: Space, local: torch.Tensor,
                         pattern: Optional[SparsityPattern] = None) -> SparseMatrix:
    """[NC, nd, nd] local matrices -> global SparseMatrix on the volume pattern."""
    pattern = pattern or volume_pattern(space)
    return SparseMatrix(pattern, pattern.assemble(local.reshape(-1)))


def diffusion_pairs(problem) -> AffineDecomposition:
    """(diffusion_factor x diffusion_tensor) as one affine family of
    (factor_fn, tensor_fn) payload pairs with product coefficients."""
    factor = problem.diffusion_factor
    tensor = problem.diffusion_tensor
    out = AffineDecomposition()
    f_parts = [(c, factor.coefficients[q]) for q, c in enumerate(factor.components)]
    if factor.affine_part is not None:
        f_parts.append((factor.affine_part, None))
    t_parts = [(c, tensor.coefficients[q]) for q, c in enumerate(tensor.components)]
    if tensor.affine_part is not None:
        t_parts.append((tensor.affine_part, None))
    for ffn, fcoef in f_parts:
        for tfn, tcoef in t_parts:
            if fcoef is None and tcoef is None:
                out.register_affine_part((ffn, tfn))
            elif fcoef is None:
                out.register_component((ffn, tfn), tcoef)
            elif tcoef is None:
                out.register_component((ffn, tfn), fcoef)
            else:
                out.register_component((ffn, tfn), ProductFunctional(fcoef, tcoef))
    return out
