"""Norms: discrete induced norms (product matrices) and continuous-vs-discrete
error norms by quadrature.  Counterpart of ``dune_hdd_tpu/ops/norms.py``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..functions.base import Function
from ..la.sparse import SparseMatrix
from .assembly import cell_quadrature
from .spaces import Space

__all__ = ["induced_norm", "evaluate_discrete", "evaluate_discrete_gradient", "error_norms"]


def induced_norm(matrix: SparseMatrix, v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(torch.dot(v, matrix.matvec(v)), min=0.0))


def evaluate_discrete(space: Space, u: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """u_h at per-cell points qp [NC, k, 2] -> [NC, k]."""
    vals = space.shape_values(space.tensor(space.grid.cell_vertices), qp)  # [NC, k, nd]
    u_loc = u[space.tensor(space.cell_dofs)]  # [NC, nd]
    return torch.einsum("cki,ci->ck", vals, u_loc)


def evaluate_discrete_gradient(space: Space, u: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """grad u_h at per-cell points -> [NC, k, 2]."""
    grads = space.shape_gradients(space.tensor(space.grid.cell_vertices), qp)  # [NC,k,nd,2]
    u_loc = u[space.tensor(space.cell_dofs)]
    return torch.einsum("ckia,ci->cka", grads, u_loc)


def error_norms(space: Space, u: torch.Tensor, exact: Function,
                diffusion_factor: Optional[Function] = None,
                diffusion_tensor: Optional[Function] = None,
                order: int = 8) -> Dict[str, float]:
    """L2 / H1_semi (/ energy if a diffusion is given) norms of (exact - u_h),
    by high-order quadrature over the cells of ``space``."""
    qp, qw = cell_quadrature(space.grid, order, space.device, space.dtype)
    e_val = exact(qp) - evaluate_discrete(space, u, qp)
    e_grad = exact.gradient(qp) - evaluate_discrete_gradient(space, u, qp)
    out = {
        "L2": float(torch.sqrt(torch.sum(qw * e_val**2))),
        "H1_semi": float(torch.sqrt(torch.sum(qw * torch.sum(e_grad**2, dim=-1)))),
    }
    if diffusion_factor is not None or diffusion_tensor is not None:
        lam = diffusion_factor(qp) if diffusion_factor is not None else 1.0
        if diffusion_tensor is not None:
            flux = torch.einsum("ckab,ckb->cka", diffusion_tensor(qp), e_grad)
        else:
            flux = e_grad
        out["energy"] = float(torch.sqrt(torch.sum(qw * lam * torch.sum(e_grad * flux, dim=-1))))
    return out
