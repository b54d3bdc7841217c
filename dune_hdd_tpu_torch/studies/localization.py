"""Localization study: estimator indicator distributions against the true
local errors.  Counterpart of ``dune_hdd_tpu/studies/localization.py``: the
per-cell true energy errors, reduced by subdomain, against the
per-subdomain indicators of a BlockSWIPDG estimator."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..estimators.block_swipdg import BlockSWIPDGEstimators, by_subdomain
from ..functions.base import Function, freeze_function
from ..ops.assembly import cell_quadrature
from ..ops.norms import evaluate_discrete_gradient

__all__ = ["true_local_indicators", "localization_study"]


def true_local_indicators(block_disc, u: torch.Tensor, exact: Function, mu=None,
                          order: int = 6) -> np.ndarray:
    """Per-subdomain squared energy errors |e|^2_{a,Omega_j} of the discrete
    solution against an exact solution, normalized to sum 1."""
    d = block_disc
    grid = d.space.grid
    problem = d.problem.with_mu(mu) if d.problem.parametric() else d.problem
    lam = freeze_function(problem.diffusion_factor)
    kap = freeze_function(problem.diffusion_tensor)
    qp, qw = cell_quadrature(grid, order, d.space.device, d.space.dtype)
    e_grad = exact.gradient(qp) - evaluate_discrete_gradient(d.space, u, qp)
    flux = torch.einsum("ckab,ckb->cka", kap(qp), e_grad)
    cell_sq = torch.sum(qw * lam(qp) * torch.sum(e_grad * flux, dim=-1), dim=1)
    sub_sq = by_subdomain(cell_sq, d.ms_grid)
    return (sub_sq / torch.sum(sub_sq)).cpu().numpy()


def localization_study(block_disc, u: torch.Tensor, exact: Function,
                       estimator_type: str = "eta_OS2014", parameters: Optional[Dict] = None
                       ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(estimator indicators, true indicators, Pearson correlation), both
    distributions normalized: a well-localized estimator orders the
    subdomains as the true error does."""
    est = BlockSWIPDGEstimators.estimate_local(block_disc, u, estimator_type, parameters)
    est = est / est.sum()
    true = true_local_indicators(block_disc, u, exact, (parameters or {}).get("mu"))
    if est.std() == 0 or true.std() == 0:
        corr = 1.0 if np.allclose(est, true) else 0.0
    else:
        corr = float(np.corrcoef(est, true)[0, 1])
    return est, true, corr
