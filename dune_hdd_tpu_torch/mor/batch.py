"""Batched online RB sweeps over parameter sets.

Counterpart of ``dune_hdd_tpu/mor/batch.py``.  The greedy scores every
training parameter per iteration; here the sweep is one program on the
device: each theta is evaluated once on the host over the stacked [M, k]
parameter components (the compiled expressions index their last axis) and
the [M, Q] thetas are copied over once, then one batched einsum assembles
the [M, n, n] reduced systems, one ``torch.linalg.solve`` solves them and
the Gramian quadratic form is batched.  Float64 throughout, so TF32 never
applies.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .residual import quadratic_forms

__all__ = ["stack_parameters", "batched_reduced_solve", "batched_estimates"]


def stack_parameters(problem, mus: Sequence[dict]) -> Dict[str, torch.Tensor]:
    """Parse and stack a parameter list into {key: [M, k]} float64 host
    tensors."""
    parsed = [problem.parse_parameter(mu) for mu in mus]
    keys = sorted(parsed[0].keys()) if parsed else []
    return {k: torch.stack([p[k] for p in parsed]) for k in keys}


def _thetas(coeffs, stacked: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """[M, Q] thetas of the stacked parameters, one evaluation per
    coefficient on the host, copied to ``device`` once."""
    M = next(iter(stacked.values())).shape[0]
    if not coeffs:
        return torch.zeros((M, 0), dtype=torch.float64, device=device)
    return torch.stack([c(stacked).to(torch.float64).expand(M) for c in coeffs], dim=1).to(device)


def _solve(rm, stacked) -> torch.Tensor:
    dev = rm.device
    A = torch.einsum("mq,qij->mij", _thetas(rm.op_coeffs, stacked, dev), rm.op_mats)
    b = torch.einsum("mq,qi->mi", _thetas(rm.rhs_coeffs, stacked, dev), rm.rhs_vecs)
    if rm.dim == 0:
        return b
    return torch.linalg.solve(A, b)


def batched_reduced_solve(rm, stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[M, n] reduced coefficients for all stacked parameters
    (ReducedModel.solve batched over mu)."""
    return _solve(rm, stacked)


def batched_estimates(online, rm, stacked: Dict[str, torch.Tensor],
                      coercivities: Optional[np.ndarray] = None) -> np.ndarray:
    """[M] Riesz residual estimates (OnlineResidual.estimate batched) as a
    host array: thetas, reduced solves and the Gramian quadratic form for
    every candidate.  ``coercivities``: per-candidate alpha_LB evaluated by
    the caller; divides as 1/sqrt(alpha)."""
    dev = online.G_ff.device
    coef = _solve(rm, stacked).to(dev)
    etas = quadratic_forms(online.G_ff, online.G_fa, online.G_aa,
                           _thetas(online.rhs_coeffs, stacked, dev),
                           _thetas(online.op_coeffs, stacked, dev), coef).cpu().numpy()
    if coercivities is not None:
        etas = etas / np.sqrt(np.maximum(np.asarray(coercivities, dtype=etas.dtype), 1e-300))
    return etas
