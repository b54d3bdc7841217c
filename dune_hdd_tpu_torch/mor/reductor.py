"""Reduced-basis projection of affine stationary discretizations.

Counterpart of ``dune_hdd_tpu/mor/reductor.py``.  Offline: per affine
component q the dense reduced matrix B A_q B^T and vector B b_q (B = the
reduced basis rows); online: the theta-weighted sums and one dense solve.
Everything stays in float64 on the basis' device; the thetas are evaluated
on the host and copied over once per solve.

The projection applies ``SparseMatrix.matmat`` to the basis columns, whose
row gather is [N, K_ell, columns]: at 1.57M DoF and K_ell = 12 that is
151 MB per column, so the columns go in chunks that keep the gather under
``GATHER_BYTES``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parameters import Parameter

__all__ = ["ReducedModel", "RBReductor", "project"]

GATHER_BYTES = 1 << 30


def project(matrix, basis: torch.Tensor, gather_bytes: int = GATHER_BYTES) -> torch.Tensor:
    """[n, n] = basis @ matrix @ basis.T, with the columns of basis.T in
    chunks whose matmat row gather stays under ``gather_bytes``."""
    n = basis.shape[0]
    if n == 0:
        return basis.new_zeros((0, 0))
    rows, k_ell = matrix.shape[0], matrix.pattern.ell_width
    chunk = max(1, gather_bytes // (rows * k_ell * basis.element_size()))
    BT = basis.T
    return torch.cat([basis @ matrix.matmat(BT[:, j:j + chunk]) for j in range(0, n, chunk)],
                     dim=1)


def thetas(coeffs, mu: Parameter, device) -> torch.Tensor:
    """[Q] float64 theta_q(mu) on ``device`` (evaluated on the host)."""
    if not coeffs:
        return torch.zeros((0,), dtype=torch.float64, device=device)
    return torch.stack([c(mu).reshape(()) for c in coeffs]).to(device)


class ReducedModel:
    """Dense affine reduced model: ops [Q, n, n] stacked, rhs [Qr, n]."""

    def __init__(self, op_mats: torch.Tensor, op_coeffs, rhs_vecs: torch.Tensor,
                 rhs_coeffs, basis: torch.Tensor, products: Optional[Dict] = None):
        self.op_mats = op_mats
        self.op_coeffs = list(op_coeffs)
        self.rhs_vecs = rhs_vecs
        self.rhs_coeffs = list(rhs_coeffs)
        self.basis = basis
        self.products = products or {}

    @property
    def dim(self) -> int:
        return self.basis.shape[0]

    @property
    def device(self) -> torch.device:
        return self.basis.device

    def thetas(self, coeffs, mu: Parameter) -> torch.Tensor:
        return thetas(coeffs, mu, self.device)

    def solve(self, mu: Parameter) -> torch.Tensor:
        """Reduced coefficients [n]."""
        A = torch.einsum("q,qij->ij", self.thetas(self.op_coeffs, mu), self.op_mats)
        b = torch.einsum("q,qi->i", self.thetas(self.rhs_coeffs, mu), self.rhs_vecs)
        return torch.linalg.solve(A, b)

    def reconstruct(self, coefficients: torch.Tensor) -> torch.Tensor:
        return coefficients @ self.basis


class RBReductor:
    """Galerkin projection of a StationaryDiscretization onto a basis."""

    def __init__(self, discretization, product: Optional[str] = None):
        self.d = discretization
        self.product_name = product
        self._product = (
            discretization.product_matrix(product) if product is not None else None
        )

    def reduce(self, basis: torch.Tensor) -> ReducedModel:
        d = self.d
        op = d.get_operator().with_expanded_affine_part()
        rhs = d.get_rhs().with_expanded_affine_part()
        op_mats = torch.stack([project(m, basis) for m in op.components])
        rhs_vecs = torch.stack([basis @ v for v in rhs.components])
        products = {}
        for name in d.available_products():
            if d.get_product(name).parametric():
                continue  # parametric products (e.g. "energy") stay detailed
            products[name] = project(d.product_matrix(name), basis)
        return ReducedModel(op_mats, op.coefficients, rhs_vecs, rhs.coefficients, basis,
                            products)

    # -- error measures ------------------------------------------------------
    def true_error(self, rm: ReducedModel, mu: Parameter, norm: str = "h1_semi",
                   solver_options=None) -> float:
        u = self.d.solve(mu, options=solver_options or {"type": "direct"})
        e = u - rm.reconstruct(rm.solve(mu))
        pm = self.d.product_matrix(norm)
        return float(torch.sqrt(torch.clamp(e @ pm.matvec(e), min=0.0)))

    def residual_norm(self, rm: ReducedModel, mu: Parameter) -> float:
        """Algebraic residual ||b(mu) - A(mu) B c|| (Euclidean): a cheap
        greedy surrogate when no error estimator is requested."""
        u_rb = rm.reconstruct(rm.solve(mu))
        r = self.d.freeze_rhs(mu) - self.d.freeze_operator(mu).matvec(u_rb)
        return float(torch.linalg.norm(r))
