"""Offline/online reduced-basis residual error estimator.

Counterpart of ``dune_hdd_tpu/mor/residual.py``.  With product P (SPD) and
affine operator/rhs

    A(mu) = sum_q theta_q(mu) A_q,      f(mu) = sum_p sigma_p(mu) f_p,

the residual r(mu) = f(mu) - A(mu) u_rb(mu) has Riesz representative
rho = P^{-1} r and ||rho||_P^2 = r^T P^{-1} r expands into mu-independent
Gramians of the residual generators:

    G_ff[p,p']    = f_p^T P^{-1} f_p'
    G_fa[p,q,j]   = f_p^T P^{-1} (A_q b_j)
    G_aa[q,i,q,j] = (A_q b_i)^T P^{-1} (A_q' b_j)

Offline: one P-solve per generator, cached per basis row by content.  P is
factored once on the host by ``scipy.sparse.linalg.splu``, as in the
reference; the products A_q b_j run on the discretization's device, the
solves on the host, and the Gramians are float64 ``torch.einsum`` products
on the device over device copies of A_q b_j and P^{-1} A_q b_j.  Online the
estimate is O(Q^2 n^2) dense algebra; with a coercivity lower bound
alpha_LB(mu) it is divided by sqrt(alpha_LB(mu)).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.logging import timed
from .reductor import thetas

__all__ = ["RieszResidualEstimator", "OnlineResidual", "min_theta_coercivity"]


def min_theta_coercivity(operator_decomposition, mu_bar) -> Callable:
    """alpha_LB(mu) = min_q theta_q(mu)/theta_q(mu_bar): a lower bound of the
    coercivity w.r.t. the energy product at mu_bar when all theta_q > 0 and
    the A_q are positive semidefinite (the min-theta approach)."""
    from ..affine import coefficient_bounds

    def alpha(mu):
        a, _ = coefficient_bounds(operator_decomposition, mu, mu_bar)
        return a

    return alpha


def quadratic_forms(G_ff: torch.Tensor, G_fa: torch.Tensor, G_aa: torch.Tensor,
                    tf: torch.Tensor, ta: torch.Tensor, coefficients: torch.Tensor
                    ) -> torch.Tensor:
    """[M] ||P^{-1} r||_P for thetas tf [M, Qf], ta [M, Qa] and reduced
    coefficients [M, n]: tf G_ff tf - 2 tf G_fa w + w G_aa w with
    w = (ta outer c), clamped at 0 before the root.  Float64 throughout:
    these products never take the TF32 path."""
    M = tf.shape[0]
    Qf, Qa, n = G_fa.shape
    w = (ta[:, :, None] * coefficients[:, None, :]).reshape(M, Qa * n)
    eta2 = (torch.einsum("mp,pr,mr->m", tf, G_ff, tf)
            - 2.0 * torch.einsum("mp,pk,mk->m", tf, G_fa.reshape(Qf, Qa * n), w)
            + torch.einsum("mk,kl,ml->m", w, G_aa.reshape(Qa * n, Qa * n), w))
    return torch.sqrt(torch.clamp(eta2, min=0.0))


class OnlineResidual:
    """Dense online part: mu -> ||P^{-1} r(mu)||_P (optionally / alpha_LB)."""

    def __init__(self, G_ff, G_fa, G_aa, op_coeffs, rhs_coeffs,
                 coercivity: Optional[Callable] = None):
        self.G_ff = G_ff
        self.G_fa = G_fa
        self.G_aa = G_aa
        self.op_coeffs = list(op_coeffs)
        self.rhs_coeffs = list(rhs_coeffs)
        self.coercivity = coercivity

    def estimate(self, mu, coefficients: torch.Tensor) -> float:
        """Error estimate for the reduced solution with the given reduced
        coefficients at mu."""
        dev = self.G_ff.device
        tf = thetas(self.rhs_coeffs, mu, dev)
        ta = thetas(self.op_coeffs, mu, dev)
        eta = float(quadratic_forms(self.G_ff, self.G_fa, self.G_aa, tf[None], ta[None],
                                    coefficients.to(dev)[None])[0])
        if self.coercivity is not None:
            eta = eta / float(np.sqrt(max(float(self.coercivity(mu)), 1e-300)))
        return eta


class RieszResidualEstimator:
    """The offline part, with a per-basis-row cache keyed by the row's bytes:
    a basis that only gains rows triggers P-solves for the new rows alone."""

    def __init__(self, discretization, product: str = "h1_semi",
                 coercivity: Optional[Callable] = None, mu_bar=None,
                 constrain_dirichlet: bool = True):
        d = discretization
        self.d = d
        pm = d.get_product(product)
        if pm.parametric():
            if mu_bar is None:
                raise ValueError(
                    f"product {product!r} is parametric; pass mu_bar to freeze it"
                )
            P = pm.freeze(d.problem.parse_parameter(mu_bar))
        else:
            P = d.product_matrix(product)
        # CG discretizations assemble their products unconstrained, so
        # h1_semi carries the constants kernel; constraining the Dirichlet
        # DoFs (unit diagonal) makes P SPD on the active space, the
        # constrained-H1 dual norm.  DG spaces (weak BCs) are untouched.
        if constrain_dirichlet and getattr(d.space, "continuous", True):
            binfo = getattr(d, "boundary_info", None)
            dirv = getattr(binfo, "dirichlet_vertices", None)
            if dirv is not None:
                dirv = np.asarray(dirv)
                if dirv.any() and dirv.shape[0] == P.pattern.shape[0]:
                    P = (P.with_constrained_rows(dirv, unit_diagonal=True)
                         .with_constrained_cols(dirv, keep_unit_diag=True))
        self._P = P
        p = P.pattern
        A = sp.csc_matrix((P.values.detach().cpu().double().numpy(), (p.slot_rows, p.slot_cols)),
                          shape=p.shape)
        # the DG h1_semi product has a constant-per-cell kernel: a tiny
        # diagonal-scaled l2 shift makes the factorization exist
        diag_scale = float(np.abs(A.diagonal()).max() or 1.0)
        A = A + sp.identity(p.shape[0], format="csc") * (1e-12 * diag_scale)
        with timed("mor.splu"):
            self._solve_P = spla.splu(A).solve
        #: row-cache hits and misses since construction
        self.cache_hits = 0
        self.cache_misses = 0

        op = d.get_operator().with_expanded_affine_part()
        rhs = d.get_rhs().with_expanded_affine_part()
        self.op_components = list(op.components)
        self.op_coeffs = list(op.coefficients)
        self.rhs_components = list(rhs.components)
        self.rhs_coeffs = list(rhs.coefficients)
        self.coercivity = coercivity

        dev = d.device
        f = np.stack([v.detach().cpu().double().numpy() for v in self.rhs_components])
        rf = self._solve_rows(f)  # [Qf, N]
        self._f = torch.as_tensor(f).to(dev)
        self._G_ff = torch.as_tensor(rf @ f.T).to(dev)
        # content-addressed: the LRBMS globalization reorders rows when a
        # subdomain basis grows, which a prefix cache would rebuild
        self._row_cache: Dict[bytes, tuple] = {}

    def _solve_rows(self, rows: np.ndarray) -> np.ndarray:
        """P^{-1} of each row of [k, N], one multi-rhs LU solve (the same
        values as k single solves)."""
        return np.ascontiguousarray(self._solve_P(np.ascontiguousarray(rows.T)).T)

    def _row_data(self, row: torch.Tensor) -> tuple:
        """(A_q row [Qa, N], P^{-1} A_q row [Qa, N]), both on the device."""
        key = row.detach().cpu().numpy().tobytes()
        hit = self._row_cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            return hit
        self.cache_misses += 1
        Ab = torch.stack([m.matvec(row) for m in self.op_components])
        hit = (Ab, torch.as_tensor(self._solve_rows(Ab.cpu().numpy())).to(row.device))
        self._row_cache[key] = hit
        return hit

    def offline(self, basis: torch.Tensor) -> OnlineResidual:
        rows = basis.to(device=self.d.device, dtype=torch.float64)
        n = rows.shape[0]
        Qa, Qf = len(self.op_components), len(self.rhs_components)
        if n == 0:
            G_fa = rows.new_zeros((Qf, Qa, 0))
            G_aa = rows.new_zeros((Qa, 0, Qa, 0))
        else:
            data = [self._row_data(r) for r in rows]
            Ab = torch.stack([d[0] for d in data], dim=1)    # [Qa, n, N]
            rAb = torch.stack([d[1] for d in data], dim=1)   # [Qa, n, N]
            # float64 device products: no TF32 path
            G_fa = torch.einsum("pN,qjN->pqj", self._f, rAb)
            G_aa = torch.einsum("qiN,pjN->qipj", Ab, rAb)
            # symmetrize (P^{-1} is symmetric; splu round-off breaks it mildly)
            G_aa = 0.5 * (G_aa + G_aa.permute(2, 3, 0, 1))
        return OnlineResidual(self._G_ff, G_fa, G_aa, self.op_coeffs,
                              self.rhs_coeffs, self.coercivity)
