"""SWIPDG discretization.

Counterpart of ``dune_hdd_tpu/discretizations/swipdg.py``.  Discontinuous
P1 space; the operator is, per affine diffusion component, volume elliptic
blocks + SWIPDG interior/Dirichlet face blocks; the rhs carries force,
Neumann and Dirichlet-penalty functionals with product coefficients.
Products (``only_these_products``): l2, h1_semi, elliptic, boundary_l2,
penalty, energy (= the operator family).  Everything is assembled on
``device`` (the card unless the caller asks for the CPU) in ``dtype``.

Two parametric schemes (``scheme``):

* "reference" (default): one self-weighted SWIPDG operator per affine
  diffusion component and one full Dirichlet-penalty boundary functional
  per (diffusion_p x dirichlet_q) pair with coefficient theta_p*theta_q.
* "penalty_mu": weights/penalty frozen at ``penalty_mu`` (default all-ones);
  parametric components carry flux terms only and the penalty appears once
  in the affine part.  Positive penalty for every mu.

Solver types beyond ``la/solvers.py``: "block_cg[.jacobi]" (symmetric
diagonal scaling + block-Jacobi CG on the block-ELL operator, through
``make_solve_fn``) and "stencil_cg" (PCG in the plane layout of
``la/stencil.py``, whose SpMV is the hand-written ``plane_spmv`` kernel; with
``options["macro"] = (mx, my)`` two-level weighted deflation).  On a grid
without a structured cell order "stencil_cg" runs "block_cg.jacobi".
"""
from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..device import resolve_device
from ..functions.base import ConstantFunction, constant_matrix, freeze_function
from ..grid.boundaryinfo import BoundaryInfo, make_boundary_info
from ..grid.structured import Grid
from ..la.block_ell import (
    BlockEllMatrix,
    block_cg,
    block_ell_from_sparse,
    symmetric_diagonal_scaling,
)
from ..ops.assembly import (
    assemble_cell_matrix,
    boundary_face_functional,
    cell_quadrature,
    diffusion_pairs,
    elliptic_cell_matrices,
    force_cell_vectors,
    l2_cell_matrices,
    scatter_cell_vectors,
    volume_pattern,
)
from ..ops.spaces import dg_space
from ..ops.swipdg import (
    assemble_swipdg_matrix,
    boundary_sigma,
    default_beta,
    inner_sigma,
    swipdg_dirichlet_rhs,
    swipdg_face_blocks,
    swipdg_pattern,
)
from ..parameters import ProductFunctional
from ..problems.interfaces import Problem
from ..utils.logging import timed
from .base import StationaryDiscretization
from .cg import _parts

__all__ = ["SWIPDGDiscretization", "StencilSystem"]

_ALL_PRODUCTS = ("l2", "h1_semi", "elliptic", "boundary_l2", "penalty", "energy")


class StencilSystem(NamedTuple):
    """A scaled system S X = B in the plane layout: u = X[from_soa] * s."""

    S: object               # StencilBlockEll
    B: torch.Tensor         # [nd, 8, KY, KX]
    s: torch.Tensor         # [N] diagonal scaling in the original order
    to_soa: torch.Tensor    # flat original -> flat plane layout gather
    from_soa: torch.Tensor  # flat plane layout -> flat original gather


def _guard_sign_indefinite_scheme(problem, grid, scheme: str, device, dtype) -> str:
    """The self-weighted scheme needs a strictly positive diffusion-factor
    affine part (its face penalty turns negative where the affine part
    does); otherwise fall back to the penalty_mu scheme."""
    affine = problem.diffusion_factor.affine_part
    if affine is None:
        return "penalty_mu"
    qp, _ = cell_quadrature(grid, 2, device, dtype)
    if float(affine(qp).min()) <= 0.0:
        return "penalty_mu"
    return scheme


class SWIPDGDiscretization(StationaryDiscretization):
    static_id = "hdd.linearelliptic.discretizations.swipdg"

    def __init__(
        self,
        grid: Grid,
        boundary_info,
        problem: Problem,
        order: int = 1,
        only_these_products: Optional[Sequence[str]] = ("l2", "h1_semi", "energy"),
        penalty_mu=None,
        scheme: Optional[str] = None,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        device = resolve_device(device)
        explicit_scheme = scheme is not None
        if scheme is None:
            scheme = "penalty_mu" if penalty_mu is not None else "reference"
        if scheme not in ("reference", "penalty_mu"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.scheme_substituted = False
        if scheme == "reference" and problem.parametric():
            guarded = _guard_sign_indefinite_scheme(problem, grid, scheme, device, dtype)
            if guarded != scheme:
                self.scheme_substituted = True
                if explicit_scheme:
                    warnings.warn(
                        "SWIPDG scheme='reference' requires a strictly positive "
                        "diffusion-factor affine part; falling back to "
                        "scheme='penalty_mu' (sign-indefinite decomposition)",
                        RuntimeWarning, stacklevel=2)
            scheme = guarded
        self.scheme = scheme
        if not isinstance(boundary_info, BoundaryInfo):
            boundary_info = make_boundary_info(grid, boundary_info)
        space = dg_space(grid, order, device=device, dtype=dtype)
        products_wanted = (tuple(only_these_products) if only_these_products is not None
                           else _ALL_PRODUCTS)
        self.beta = default_beta(2)
        self.sigma_inner = inner_sigma(order)
        self.sigma_boundary = boundary_sigma(order)

        interior = np.nonzero(grid.interior_faces)[0]
        dirichlet = np.nonzero(boundary_info.dirichlet_faces)[0]
        neumann = np.nonzero(boundary_info.neumann_faces)[0]
        all_boundary = np.nonzero(grid.boundary_faces)[0]
        self._interior_faces = interior
        self._dirichlet_faces = dirichlet

        # weighting diffusion (fixed; = the diffusion itself if nonparametric)
        if problem.parametric():
            if penalty_mu is None:
                penalty_mu = {name: np.ones(size)
                              for name, size in problem.parameter_type.items()}
            wproblem = problem.with_mu(penalty_mu)
        else:
            wproblem = problem
        wlam = freeze_function(wproblem.diffusion_factor)
        wkap = freeze_function(wproblem.diffusion_tensor)
        self._weight_diffusion = (wlam, wkap)

        with timed("swipdg.pattern"):
            pattern = swipdg_pattern(space, interior, dirichlet)
        sigmas = dict(sigma_i=self.sigma_inner, sigma_b=self.sigma_boundary, beta=self.beta)
        zero_vol = torch.zeros((grid.num_cells, space.shape_count, space.shape_count),
                               dtype=dtype, device=device)

        # -- operator: per diffusion pair, volume + face blocks.
        # scheme="penalty_mu": parametric components carry flux terms only,
        # the penalty goes once into the affine part (created if missing)
        operator = AffineDecomposition()
        pairs = diffusion_pairs(problem)
        with timed("swipdg.assemble_operator", sync=device):
            for (lam_fn, kap_fn), coef in _parts(pairs):
                vol = elliptic_cell_matrices(space, lam_fn, kap_fn)
                if scheme == "reference":
                    face_kw = dict(sigmas)
                else:
                    face_kw = dict(sigmas, weight_lam_fn=wlam, weight_kap_fn=wkap,
                                   flux_only=(coef is not None))
                ib, bb = swipdg_face_blocks(space, lam_fn, kap_fn, interior, dirichlet, **face_kw)
                mat = assemble_swipdg_matrix(space, vol, ib, bb, pattern)
                if coef is None:
                    operator.register_affine_part(mat)
                else:
                    operator.register_component(mat, coef)
            if scheme == "penalty_mu" and operator.affine_part is None:
                ibp, bbp = swipdg_face_blocks(space, wlam, wkap, interior, dirichlet,
                                              penalty_only=True, **sigmas)
                operator.register_affine_part(
                    assemble_swipdg_matrix(space, zero_vol, ibp, bbp, pattern))

        # -- rhs ------------------------------------------------------------
        rhs = AffineDecomposition()

        def add_rhs(vec, coef):
            if coef is None:
                if rhs.affine_part is None:
                    rhs.register_affine_part(vec)
                else:
                    rhs.affine_part = rhs.affine_part + vec
            else:
                rhs.register_component(vec, coef)

        def product(mcoef, gcoef):
            if mcoef is None or gcoef is None:
                return gcoef if mcoef is None else mcoef
            return ProductFunctional(mcoef, gcoef)

        with timed("swipdg.assemble_rhs", sync=device):
            for f_fn, coef in _parts(problem.force):
                local = force_cell_vectors(space, f_fn)
                add_rhs(scatter_cell_vectors(local, space.cell_dofs, space.num_dofs), coef)
            if len(neumann):
                for g_fn, coef in _parts(problem.neumann):
                    add_rhs(boundary_face_functional(space, g_fn, neumann), coef)
            if len(dirichlet):
                for g_fn, gcoef in _parts(problem.dirichlet):
                    if scheme == "reference":
                        # one full self-weighted boundary functional per
                        # (diffusion_p x dirichlet_q) pair
                        for (lam_fn, kap_fn), mcoef in _parts(pairs):
                            vec = swipdg_dirichlet_rhs(
                                space, g_fn, dirichlet, lam_fn=lam_fn, kap_fn=kap_fn,
                                sigma_b=self.sigma_boundary, beta=self.beta, part="both")
                            add_rhs(vec, product(mcoef, gcoef))
                        continue
                    # penalty part: weighting diffusion only -> theta_q
                    add_rhs(swipdg_dirichlet_rhs(
                        space, g_fn, dirichlet, weight_lam_fn=wlam, weight_kap_fn=wkap,
                        sigma_b=self.sigma_boundary, beta=self.beta, part="penalty"), gcoef)
                    # flux part: linear in each diffusion component -> theta_p theta_q
                    for (lam_fn, kap_fn), mcoef in _parts(pairs):
                        add_rhs(swipdg_dirichlet_rhs(
                            space, g_fn, dirichlet, lam_fn=lam_fn, kap_fn=kap_fn,
                            weight_lam_fn=wlam, weight_kap_fn=wkap,
                            sigma_b=self.sigma_boundary, beta=self.beta, part="flux"),
                            product(mcoef, gcoef))
            if rhs.affine_part is None:
                rhs.register_affine_part(torch.zeros(space.num_dofs, dtype=dtype, device=device))

        # -- products --------------------------------------------------------
        products: Dict[str, AffineDecomposition] = {}
        with timed("swipdg.assemble_products", sync=device):
            vol_pat = volume_pattern(space) if {"l2", "h1_semi", "elliptic"} & set(
                products_wanted) else None
            if "l2" in products_wanted:
                products["l2"] = AffineDecomposition(affine_part=assemble_cell_matrix(
                    space, l2_cell_matrices(space), vol_pat))
            if "h1_semi" in products_wanted:
                products["h1_semi"] = AffineDecomposition(affine_part=assemble_cell_matrix(
                    space, elliptic_cell_matrices(space, ConstantFunction(1.0),
                                                  constant_matrix(1.0)), vol_pat))
            if "elliptic" in products_wanted:
                elliptic = AffineDecomposition()
                for (lam_fn, kap_fn), coef in _parts(pairs):
                    m = assemble_cell_matrix(space, elliptic_cell_matrices(space, lam_fn, kap_fn),
                                             vol_pat)
                    if coef is None:
                        elliptic.register_affine_part(m)
                    else:
                        elliptic.register_component(m, coef)
                products["elliptic"] = elliptic
            if "boundary_l2" in products_wanted:
                from ..ops.assembly import boundary_face_l2_matrices

                nd = space.shape_count
                bpat = swipdg_pattern(space, np.zeros(0, dtype=np.int64), all_boundary)
                products["boundary_l2"] = AffineDecomposition(affine_part=assemble_swipdg_matrix(
                    space, zero_vol, zero_vol.new_zeros((0, 2, 2, nd, nd)),
                    boundary_face_l2_matrices(space, all_boundary), bpat))
            if "penalty" in products_wanted:
                if scheme == "reference":
                    # per-component self-weighted penalty
                    penalty = AffineDecomposition()
                    for (lam_fn, kap_fn), coef in _parts(pairs):
                        ibp, bbp = swipdg_face_blocks(space, lam_fn, kap_fn, interior, dirichlet,
                                                      penalty_only=True, **sigmas)
                        m = assemble_swipdg_matrix(space, zero_vol, ibp, bbp, pattern)
                        if coef is None:
                            penalty.register_affine_part(m)
                        else:
                            penalty.register_component(m, coef)
                    products["penalty"] = penalty
                else:
                    ibp, bbp = swipdg_face_blocks(space, wlam, wkap, interior, dirichlet,
                                                  penalty_only=True, **sigmas)
                    products["penalty"] = AffineDecomposition(
                        affine_part=assemble_swipdg_matrix(space, zero_vol, ibp, bbp, pattern))
            if "energy" in products_wanted:
                products["energy"] = AffineDecomposition(
                    list(operator.components), list(operator.coefficients), operator.affine_part)

        super().__init__(space=space, boundary_info=boundary_info, problem=problem,
                         operator=operator, rhs=rhs, products=products, vectors={},
                         purely_neumann=len(dirichlet) == 0)

    def init(self):
        return self

    def uncached_solve(self, mu, options=None):
        """Adds "block_cg[.jacobi]" and "stencil_cg" (see the module
        docstring) to the solver types of ``la/solvers.py``."""
        opts = dict(options or {})
        if str(opts.get("type", "")) == "stencil_cg":
            u = self._stencil_solve(mu, opts)
            if u is not None:
                return u
            opts["type"] = "block_cg.jacobi"  # unstructured grid
        if str(opts.get("type", "")).startswith("block_cg"):
            key = (float(opts.get("precision", 1e-10)), int(opts.get("max_iter", 10000)))
            cache = self.__dict__.setdefault("_block_solvers", {})
            if key not in cache:
                cache[key] = self.make_solve_fn(tol=key[0], maxiter=key[1], device=self.device)
            solve_fn, thetas = cache[key]
            u, res, iters = solve_fn(*thetas(mu))
            self.last_solve_info = {"type": "block_cg.jacobi", "iterations": iters,
                                    "relative_residual": float(res)}
            return u
        return super().uncached_solve(mu, options)

    def stencil_system(self, mu=None) -> Optional[StencilSystem]:
        """The diagonally scaled frozen system in the plane layout of
        ``la/stencil.py`` (S applies ``plane_spmv``), or None when the grid
        has no structured cell order."""
        from ..grid.structured_order import structured_cell_order
        from ..la.stencil import StencilBlockEll, soa_index_maps

        order = self.__dict__.get("_stencil_order", False)
        if order is False:
            order = structured_cell_order(self.space.grid)
            self.__dict__["_stencil_order"] = order
        if order is None:
            return None
        mu = self.problem.parse_parameter(mu) if mu is not None else {}
        A = block_ell_from_sparse(self.space, self.freeze_operator(mu))
        A_s, b_s, s = symmetric_diagonal_scaling(A, self.freeze_rhs(mu))
        S = StencilBlockEll.from_block_ell(A_s, order)
        maps = soa_index_maps(order, S.nd)
        to_soa = torch.as_tensor(maps.to_soa, dtype=torch.long).to(self.device)
        from_soa = torch.as_tensor(maps.from_soa, dtype=torch.long).to(self.device)
        KY, KX = order.lattice
        return StencilSystem(S, b_s[to_soa].reshape(S.nd, 8, KY, KX), s, to_soa, from_soa)

    def _stencil_solve(self, mu, opts):
        """PCG in the plane layout on a structured grid; None when the grid
        has no structured cell order."""
        from ..la.stencil import jacobi_smoother, stencil_deflation_preconditioner, stencil_pcg

        system = self.stencil_system(mu)
        if system is None:
            return None
        S, B, s = system.S, system.B, system.s
        macro = opts.get("macro")
        if macro is not None:
            # weighted deflation space Z_w = diag(1/s) Z: the scaled system's
            # near-kernel is D^{1/2} 1
            w = (1.0 / s).to(B.dtype)[system.to_soa].reshape(B.shape)
            M = stencil_deflation_preconditioner(S, tuple(macro), weight=w)
        else:
            M = jacobi_smoother(S)
        bn = torch.linalg.norm(B)
        # the relative tolerance clamped to what the working dtype resolves
        rtol = max(float(opts.get("precision", 1e-10)), 10.0 * torch.finfo(B.dtype).eps)
        X, iters = stencil_pcg(S, B / bn, M, rtol=rtol, maxiter=int(opts.get("max_iter", 10000)))
        self.last_solve_info = {"type": "stencil_cg", "iterations": iters, "rtol": rtol}
        return (X * bn).reshape(-1)[system.from_soa] * s

    def make_solve_fn(self, tol: float = 1e-8, maxiter: int = 2000, dtype=None, device="cuda"):
        """Parametric online solver on ``device``: theta vectors -> (u,
        relative recurrence residual, iterations), by symmetric diagonal
        scaling + block-Jacobi CG on the block-ELL operator:

            solve_fn, thetas = disc.make_solve_fn()
            u, res, iterations = solve_fn(*thetas(mu))
        """
        device = resolve_device(device)
        op = self.get_operator().with_expanded_affine_part()
        rhs = self.get_rhs().with_expanded_affine_part()
        with timed("swipdg.block_ell_stack", sync=device):
            mats = [block_ell_from_sparse(self.space, m) for m in op.components]
            blocks = torch.stack([m.blocks for m in mats]).to(device)
            rhs_stack = torch.stack(list(rhs.components)).to(device)
        neighbors = mats[0].neighbors
        nbr = torch.as_tensor(np.asarray(neighbors, dtype=np.int64)).to(device)
        if dtype is not None:
            blocks = blocks.to(dtype)
            rhs_stack = rhs_stack.to(dtype)

        def solve_fn(theta_op, theta_rhs):
            A = BlockEllMatrix(neighbors, torch.einsum(
                "q,qcbij->cbij", theta_op.to(device=device, dtype=blocks.dtype), blocks), nbr)
            b = torch.einsum("q,qn->n", theta_rhs.to(device=device, dtype=rhs_stack.dtype),
                             rhs_stack)
            A_s, b_s, s = symmetric_diagonal_scaling(A, b)
            u_s, res, iters = block_cg(A_s, b_s, tol=tol, maxiter=maxiter)
            return u_s * s, res, iters

        def thetas(mu):
            mu = self.problem.parse_parameter(mu) if mu is not None else {}
            t_op = torch.stack([c(mu) for c in op.coefficients])
            t_rhs = torch.stack([c(mu) for c in rhs.coefficients])
            if dtype is not None:
                t_op, t_rhs = t_op.to(dtype), t_rhs.to(dtype)
            return t_op, t_rhs

        return solve_fn, thetas
