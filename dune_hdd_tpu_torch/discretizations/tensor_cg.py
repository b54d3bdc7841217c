"""Dimension-generic Q1 continuous Galerkin on TensorGrids (d = 1, 2, 3).

Counterpart of ``dune_hdd_tpu/discretizations/tensor_cg.py``: the
reference's CG instantiated for SGrid<1,1> / <2,2> / <3,3>
(examples/linearelliptic/cg.cc:19-21) with the complete
``StationaryDiscretization`` surface of ``discretizations/cg.py``: affine
operator / rhs decompositions, the l2 / h1_semi / energy products, the
Dirichlet projection and shift with coefficient cross-products
(cg.hh:336-374), symmetric row and column constraints (cg.hh:377-397), the
solver registry and the (options, mu) solve cache.  Everything is assembled
on ``device`` (the card unless the caller asks for the CPU) on one volume
pattern, built once and shared by the operator, the products and the
constraints.  The set-up steps are spans of the port's record while
recording (``utils/profiling.py``): "tensor_cg.pattern",
"tensor_cg.operator", "tensor_cg.rhs", "tensor_cg.products" and
"tensor_cg.constraints".
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..affine import AffineDecomposition
from ..device import resolve_device
from ..functions.base import (
    ConstantFunction,
    Function,
    LambdaFunction,
    constant_matrix,
    nonparametric,
)
from ..grid.tensor import TensorGrid, make_tensor_boundary_info
from ..la.sparse import SparseMatrix
from ..ops.assembly import (
    assemble_cell_matrix,
    diffusion_pairs,
    scatter_cell_vectors,
    volume_pattern,
)
from ..ops.norms import error_norms as _error_norms
from ..ops.tensor_space import (
    tensor_elliptic_cell_matrices,
    tensor_force_cell_vectors,
    tensor_l2_cell_matrices,
    tensor_neumann_functional,
    tensor_q1_space,
)
from ..parameters import ProductFunctional
from ..problems.interfaces import Problem
from ..utils.logging import timed
from .base import StationaryDiscretization
from .cg import _parts

__all__ = ["TensorCGDiscretization"]

_ALL_PRODUCTS = ("l2", "h1_semi", "energy")


def _callable_problem(grid: TensorGrid, diffusion, force) -> Problem:
    """Plain callables -> a nonparametric Problem (unit data by default)."""
    d = grid.dim
    lam = (LambdaFunction(diffusion, order=2, name="diffusion_factor")
           if diffusion is not None else ConstantFunction(1.0, "diffusion_factor"))
    f = (LambdaFunction(force, order=2, name="force")
         if force is not None else ConstantFunction(1.0, "force"))
    return Problem(
        nonparametric(lam),
        nonparametric(constant_matrix(1.0, dim=d)),
        nonparametric(f),
        nonparametric(ConstantFunction(0.0, "dirichlet")),
        nonparametric(ConstantFunction(0.0, "neumann")),
    )


class TensorCGDiscretization(StationaryDiscretization):
    """static_id mirrors the reference CG (cg.hh:88); the grid dimension is
    carried by the TensorGrid."""

    static_id = "hdd.linearelliptic.discretizations.cg"

    def __init__(
        self,
        grid: TensorGrid,
        boundary_info=None,
        problem: Optional[Problem] = None,
        only_these_products: Optional[Sequence[str]] = None,
        diffusion: Optional[Callable] = None,
        force: Optional[Callable] = None,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        device = resolve_device(device)
        if problem is None:
            problem = _callable_problem(grid, diffusion, force)
        binfo = make_tensor_boundary_info(grid, boundary_info)
        space = tensor_q1_space(grid, device=device, dtype=dtype)
        products_wanted = (tuple(only_these_products) if only_these_products is not None
                           else _ALL_PRODUCTS)
        d = grid.dim
        vertices = space.tensor(grid.vertices)
        dir_vert = binfo.dirichlet_vertices
        dir_mask = torch.as_tensor(dir_vert).to(device)
        zero = vertices.new_zeros(())
        with timed("tensor_cg.pattern"):
            pattern = volume_pattern(space)

        # -- dirichlet projection per affine component (cg.hh:193-221): Q1
        # nodal interpolation at the Dirichlet vertices
        dirichlet_vec = AffineDecomposition()
        for g_fn, coef in _parts(problem.dirichlet):
            g = torch.where(dir_mask, g_fn(vertices), zero)
            if coef is None:
                dirichlet_vec.register_affine_part(g)
            else:
                dirichlet_vec.register_component(g, coef)
        if dirichlet_vec.affine_part is None:
            dirichlet_vec.register_affine_part(
                torch.zeros(space.num_dofs, dtype=dtype, device=device))

        # -- elliptic operator per diffusion component (cg.hh:223-247)
        operator = AffineDecomposition()
        with timed("tensor_cg.operator", sync=device):
            for (lam_fn, kap_fn), coef in _parts(diffusion_pairs(problem)):
                mat = assemble_cell_matrix(
                    space, tensor_elliptic_cell_matrices(space, lam_fn, kap_fn), pattern)
                if coef is None:
                    operator.register_affine_part(mat)
                else:
                    operator.register_component(mat, coef)
            if operator.affine_part is None:
                operator.register_affine_part(
                    SparseMatrix(pattern, torch.zeros(pattern.nnz, dtype=dtype, device=device)))

        # -- rhs: force (cg.hh:249-271) + neumann (cg.hh:273-289)
        rhs = AffineDecomposition()

        def add_rhs(vec, coef):
            if coef is None:
                if rhs.affine_part is None:
                    rhs.register_affine_part(vec)
                else:
                    rhs.affine_part = rhs.affine_part + vec
            else:
                rhs.register_component(vec, coef)

        with timed("tensor_cg.rhs", sync=device):
            for f_fn, coef in _parts(problem.force):
                local = tensor_force_cell_vectors(space, f_fn)
                add_rhs(scatter_cell_vectors(local, space.cell_dofs, space.num_dofs), coef)
            if binfo.has_neumann:
                for g_fn, coef in _parts(problem.neumann):
                    add_rhs(tensor_neumann_functional(space, g_fn, binfo), coef)
            if rhs.affine_part is None:
                rhs.register_affine_part(torch.zeros(space.num_dofs, dtype=dtype, device=device))

        # -- products (cg.hh:291-330); unconstrained
        products: Dict[str, AffineDecomposition] = {}
        with timed("tensor_cg.products", sync=device):
            if "l2" in products_wanted:
                products["l2"] = AffineDecomposition(affine_part=assemble_cell_matrix(
                    space, tensor_l2_cell_matrices(space), pattern))
            if "h1_semi" in products_wanted:
                products["h1_semi"] = AffineDecomposition(affine_part=assemble_cell_matrix(
                    space, tensor_elliptic_cell_matrices(
                        space, ConstantFunction(1.0), constant_matrix(1.0, dim=d)),
                    pattern))
            if "energy" in products_wanted:
                products["energy"] = AffineDecomposition(
                    list(operator.components), list(operator.coefficients),
                    operator.affine_part)

        with timed("tensor_cg.constraints", sync=device):
            # -- dirichlet shift rhs -= A_p g_q with coefficient products
            # (cg.hh:336-374), on the unconstrained operator
            if binfo.has_dirichlet:
                for mat, mcoef in _parts(operator):
                    for g, gcoef in _parts(dirichlet_vec):
                        shift = -mat.matvec(g)
                        if mcoef is None or gcoef is None:
                            add_rhs(shift, gcoef if mcoef is None else mcoef)
                        else:
                            add_rhs(shift, ProductFunctional(mcoef, gcoef))

            # -- constraints (cg.hh:377-397), symmetric so the system stays SPD
            if binfo.has_dirichlet:
                operator = AffineDecomposition(
                    [c.with_constrained_rows(dir_vert, unit_diagonal=False)
                     .with_constrained_cols(dir_vert, keep_unit_diag=False)
                     for c in operator.components],
                    list(operator.coefficients),
                    operator.affine_part.with_constrained_rows(dir_vert, unit_diagonal=True)
                    .with_constrained_cols(dir_vert, keep_unit_diag=True),
                )
                rhs = AffineDecomposition(
                    [torch.where(dir_mask, zero, c) for c in rhs.components],
                    list(rhs.coefficients),
                    torch.where(dir_mask, zero, rhs.affine_part),
                )

        super().__init__(
            space=space,
            boundary_info=binfo,
            problem=problem,
            operator=operator,
            rhs=rhs,
            products=products,
            vectors={"dirichlet": dirichlet_vec},
            purely_neumann=not binfo.has_dirichlet,
        )

    def init(self):  # API parity with the reference's lazy init (cg.hh:177)
        return self

    def solve_with_dirichlet_shift(self, mu=None, options=None) -> torch.Tensor:
        """Full solution u = u_0 + g (the reference keeps u_0 and re-adds g
        in visualize, base.hh:125-147)."""
        mu_p = self.problem.parse_parameter(mu) if mu is not None else {}
        u0 = self.solve(mu, options)
        g = self._vectors["dirichlet"].freeze(mu_p)
        return u0 + g

    def error_norms(self, u: torch.Tensor, exact, exact_grad=None,
                    order: int = 6) -> Dict[str, float]:
        """L2 / H1_semi errors against a callable (or Function) exact
        solution."""
        if isinstance(exact, Function) and exact_grad is None:
            return _error_norms(self.space, u, exact, order=order)
        ex = LambdaFunction(exact, order=8, name="exact")
        if exact_grad is not None:
            ex.gradient = exact_grad
        return _error_norms(self.space, u, ex, order=order)
