"""Continuous Lagrange (CG) discretization, P1 on triangles.

Counterpart of ``dune_hdd_tpu/discretizations/cg.py`` (the reference's
``discretizations/cg.hh:95-419``): per affine component the elliptic
operator, force/Neumann functionals and l2/h1_semi/energy products; then the
Dirichlet projection, the Dirichlet shift ``rhs -= A_p g_q`` with
coefficient-product bookkeeping, and symmetric row and column elimination so
the frozen operator stays SPD for the CG Krylov solver.  Everything is
assembled on ``device`` (the card unless the caller asks for the CPU) in
``dtype``.  Orders 2 and 3 wait for the P2/P3 spaces (ROADMAP queue 1,
slice 2 c).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..device import resolve_device
from ..functions.base import ConstantFunction, constant_matrix
from ..grid.boundaryinfo import BoundaryInfo, make_boundary_info
from ..grid.structured import Grid
from ..la.sparse import SparseMatrix
from ..ops.assembly import (
    assemble_cell_matrix,
    boundary_face_functional,
    diffusion_pairs,
    elliptic_cell_matrices,
    force_cell_vectors,
    l2_cell_matrices,
    scatter_cell_vectors,
    volume_pattern,
)
from ..ops.spaces import NOT_PORTED, cg_space
from ..parameters import ProductFunctional
from ..problems.interfaces import Problem
from .base import StationaryDiscretization

__all__ = ["CGDiscretization"]

_ALL_PRODUCTS = ("l2", "h1_semi", "energy")


def _parts(dec: AffineDecomposition):
    """[(payload, coefficient-or-None)] with the affine part last."""
    out = [(dec.components[q], dec.coefficients[q]) for q in range(dec.num_components)]
    if dec.affine_part is not None:
        out.append((dec.affine_part, None))
    return out


class CGDiscretization(StationaryDiscretization):
    """static_id: hdd.linearelliptic.discretizations.cg (cg.hh:88)."""

    static_id = "hdd.linearelliptic.discretizations.cg"

    def __init__(
        self,
        grid: Grid,
        boundary_info,
        problem: Problem,
        order: int = 1,
        only_these_products: Optional[Sequence[str]] = None,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        if order != 1:
            raise NotImplementedError(NOT_PORTED.format(what=f"CG order {order}"))
        device = resolve_device(device)
        if not isinstance(boundary_info, BoundaryInfo):
            boundary_info = make_boundary_info(grid, boundary_info)
        space = cg_space(grid, order, device=device, dtype=dtype)
        products_wanted = (tuple(only_these_products) if only_these_products is not None
                           else _ALL_PRODUCTS)
        # P1 nodal structure: the dofs are the vertices
        dir_vert = boundary_info.dirichlet_vertices
        dir_mask = torch.as_tensor(dir_vert).to(device)
        vertices = space.tensor(grid.vertices)
        pattern = volume_pattern(space)

        # -- dirichlet projection per affine dirichlet component (cg.hh:193-221)
        dirichlet_vec = AffineDecomposition()
        for g_fn, coef in _parts(problem.dirichlet):
            g = torch.where(dir_mask, g_fn(vertices), vertices.new_zeros(()))
            if coef is None:
                dirichlet_vec.register_affine_part(g)
            else:
                dirichlet_vec.register_component(g, coef)
        if dirichlet_vec.affine_part is None:
            dirichlet_vec.register_affine_part(
                torch.zeros(space.num_dofs, dtype=dtype, device=device))

        # -- elliptic operator per diffusion component (cg.hh:223-247)
        operator = AffineDecomposition()
        for (lam_fn, kap_fn), coef in _parts(diffusion_pairs(problem)):
            mat = assemble_cell_matrix(space, elliptic_cell_matrices(space, lam_fn, kap_fn),
                                       pattern)
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

        for f_fn, coef in _parts(problem.force):
            local = force_cell_vectors(space, f_fn)
            add_rhs(scatter_cell_vectors(local, space.cell_dofs, space.num_dofs), coef)
        neumann_faces = np.nonzero(boundary_info.neumann_faces)[0]
        if len(neumann_faces):
            for g_fn, coef in _parts(problem.neumann):
                add_rhs(boundary_face_functional(space, g_fn, neumann_faces), coef)
        if rhs.affine_part is None:
            rhs.register_affine_part(torch.zeros(space.num_dofs, dtype=dtype, device=device))

        # -- products (cg.hh:291-330); unconstrained
        products: Dict[str, AffineDecomposition] = {}
        if "l2" in products_wanted:
            products["l2"] = AffineDecomposition(
                affine_part=assemble_cell_matrix(space, l2_cell_matrices(space), pattern))
        if "h1_semi" in products_wanted:
            products["h1_semi"] = AffineDecomposition(affine_part=assemble_cell_matrix(
                space, elliptic_cell_matrices(space, ConstantFunction(1.0), constant_matrix(1.0)),
                pattern))
        if "energy" in products_wanted:
            # same affine family as the (unconstrained) operator
            products["energy"] = AffineDecomposition(
                list(operator.components), list(operator.coefficients), operator.affine_part)

        # -- dirichlet shift rhs -= A_p g_q with coefficient products
        # (cg.hh:336-374), done on the *unconstrained* operator
        if boundary_info.has_dirichlet:
            for mat, mcoef in _parts(operator):
                for g, gcoef in _parts(dirichlet_vec):
                    shift = -mat.matvec(g)
                    if mcoef is None or gcoef is None:
                        add_rhs(shift, gcoef if mcoef is None else mcoef)
                    else:
                        add_rhs(shift, ProductFunctional(mcoef, gcoef))

        # -- constraints (cg.hh:377-397) + symmetric column elimination
        if boundary_info.has_dirichlet:
            operator = AffineDecomposition(
                [c.with_constrained_rows(dir_vert, unit_diagonal=False)
                 .with_constrained_cols(dir_vert, keep_unit_diag=False)
                 for c in operator.components],
                list(operator.coefficients),
                operator.affine_part.with_constrained_rows(dir_vert, unit_diagonal=True)
                .with_constrained_cols(dir_vert, keep_unit_diag=True),
            )
            zero = vertices.new_zeros(())
            rhs = AffineDecomposition(
                [torch.where(dir_mask, zero, c) for c in rhs.components],
                list(rhs.coefficients),
                torch.where(dir_mask, zero, rhs.affine_part),
            )

        super().__init__(
            space=space,
            boundary_info=boundary_info,
            problem=problem,
            operator=operator,
            rhs=rhs,
            products=products,
            vectors={"dirichlet": dirichlet_vec},
            purely_neumann=not boundary_info.has_dirichlet,
        )

    def init(self):  # API parity with the reference's lazy init (cg.hh:177)
        return self

    def solve_with_dirichlet_shift(self, mu=None, options=None) -> torch.Tensor:
        """Full solution u = u_0 + g (the reference keeps u_0 internally and
        re-adds g in visualize, base.hh:125-147)."""
        mu_p = self.problem.parse_parameter(mu) if mu is not None else {}
        u0 = self.solve(mu, options)
        g = self._vectors["dirichlet"].freeze(mu_p)
        return u0 + g
