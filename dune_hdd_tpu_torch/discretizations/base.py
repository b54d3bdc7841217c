"""Stationary discretization base: affine operator/rhs bundle + solve cache.

Counterpart of ``dune_hdd_tpu/discretizations/base.py``: AffineDecompositions
of SparseMatrix (operator, named products) and of vectors (rhs, named
vectors) on the space's device; ``solve`` freezes at mu and applies a solver
from the registry, memoized by (mu, solver options).  A purely-Neumann
system pins DoF 0 and subtracts the mean.  (``visualize`` waits for
``utils/vtk.py``, ROADMAP queue 1 slice 6.)
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..grid.boundaryinfo import BoundaryInfo
from ..la.solvers import solve as la_solve
from ..la.solvers import solver_options, solver_types
from ..la.sparse import SparseMatrix
from ..ops.spaces import Space
from ..parameters import Parameter, ParameterType, parameter_key, parse_parameter
from ..problems.interfaces import Problem

__all__ = ["StationaryDiscretization"]


class StationaryDiscretization:
    """Affine-algebra core: operator, rhs, products and vectors."""

    def __init__(
        self,
        space: Space,
        boundary_info: BoundaryInfo,
        problem: Problem,
        operator: AffineDecomposition,  # of SparseMatrix
        rhs: AffineDecomposition,  # of vectors
        products: Optional[Dict[str, AffineDecomposition]] = None,
        vectors: Optional[Dict[str, AffineDecomposition]] = None,
        purely_neumann: bool = False,
    ):
        self.space = space
        self.boundary_info = boundary_info
        self.problem = problem
        self._operator = operator
        self._rhs = rhs
        self._products = products or {}
        self._vectors = vectors or {}
        self.purely_neumann = purely_neumann
        self._cache: Dict = {}
        #: what the last uncached solve reports (solver type, iterations, ...)
        self.last_solve_info: Dict = {}

    @property
    def device(self) -> torch.device:
        return self.space.device

    def grid_view(self):
        return self.space.grid

    def test_space(self):
        return self.space

    def ansatz_space(self):
        return self.space

    def pattern(self):
        """The operator's sparsity pattern."""
        op = self._operator
        payload = op.affine_part if op.affine_part is not None else op.components[0]
        return payload.pattern

    @property
    def parameter_type(self) -> ParameterType:
        pt = self._operator.parameter_type | self._rhs.parameter_type
        for p in self._products.values():
            pt = pt | p.parameter_type
        return pt

    def parametric(self) -> bool:
        return not self.parameter_type.empty()

    def get_operator(self) -> AffineDecomposition:
        return self._operator

    def get_rhs(self) -> AffineDecomposition:
        return self._rhs

    def available_products(self) -> List[str]:
        return sorted(self._products)

    def get_product(self, name: str) -> AffineDecomposition:
        if name not in self._products:
            raise ValueError(f"unknown product {name!r}; available: {self.available_products()}")
        return self._products[name]

    def product_matrix(self, name: str, mu: Optional[Parameter] = None) -> SparseMatrix:
        return self.get_product(name).freeze(parse_parameter(mu, self.parameter_type))

    def available_vectors(self) -> List[str]:
        return sorted(self._vectors)

    def get_vector(self, name: str) -> AffineDecomposition:
        if name not in self._vectors:
            raise ValueError(f"unknown vector {name!r}; available: {self.available_vectors()}")
        return self._vectors[name]

    def create_vector(self) -> torch.Tensor:
        return torch.zeros(self.space.num_dofs, dtype=self.space.dtype, device=self.device)

    @staticmethod
    def solver_types() -> List[str]:
        return solver_types()

    @staticmethod
    def solver_options(type_: Optional[str] = None) -> Dict:
        return solver_options(type_)

    def freeze_operator(self, mu: Optional[Parameter] = None) -> SparseMatrix:
        return self._operator.freeze(parse_parameter(mu, self.parameter_type))

    def freeze_rhs(self, mu: Optional[Parameter] = None) -> torch.Tensor:
        return self._rhs.freeze(parse_parameter(mu, self.parameter_type))

    def solve(self, mu=None, options: Optional[Dict] = None) -> torch.Tensor:
        """Cached solve: one uncached solve per (mu, solver options)."""
        mu = parse_parameter(mu, self.parameter_type)
        key = (parameter_key(mu), tuple(sorted((options or {}).items())))
        if key in self._cache:
            return self._cache[key]
        u = self.uncached_solve(mu, options)
        self._cache[key] = u
        return u

    def uncached_solve(self, mu: Parameter, options: Optional[Dict] = None) -> torch.Tensor:
        rhs = self._rhs.freeze(mu)
        op = self._operator.freeze(mu)
        if self.purely_neumann:
            # pin DoF 0 (unit row, rhs 0), then subtract the mean afterwards
            mask = np.zeros(op.shape[0], dtype=bool)
            mask[0] = True
            op = op.with_constrained_rows(mask, unit_diagonal=True)
            op = op.with_constrained_cols(mask, keep_unit_diag=True)
            rhs = rhs.clone()
            rhs[0] = 0.0
        u = la_solve(op, rhs, options)
        self.last_solve_info = {"type": dict(options or {}).get("type", solver_types()[0])}
        if self.purely_neumann:
            u = u - torch.mean(u)
        return u
