"""Dimension-generic CG test case (d = 1, 2, 3).

Counterpart of ``dune_hdd_tpu/testcases/tensor.py``: the manufactured
solution ``u = prod_a sin(pi x_a)`` on [0,1]^d with zero Dirichlet data and
``f = d pi^2 u`` on a TensorGrid hierarchy; Q1 converges at EOC 2 in L2 and
1 in H1_semi (the reference runs its CG example on SGrid<1,1> / <2,2> /
<3,3>, examples/linearelliptic/cg.cc:19-21).
"""
from __future__ import annotations

import math

import torch

from ..functions.base import ConstantFunction, Function, constant_matrix, nonparametric
from ..grid.tensor import TensorGridHierarchy, tensor_grid
from ..problems.interfaces import Problem
from .base import TestCaseBase

__all__ = ["TensorSineTestcase", "TensorSineExactSolution"]


class TensorSineExactSolution(Function):
    """u(x) = prod_a sin(pi x_a); closed-form gradient."""

    range_shape = ()
    order = 8
    name = "exact_solution"

    def __init__(self, dim: int):
        self.dim = int(dim)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.prod(torch.sin(math.pi * x), dim=-1)

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        comps = []
        for a in range(self.dim):
            g = math.pi * torch.cos(math.pi * x[..., a])
            for b in range(self.dim):
                if b != a:
                    g = g * torch.sin(math.pi * x[..., b])
            comps.append(g)
        return torch.stack(comps, dim=-1)


class _TensorSineForce(Function):
    range_shape = ()
    order = 8
    name = "force"

    def __init__(self, dim: int):
        self.dim = int(dim)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.dim * math.pi ** 2 * torch.prod(torch.sin(math.pi * x), dim=-1)


class TensorSineTestcase(TestCaseBase):
    """Unit-diffusion Dirichlet problem on [0,1]^d with exact solution."""

    name = "tensor_sine"

    def __init__(self, dim: int, initial_cells: int = 4, num_refinements: int = 2):
        self.dim = int(dim)
        problem = Problem(
            nonparametric(ConstantFunction(1.0, "diffusion_factor")),
            nonparametric(constant_matrix(1.0, dim=dim)),
            nonparametric(_TensorSineForce(dim)),
            nonparametric(ConstantFunction(0.0, "dirichlet")),
            nonparametric(ConstantFunction(0.0, "neumann")),
        )
        base = tensor_grid([0.0] * dim, [1.0] * dim, [initial_cells] * dim)
        hierarchy = TensorGridHierarchy(base, num_refinements + 1)
        super().__init__(
            problem,
            hierarchy,
            boundary_info_cfg={"type": "stuff.grid.boundaryinfo.alldirichlet"},
            exact_solution=TensorSineExactSolution(dim),
            num_refinements=num_refinements,
        )
