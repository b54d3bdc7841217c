"""ZeroBoundary wrapper: any problem with its Dirichlet and Neumann data
replaced by zero, which makes the subdomain-local problems of the block
discretization purely interior.  Counterpart of
``dune_hdd_tpu/problems/zero_boundary.py``."""
from __future__ import annotations

from ..functions.base import ConstantFunction, nonparametric
from .interfaces import Problem

__all__ = ["ZeroBoundaryProblem"]


class ZeroBoundaryProblem(Problem):
    static_id = Problem.static_id + ".zero-boundary"

    def __init__(self, problem: Problem):
        self.wrapped = problem
        super().__init__(
            diffusion_factor=problem.diffusion_factor,
            diffusion_tensor=problem.diffusion_tensor,
            force=problem.force,
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )
