"""MixedBoundaries problem (reference: problems/mixed-boundaries.hh:24-124):
unit diffusion, force 1, Dirichlet 0.25*x0*x1, Neumann 0.1.  Counterpart of
``dune_hdd_tpu/problems/mixed_boundaries.py``."""
from __future__ import annotations

from ..functions.base import ConstantFunction, ExpressionFunction, constant_matrix, nonparametric
from .default import DefaultProblem

__all__ = ["MixedBoundariesProblem"]


class MixedBoundariesProblem(DefaultProblem):
    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".mixedboundaries"

    def __init__(self):
        super().__init__(
            diffusion_factor=nonparametric(ConstantFunction(1.0, "diffusion_factor")),
            diffusion_tensor=nonparametric(constant_matrix(1.0)),
            force=nonparametric(ConstantFunction(1.0, "force")),
            dirichlet=nonparametric(ExpressionFunction("0.25*x[0]*x[1]", 2, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.1, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {}

    @classmethod
    def create(cls, config=None) -> "MixedBoundariesProblem":
        return cls()

    def type(self) -> str:
        return self.static_id
