"""OS2014 parametric ESV2007 problem.  Counterpart of
``dune_hdd_tpu/problems/os2014.py``:

    diffusion_factor(x; mu) = [1 + 0.75 sin(4 pi (x0 + x1/2))]      (affine part)
                            + mu [-0.75 sin(4 pi (x0 + x1/2))]      (theta = mu)

so mu = 1 gives unit diffusion and mu -> 0 the full sine perturbation.
"""
from __future__ import annotations

from ..affine import AffineDecomposition
from ..functions.base import ConstantFunction, ExpressionFunction, constant_matrix, nonparametric
from ..functions.esv2007 import Testcase1Force
from ..parameters import ParameterFunctional
from .default import DefaultProblem

__all__ = ["ParametricESV2007Problem"]


def _create_diffusion_factor(integration_order: int) -> AffineDecomposition:
    dec = AffineDecomposition(affine_part=ExpressionFunction(
        "1+0.75*(sin(4*pi*(x[0]+0.5*x[1])))", integration_order, "affine_part"))
    dec.register_component(
        ExpressionFunction("-0.75*(sin(4*pi*(x[0]+0.5*x[1])))", integration_order,
                           "component_0"),
        ParameterFunctional(("mu", 1), "mu"))
    return dec


class ParametricESV2007Problem(DefaultProblem):
    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".OS2014.parametricESV2007"

    def __init__(self, integration_order: int = 3):
        super().__init__(
            diffusion_factor=_create_diffusion_factor(integration_order),
            diffusion_tensor=nonparametric(constant_matrix(1.0)),
            force=nonparametric(Testcase1Force(integration_order, "force")),
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {"integration_order": 3}

    @classmethod
    def create(cls, config=None) -> "ParametricESV2007Problem":
        cfg = dict(config or {})
        return cls(int(cfg.get("integration_order", 3)))
