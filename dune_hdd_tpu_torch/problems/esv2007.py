"""ESV2007 testcase-1 problem: unit diffusion, force pi^2/2 cos(pi/2 x)
cos(pi/2 y), zero Dirichlet/Neumann.  Counterpart of
``dune_hdd_tpu/problems/esv2007.py``."""
from __future__ import annotations

from ..functions.base import ConstantFunction, constant_matrix, nonparametric
from ..functions.esv2007 import Testcase1Force
from .default import DefaultProblem

__all__ = ["ESV2007Problem"]


class ESV2007Problem(DefaultProblem):
    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".ESV2007"

    def __init__(self, integration_order: int = 3):
        super().__init__(
            diffusion_factor=nonparametric(ConstantFunction(1.0, "diffusion_factor")),
            diffusion_tensor=nonparametric(constant_matrix(1.0)),
            force=nonparametric(Testcase1Force(integration_order, "force")),
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {"integration_order": 3}

    @classmethod
    def create(cls, config=None) -> "ESV2007Problem":
        cfg = dict(config or {})
        return cls(int(cfg.get("integration_order", 3)))
