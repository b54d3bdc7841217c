"""Default problem: a concrete Problem from five function objects, with a
config-driven factory.  Counterpart of ``dune_hdd_tpu/problems/default.py``."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ..functions.base import (
    CheckerboardFunction,
    ConstantFunction,
    ExpressionFunction,
    IndicatorFunction,
    constant_matrix,
    nonparametric,
)
from .interfaces import Problem

__all__ = ["DefaultProblem", "create_function_from_config"]


def create_function_from_config(cfg: Mapping, default_range="scalar"):
    """A Function from a config sub-dict; ``type`` values follow the
    dune-stuff static ids."""
    t = str(cfg.get("type", "stuff.function.constant")).lower()
    name = cfg.get("name", "function")
    if t.endswith("constant"):
        value = cfg.get("value", 1.0)
        if default_range == "matrix":
            value = np.asarray(value, dtype=float)
            dim = int(cfg.get("dim", 2))
            if value.ndim == 0:
                return constant_matrix(float(value), name=name, dim=dim)
            return ConstantFunction(value.reshape(dim, dim), name=name)
        return ConstantFunction(float(np.asarray(value).ravel()[0]), name=name)
    if t.endswith("expression"):
        return ExpressionFunction(cfg.get("expression", "0"), order=int(cfg.get("order", 2)),
                                  name=name)
    if t.endswith("checkerboard"):
        lower = cfg.get("lower_left", (0.0, 0.0))
        upper = cfg.get("upper_right", (1.0, 1.0))
        ne = cfg.get("num_elements", (2, 2))[:2]
        values = cfg.get("values", np.ones(int(np.prod(ne))))
        return CheckerboardFunction(lower, upper, ne, values, name=name)
    if t.endswith("indicator"):
        return IndicatorFunction(cfg.get("values", []), name=name)
    raise ValueError(f"unknown function type {t!r}")


class DefaultProblem(Problem):
    static_id = Problem.static_id + ".default"

    def __init__(self, diffusion_factor=None, diffusion_tensor=None, force=None,
                 dirichlet=None, neumann=None):
        super().__init__(
            diffusion_factor if diffusion_factor is not None
            else nonparametric(ConstantFunction(1.0, "diffusion_factor")),
            diffusion_tensor if diffusion_tensor is not None
            else nonparametric(constant_matrix(1.0)),
            force if force is not None else nonparametric(ConstantFunction(1.0, "force")),
            dirichlet if dirichlet is not None
            else nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann if neumann is not None
            else nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {
            "diffusion_factor": {"type": "stuff.function.constant", "value": 1.0,
                                 "name": "diffusion_factor"},
            "diffusion_tensor": {"type": "stuff.function.constant", "value": 1.0,
                                 "name": "diffusion_tensor"},
            "force": {"type": "stuff.function.constant", "value": 1.0, "name": "force"},
            "dirichlet": {"type": "stuff.function.constant", "value": 0.0, "name": "dirichlet"},
            "neumann": {"type": "stuff.function.constant", "value": 0.0, "name": "neumann"},
        }

    @classmethod
    def create(cls, config: Optional[Mapping] = None) -> "DefaultProblem":
        cfg = dict(cls.default_config())
        for k, v in dict(config or {}).items():
            cfg[k] = v
        return cls(
            diffusion_factor=nonparametric(
                create_function_from_config(cfg["diffusion_factor"], "scalar")),
            diffusion_tensor=nonparametric(
                create_function_from_config(cfg["diffusion_tensor"], "matrix")),
            force=nonparametric(create_function_from_config(cfg["force"], "scalar")),
            dirichlet=nonparametric(create_function_from_config(cfg["dirichlet"], "scalar")),
            neumann=nonparametric(create_function_from_config(cfg["neumann"], "scalar")),
        )
