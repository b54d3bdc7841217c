"""Thermalblock problems.  Counterpart of
``dune_hdd_tpu/problems/thermalblock.py``.

* Thermalblock: checkerboard diffusion factor with one parameter entry per
  block (d = 1, 2, 3 from the length of ``num_blocks``).
* LocalThermalblock: 3 parameters over irregular indicator regions.
"""
from __future__ import annotations

from typing import Sequence

from ..affine import AffineDecomposition
from ..functions.base import (
    ConstantFunction,
    IndicatorFunction,
    constant_matrix,
    make_checkerboard_decomposition,
    nonparametric,
)
from ..parameters import ParameterFunctional, ParameterType
from .default import DefaultProblem

__all__ = ["ThermalblockProblem", "LocalThermalblockProblem"]


class ThermalblockProblem(DefaultProblem):
    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".thermalblock"

    def __init__(self, num_blocks: Sequence[int] = (4, 4), lower_left=None, upper_right=None,
                 parameter_name: str = "diffusion_factor"):
        self.num_blocks = tuple(int(n) for n in num_blocks)
        d = len(self.num_blocks)
        if not 1 <= d <= 3:
            raise ValueError(f"num_blocks must have length 1..3, got {d}")
        lower_left = (0.0,) * d if lower_left is None else tuple(lower_left)[:d]
        upper_right = (1.0,) * d if upper_right is None else tuple(upper_right)[:d]
        diffusion = make_checkerboard_decomposition(
            lower_left, upper_right, self.num_blocks, parameter_name, name="diffusion_factor")
        super().__init__(
            diffusion_factor=diffusion,
            diffusion_tensor=nonparametric(constant_matrix(1.0, dim=d)),
            force=nonparametric(ConstantFunction(1.0, "force")),
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {"diffusion_factor": {"num_elements": [4, 4, 4]}}

    @classmethod
    def create(cls, config=None) -> "ThermalblockProblem":
        cfg = dict(config or {})
        sub = dict(cfg.get("diffusion_factor", {}))
        ne = sub.get("num_elements", [4, 4, 4])
        dim = int(cfg.get("dim", sub.get("dim", 2)))
        return cls(num_blocks=ne[:dim], lower_left=sub.get("lower_left", (0.0,) * dim),
                   upper_right=sub.get("upper_right", (1.0,) * dim))


class LocalThermalblockProblem(DefaultProblem):
    """Three-parameter thermal block over irregular regions."""

    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".localthermalblock"

    def __init__(self):
        pt = ParameterType({"diffusion_factor": 3})
        dec = AffineDecomposition()
        left_block = IndicatorFunction(
            [
                ((0.0, 0.0), (0.5, 0.16), 1.0),
                ((0.0, 0.16), (0.16, 0.33), 1.0),
                ((0.33, 0.16), (0.5, 0.33), 1.0),
                ((0.0, 0.33), (0.5, 1.0), 1.0),
            ],
            name="left_block",
        )
        right_block = IndicatorFunction([((0.5, 0.0), (1.0, 1.0), 1.0)], name="right_block")
        small_block = IndicatorFunction([((0.16, 0.16), (0.33, 0.33), 1.0)], name="small_block")
        dec.register_component(left_block, ParameterFunctional(pt, "diffusion_factor[0]"))
        dec.register_component(right_block, ParameterFunctional(pt, "diffusion_factor[1]"))
        dec.register_component(small_block, ParameterFunctional(pt, "diffusion_factor[2]"))
        super().__init__(
            diffusion_factor=dec,
            diffusion_tensor=nonparametric(constant_matrix(1.0)),
            force=nonparametric(ConstantFunction(1.0, "force")),
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {}

    @classmethod
    def create(cls, config=None) -> "LocalThermalblockProblem":
        return cls()
