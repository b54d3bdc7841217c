"""Thermalblock test cases.  Counterpart of
``dune_hdd_tpu/testcases/thermalblock.py``: a (2, 2) checkerboard by default
on the unit square, all Dirichlet, required parameters mu, mu_bar and
mu_hat, the parameter range [0.1, 1] added for the estimators as
parameter_range_min / parameter_range_max vectors."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from ..grid.multiscale import MultiscaleGrid
from ..problems.thermalblock import ThermalblockProblem
from .base import TestCaseBase, make_cube_hierarchy

__all__ = ["ThermalblockTestCase", "BlockThermalblockTestCase"]

_REQUIRED = {"mu": "mu", "mu_bar": "mu", "mu_hat": "mu"}


class ThermalblockTestCase(TestCaseBase):
    name = "thermalblock"
    default_num_refinements = 3
    parameter_range = (0.1, 1.0)

    def __init__(self, parameters: Mapping, num_blocks: Sequence[int] = (2, 2),
                 num_refinements: int = default_num_refinements,
                 grid_variant: str = "alu_conforming"):
        self.grid_variant = grid_variant
        self.num_blocks = tuple(int(n) for n in num_blocks)[:2]
        hierarchy = make_cube_hierarchy((0.0, 0.0), (1.0, 1.0), (4, 4), grid_variant,
                                        initial_refinements=2 if grid_variant == "alu_conforming"
                                        else 1, num_levels=num_refinements + 1)
        super().__init__(problem=ThermalblockProblem(self.num_blocks), hierarchy=hierarchy,
                         boundary_info_cfg={"type": "stuff.grid.boundaryinfo.alldirichlet"},
                         exact_solution=None, num_refinements=num_refinements,
                         required_parameters=_REQUIRED, parameters=parameters)

    def estimator_parameters(self) -> dict:
        lo, hi = self.parameter_range
        n = self.num_blocks[0] * self.num_blocks[1]
        out = dict(self.parameters)
        out.setdefault("parameter_range_min", self.problem.parse_parameter(np.full(n, lo)))
        out.setdefault("parameter_range_max", self.problem.parse_parameter(np.full(n, hi)))
        return out


class BlockThermalblockTestCase(ThermalblockTestCase):
    name = "thermalblock.block"

    def __init__(self, parameters: Mapping, num_blocks: Sequence[int] = (2, 2),
                 num_partitions: Sequence[int] = (2, 2),
                 num_refinements: int = ThermalblockTestCase.default_num_refinements,
                 oversampling_layers: int = 0, grid_variant: str = "alu_conforming"):
        super().__init__(parameters, num_blocks, num_refinements, grid_variant)
        self.num_partitions = tuple(int(n) for n in num_partitions)
        self.oversampling_layers = int(oversampling_layers)

    def ms_grid(self, refinement: int) -> MultiscaleGrid:
        return MultiscaleGrid(self.level_grid(refinement), self.num_partitions,
                              self.oversampling_layers)
