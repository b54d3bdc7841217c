"""SPE10 model-1 test cases.  Counterpart of ``dune_hdd_tpu/testcases/spe10.py``:
[0,5] x [0,1], the 100 x 20 cube grid (1 initial bisection), all Dirichlet,
one refinement by default, the finest discrete solution as reference.
Model1 uses the problem's default configuration (no channel); the
parametric variants use the 105 sharp channel boxes of ``_spe10_channel``
with the parametric channel and the four required mu parameters.  The block
variants add the partitioned grid ([20 4 1] by default)."""
from __future__ import annotations

from typing import Mapping, Sequence

from ..grid.multiscale import MultiscaleGrid
from ..problems.spe10 import Spe10Model1Problem
from ._spe10_channel import CHANNEL
from .base import TestCaseBase, make_cube_hierarchy

__all__ = ["Spe10Model1TestCase", "Spe10ParametricModel1TestCase", "Spe10BlockModel1TestCase",
           "Spe10ParametricBlockModel1TestCase"]

_REQUIRED = {"mu": "mu", "mu_bar": "mu", "mu_hat": "mu", "mu_minimizing": "mu"}
_BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}


def _spe10_hierarchy(grid_variant: str, num_refinements: int, num_elements=(100, 20)):
    return make_cube_hierarchy((0.0, 0.0), (5.0, 1.0), num_elements, grid_variant,
                               initial_refinements=1, num_levels=num_refinements + 1)


class Spe10Model1TestCase(TestCaseBase):
    name = "spe10.model1"
    default_num_refinements = 1
    parameter_range = (0.1, 1.0)

    def __init__(self, num_refinements: int = default_num_refinements,
                 grid_variant: str = "alu_conforming", filename: str = "perm_case1.dat",
                 num_elements=(100, 20)):
        self.grid_variant = grid_variant
        super().__init__(problem=Spe10Model1Problem(filename=filename),
                         hierarchy=_spe10_hierarchy(grid_variant, num_refinements, num_elements),
                         boundary_info_cfg=_BI, exact_solution=None,
                         num_refinements=num_refinements)


class Spe10ParametricModel1TestCase(TestCaseBase):
    name = "spe10.parametric_model1"
    default_num_refinements = 1
    parameter_range = (0.1, 1.0)

    def __init__(self, parameters: Mapping, num_refinements: int = default_num_refinements,
                 grid_variant: str = "alu_conforming", filename: str = "perm_case1.dat"):
        self.grid_variant = grid_variant
        problem = Spe10Model1Problem(filename=filename, channel_values=CHANNEL,
                                     channel_boundary_layer=(0.0, 0.0), parametric_channel=True)
        super().__init__(problem=problem,
                         hierarchy=_spe10_hierarchy(grid_variant, num_refinements),
                         boundary_info_cfg=_BI, exact_solution=None,
                         num_refinements=num_refinements, required_parameters=_REQUIRED,
                         parameters=parameters)

    def estimator_parameters(self) -> dict:
        lo, hi = self.parameter_range
        out = dict(self.parameters)
        out.setdefault("parameter_range_min", self.problem.parse_parameter(lo))
        out.setdefault("parameter_range_max", self.problem.parse_parameter(hi))
        return out


class Spe10BlockModel1TestCase(Spe10Model1TestCase):
    name = "spe10.block_model1"

    def __init__(self, num_partitions: Sequence[int] = (20, 4),
                 num_refinements: int = Spe10Model1TestCase.default_num_refinements,
                 oversampling_layers: int = 0, grid_variant: str = "alu_conforming",
                 filename: str = "perm_case1.dat"):
        super().__init__(num_refinements, grid_variant, filename)
        self.num_partitions = tuple(int(n) for n in num_partitions)
        self.oversampling_layers = int(oversampling_layers)

    def ms_grid(self, refinement: int) -> MultiscaleGrid:
        return MultiscaleGrid(self.level_grid(refinement), self.num_partitions,
                              self.oversampling_layers)


class Spe10ParametricBlockModel1TestCase(Spe10ParametricModel1TestCase):
    name = "spe10.parametric_block_model1"

    def __init__(self, parameters: Mapping, num_partitions: Sequence[int] = (20, 4),
                 num_refinements: int = Spe10Model1TestCase.default_num_refinements,
                 oversampling_layers: int = 0, grid_variant: str = "alu_conforming",
                 filename: str = "perm_case1.dat"):
        super().__init__(parameters, num_refinements, grid_variant, filename)
        self.num_partitions = tuple(int(n) for n in num_partitions)
        self.oversampling_layers = int(oversampling_layers)

    def ms_grid(self, refinement: int) -> MultiscaleGrid:
        return MultiscaleGrid(self.level_grid(refinement), self.num_partitions,
                              self.oversampling_layers)
