"""OS2014 parametric convergence test cases.  Counterpart of
``dune_hdd_tpu/testcases/os2014.py``: the parametric ESV2007 problem on
[-1,1]^2 (all Dirichlet), required parameters mu, mu_bar, mu_hat and
mu_minimizing of type ("mu", 1), parameter range [0.1, 1], the finest
discrete solution as reference.  The multiscale variant adds the
partitioned grid."""
from __future__ import annotations

from typing import Mapping, Sequence

from ..grid.multiscale import MultiscaleGrid
from ..problems.os2014 import ParametricESV2007Problem
from .base import TestCaseBase, make_cube_hierarchy

__all__ = ["OS2014TestCase", "OS2014MultiscaleTestCase"]

_REQUIRED = {"mu": "mu", "mu_bar": "mu", "mu_hat": "mu", "mu_minimizing": "mu"}


class OS2014TestCase(TestCaseBase):
    name = "OS2014"
    default_num_refinements = 3
    parameter_range = (0.1, 1.0)

    def __init__(self, parameters: Mapping, num_refinements: int = default_num_refinements,
                 grid_variant: str = "alu_conforming"):
        self.grid_variant = grid_variant
        hierarchy = make_cube_hierarchy((-1.0, -1.0), (1.0, 1.0), (4, 4), grid_variant,
                                        initial_refinements=2 if grid_variant == "alu_conforming"
                                        else 1, num_levels=num_refinements + 1)
        super().__init__(problem=ParametricESV2007Problem(), hierarchy=hierarchy,
                         boundary_info_cfg={"type": "stuff.grid.boundaryinfo.alldirichlet"},
                         exact_solution=None, num_refinements=num_refinements,
                         required_parameters=_REQUIRED, parameters=parameters)

    def estimator_parameters(self) -> dict:
        """The parameters handed to the OS2014 estimators, with the
        parameter range as parameter_range_min / parameter_range_max."""
        lo, hi = self.parameter_range
        out = dict(self.parameters)
        out.setdefault("parameter_range_min", self.problem.parse_parameter(lo))
        out.setdefault("parameter_range_max", self.problem.parse_parameter(hi))
        return out


class OS2014MultiscaleTestCase(OS2014TestCase):
    name = "OS2014.block"

    def __init__(self, parameters: Mapping, num_partitions: Sequence[int] = (1, 1),
                 num_refinements: int = OS2014TestCase.default_num_refinements,
                 oversampling_layers: int = 0, grid_variant: str = "alu_conforming",
                 H_with_h: bool = False):
        super().__init__(parameters, num_refinements, grid_variant)
        self.num_partitions = tuple(int(n) for n in num_partitions)
        self.oversampling_layers = int(oversampling_layers)
        self.H_with_h = bool(H_with_h)

    def partitioning(self) -> str:
        base = f"[{self.num_partitions[0]} {self.num_partitions[1]} 1]"
        return base + ("_H_with_h" if self.H_with_h else "")

    def ms_grid(self, refinement: int) -> MultiscaleGrid:
        parts = self.num_partitions
        if self.H_with_h:
            # the partitions refine with the mesh: x 2^refinement
            parts = tuple(p * 2**refinement for p in parts)
        return MultiscaleGrid(self.level_grid(refinement), parts, self.oversampling_layers)
