"""Test-case base classes.

Counterpart of ``dune_hdd_tpu/testcases/base.py``: a problem, a
boundary-info config, a grid refinement hierarchy with one extra reference
level, optionally an exact solution, and for parametric cases the required
parameter map (mu, mu_bar, mu_hat, ...).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from ..grid.hierarchy import GridHierarchy
from ..grid.structured import Grid, alu_cube_grid, bisect, rectangle_grid, refine
from ..parameters import Parameter, parse_parameter
from ..problems.interfaces import Problem

__all__ = ["TestCaseBase", "make_cube_hierarchy"]


def make_cube_hierarchy(lower, upper, num_elements, grid_variant: str,
                        initial_refinements: int, num_levels: int) -> GridHierarchy:
    """Grid hierarchy for a cube-provider test case.  ``"alu_conforming"``:
    triangles, newest-vertex bisection, 2 steps per level (1 initial
    refinement is 1 bisection step); ``"simplex"``: diagonal-split
    triangles, red refinement, 1 step per level; ``"cube"``: quads (SGrid),
    red refinement, 1 step per level."""
    if grid_variant == "alu_conforming":
        g = alu_cube_grid(lower, upper, num_elements, refinements=initial_refinements)
        return GridHierarchy(g, num_levels, refine_fn=bisect, steps_per_level=2)
    g = rectangle_grid(lower, upper, num_elements,
                       "triangle" if grid_variant == "simplex" else "quad")
    for _ in range(initial_refinements):
        g, _ = refine(g)
    return GridHierarchy(g, num_levels, refine_fn=refine, steps_per_level=1)


class TestCaseBase:
    name = "testcase"

    def __init__(
        self,
        problem: Problem,
        hierarchy: GridHierarchy,
        boundary_info_cfg: Optional[Mapping] = None,
        exact_solution=None,
        num_refinements: Optional[int] = None,
        required_parameters: Optional[Dict[str, str]] = None,
        parameters: Optional[Mapping] = None,
    ):
        self.problem = problem
        self.hierarchy = hierarchy
        self.boundary_info_cfg = dict(
            boundary_info_cfg or {"type": "stuff.grid.boundaryinfo.alldirichlet"})
        self.exact_solution = exact_solution
        # hierarchy has num_refinements + 1 study levels + 1 reference level
        self.num_refinements = (num_refinements if num_refinements is not None
                                else len(hierarchy) - 2)
        self.required_parameters = dict(required_parameters or {})
        self.parameters: Dict[str, Parameter] = {}
        if self.required_parameters:
            given = dict(parameters or {})
            pt = problem.parameter_type
            for name in self.required_parameters:
                if name not in given:
                    raise ValueError(f"missing required parameter {name!r}")
                mu = parse_parameter(given[name], pt)
                for comp in pt:
                    if comp not in mu or np.asarray(mu[comp]).size != pt[comp]:
                        raise ValueError(f"parameter {name!r} does not match type {pt!r}")
                self.parameters[name] = mu

    def level_grid(self, refinement: int) -> Grid:
        if not 0 <= refinement <= self.num_refinements:
            raise ValueError(f"refinement {refinement} out of range")
        return self.hierarchy[refinement]

    @property
    def reference_grid(self) -> Grid:
        return self.hierarchy.reference

    @property
    def reference_level(self) -> int:
        return len(self.hierarchy) - 1

    def provides_exact_solution(self) -> bool:
        return self.exact_solution is not None

    def boundary_info(self):
        return self.boundary_info_cfg

    def print_header(self, out=None) -> str:
        header = f"Testcase {self.name}"
        if out is not None:
            print(header, file=out)
        return header
