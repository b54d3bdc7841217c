"""ESV2007 test case: [-1,1]^2, all Dirichlet, 4x4 cube grid, exact
solution cos(pi/2 x) cos(pi/2 y).  Counterpart of
``dune_hdd_tpu/testcases/esv2007.py``: the ALU-conforming variant's level 0
has 128 conforming triangles (2 initial bisections), the "simplex" and
"cube" variants' 1 red refinement (128 triangles / 64 quads)."""
from __future__ import annotations

from ..functions.esv2007 import Testcase1ExactSolution
from ..problems.esv2007 import ESV2007Problem
from .base import TestCaseBase, make_cube_hierarchy

__all__ = ["ESV2007TestCase"]


class ESV2007TestCase(TestCaseBase):
    name = "ESV2007"
    default_num_refinements = 3

    def __init__(self, num_refinements: int = default_num_refinements,
                 grid_variant: str = "alu_conforming"):
        self.grid_variant = grid_variant
        initial = 2 if grid_variant == "alu_conforming" else 1
        hierarchy = make_cube_hierarchy((-1.0, -1.0), (1.0, 1.0), (4, 4), grid_variant,
                                        initial_refinements=initial,
                                        num_levels=num_refinements + 1)
        super().__init__(problem=ESV2007Problem(), hierarchy=hierarchy,
                         boundary_info_cfg={"type": "stuff.grid.boundaryinfo.alldirichlet"},
                         exact_solution=Testcase1ExactSolution(),
                         num_refinements=num_refinements)

    def print_header(self, out=None) -> str:
        header = (
            "+==================================================================+\n"
            "|+================================================================+|\n"
            "||  Testcase ESV2007: smooth data, homogeneous dirichlet          ||\n"
            "||  (see testcase 1, page 23 in Ern, Stephansen, Vohralik, 2007)  ||\n"
            "|+----------------------------------------------------------------+|\n"
            "||  domain = [-1, 1] x [-1, 1]                                    ||\n"
            "||  diffusion = 1                                                 ||\n"
            "||  force     = 1/2 pi^2 cos(1/2 pi x) cos(1/2 pi y)              ||\n"
            "||  dirichlet = 0                                                 ||\n"
            "||  exact solution = cos(1/2 pi x) cos(1/2 pi y)                  ||\n"
            "|+================================================================+|\n"
            "+==================================================================+"
        )
        if out is not None:
            print(header, file=out)
        return header
