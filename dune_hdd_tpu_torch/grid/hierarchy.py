"""Refinement hierarchies (host numpy).

Counterpart of ``GridHierarchy`` and ``prolong_vertex_values`` in
``dune_hdd_tpu/grid/hierarchy.py`` (the string-keyed ``GridProviders``
factory waits for the quad grids, ROADMAP queue 1, slice 2).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .structured import Grid, RefinementInfo, refine

__all__ = ["GridHierarchy", "prolong_vertex_values"]


class GridHierarchy:
    """grids[0..L] produced by uniform refinement; ``reference`` (the finest)
    is the reference grid of the EOC studies.  ``steps_per_level`` refine
    steps make one level (2 newest-vertex bisections halve h); each level
    keeps the list of its per-step RefinementInfos."""

    def __init__(self, initial: Grid, num_levels: int, refine_fn=refine,
                 steps_per_level: int = 1):
        self.grids: List[Grid] = [initial]
        self.level_infos: List[List[RefinementInfo]] = []
        for _ in range(num_levels):
            g = self.grids[-1]
            steps = []
            for _ in range(steps_per_level):
                g, info = refine_fn(g)
                steps.append(info)
            self.grids.append(g)
            self.level_infos.append(steps)

    def __len__(self):
        return len(self.grids)

    def __getitem__(self, level: int) -> Grid:
        return self.grids[level]

    @property
    def reference(self) -> Grid:
        return self.grids[-1]

    def info(self, level: int) -> RefinementInfo:
        """Single-step refinement info from ``level`` to ``level+1``."""
        steps = self.level_infos[level]
        if len(steps) != 1:
            raise ValueError("level has multiple refinement steps; use infos()")
        return steps[0]

    def infos(self, level: int) -> List[RefinementInfo]:
        return self.level_infos[level]

    def parent_cells(self, coarse_level: int, fine_level: int) -> np.ndarray:
        """[NC_fine] map from fine cells to their coarse-level ancestors."""
        fine = self.grids[fine_level]
        parent = np.arange(fine.num_cells, dtype=np.int64)
        for lvl in range(fine_level - 1, coarse_level - 1, -1):
            for info in reversed(self.level_infos[lvl]):
                parent = info.parent_cell[parent]
        return parent


def prolong_vertex_values(values, info: RefinementInfo):
    """P1 prolongation: new vertices are midpoints of their two parents, so
    a piecewise-linear function prolongs by averaging.  numpy arrays or
    tensors; values may have trailing feature dims."""
    return 0.5 * (values[info.vertex_parents[:, 0]] + values[info.vertex_parents[:, 1]])
