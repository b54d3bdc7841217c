"""Refinement hierarchies and the string-keyed grid providers (host numpy).

Counterpart of ``dune_hdd_tpu/grid/hierarchy.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from .structured import Grid, RefinementInfo, alu_cube_grid, interval_grid, rectangle_grid, refine

__all__ = ["GridHierarchy", "prolong_vertex_values", "GridProviders"]


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


class GridProviders:
    """String-keyed grid factory (the reference's Stuff::GridProviders)."""

    _registry: Dict[str, Callable[..., Grid]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[..., Grid]):
        cls._registry[name] = factory

    @classmethod
    def available(cls) -> List[str]:
        return sorted(cls._registry)

    @classmethod
    def create(cls, name: str, config: Optional[Mapping] = None) -> Grid:
        if name not in cls._registry:
            raise ValueError(f"unknown grid provider {name!r}; available: {cls.available()}")
        return cls._registry[name](**dict(config or {}))


def _pair(v, kind):
    return (kind(v), kind(v)) if np.isscalar(v) else v


def _cube_provider(lower_left=(0.0, 0.0), upper_right=(1.0, 1.0), num_elements=(8, 8),
                   cell_type: str = "triangle", num_refinements: int = 0, **_ignored) -> Grid:
    g = rectangle_grid(_pair(lower_left, float), _pair(upper_right, float),
                       _pair(num_elements, int), cell_type)
    for _ in range(int(num_refinements)):
        g, _info = refine(g)
    return g


def _interval_provider(lower_left=0.0, upper_right=1.0, num_elements=8,
                       num_refinements: int = 0, **_ignored) -> Grid:
    """1D cube provider (the reference's SGrid<1,1> instantiations)."""
    def first(v):
        return float(np.atleast_1d(np.asarray(v, dtype=float))[0])

    g = interval_grid(first(lower_left), first(upper_right), int(first(num_elements)))
    for _ in range(int(num_refinements)):
        g, _info = refine(g)
    return g


GridProviders.register("stuff.grid.provider.cube", _cube_provider)
GridProviders.register("cube", _cube_provider)
GridProviders.register("stuff.grid.provider.interval", _interval_provider)
GridProviders.register("interval", _interval_provider)


def _alu_conforming_provider(lower_left=(0.0, 0.0), upper_right=(1.0, 1.0), num_elements=(4, 4),
                             num_refinements: int = 0, **_ignored) -> Grid:
    """The reference's ALUGrid<2, 2, simplex, conforming> cube provider:
    the criss triangulation with ``num_refinements`` global refinements,
    each one newest-vertex bisection (``alu_cube_grid``; 2 halve h).  With
    an even count its cells have the structured order of the plane layout,
    so SWIPDG's "stencil_cg" runs on the plane SpMV kernel.  The reference
    package registers no such provider: its cube provider always makes the
    red-refined rectangle split."""
    return alu_cube_grid(_pair(lower_left, float), _pair(upper_right, float),
                         _pair(num_elements, int), refinements=int(num_refinements))


GridProviders.register("stuff.grid.provider.alu_conforming", _alu_conforming_provider)
GridProviders.register("alu_conforming", _alu_conforming_provider)
