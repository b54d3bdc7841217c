"""String-keyed problem factory (reference: problems.hh:47-211).
Counterpart of ``dune_hdd_tpu/problems/provider.py``, with the same
registry names."""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Type

from .default import DefaultProblem
from .esv2007 import ESV2007Problem
from .interfaces import Problem
from .mixed_boundaries import MixedBoundariesProblem
from .os2014 import ParametricESV2007Problem
from .spe10 import Spe10Model1Problem
from .thermalblock import LocalThermalblockProblem, ThermalblockProblem

__all__ = ["ProblemsProvider"]


class ProblemsProvider:
    _registry: Dict[str, Type[Problem]] = {}

    @classmethod
    def register(cls, problem_cls: Type[Problem], name: Optional[str] = None):
        cls._registry[name or problem_cls.static_id] = problem_cls

    @classmethod
    def available(cls) -> List[str]:
        return sorted(cls._registry)

    @classmethod
    def default_config(cls, name: str) -> dict:
        return cls._get(name).default_config()

    @classmethod
    def create(cls, name: str, config: Optional[Mapping] = None) -> Problem:
        return cls._get(name).create(config)

    @classmethod
    def _get(cls, name: str) -> Type[Problem]:
        if name in cls._registry:
            return cls._registry[name]
        # accept unqualified suffixes, e.g. "ESV2007"
        for full, pc in cls._registry.items():
            if full.endswith("." + name):
                return pc
        raise ValueError(f"unknown problem type {name!r}; available: {cls.available()}")


for _cls in (
    DefaultProblem,
    ESV2007Problem,
    ParametricESV2007Problem,
    MixedBoundariesProblem,
    ThermalblockProblem,
    LocalThermalblockProblem,
    Spe10Model1Problem,
):
    ProblemsProvider.register(_cls)
