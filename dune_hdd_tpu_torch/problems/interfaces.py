"""Parametric elliptic problem interface.

Counterpart of ``dune_hdd_tpu/problems/interfaces.py``: five data entries —
scalar ``diffusion_factor``, matrix ``diffusion_tensor``, ``force``,
``dirichlet``, ``neumann`` — each a ParametricFunction (AffineDecomposition
of Functions); ``with_mu`` freezes to a nonparametric problem.  (The VTK
``visualize`` waits for ``utils/vtk.py``, ROADMAP queue 1 slice 6.)
"""
from __future__ import annotations

import io
from typing import Dict

from ..affine import AffineDecomposition
from ..functions.base import FrozenAffineFunction, ParametricFunction, nonparametric
from ..parameters import Parameter, ParameterType, parse_parameter

__all__ = ["Problem"]

_ENTRY_NAMES = ("diffusion_factor", "diffusion_tensor", "force", "dirichlet", "neumann")


class Problem:
    static_id = "hdd.linearelliptic.problem"

    def __init__(self, diffusion_factor: ParametricFunction, diffusion_tensor: ParametricFunction,
                 force: ParametricFunction, dirichlet: ParametricFunction,
                 neumann: ParametricFunction):
        def coerce(f):
            return f if isinstance(f, AffineDecomposition) else nonparametric(f)

        self.diffusion_factor = coerce(diffusion_factor)
        self.diffusion_tensor = coerce(diffusion_tensor)
        self.force = coerce(force)
        self.dirichlet = coerce(dirichlet)
        self.neumann = coerce(neumann)

    def entries(self) -> Dict[str, ParametricFunction]:
        return {name: getattr(self, name) for name in _ENTRY_NAMES}

    @property
    def parameter_type(self) -> ParameterType:
        pt = ParameterType()
        for dec in self.entries().values():
            pt = pt | dec.parameter_type
        return pt

    def parametric(self) -> bool:
        return not self.parameter_type.empty()

    def parse_parameter(self, mu) -> Parameter:
        return parse_parameter(mu, self.parameter_type)

    def with_mu(self, mu=None) -> "Problem":
        """Nonparametric problem at fixed mu."""
        mu = self.parse_parameter(mu)

        def freeze(dec: ParametricFunction, name: str) -> ParametricFunction:
            if not dec.parametric():
                return dec
            return nonparametric(FrozenAffineFunction(dec, mu, name=name))

        from .default import DefaultProblem

        return DefaultProblem(**{name: freeze(dec, name) for name, dec in self.entries().items()})

    def type(self) -> str:
        return self.static_id

    def report(self, prefix: str = "") -> str:
        out = io.StringIO()
        out.write(f"{prefix}{self.type()}\n")
        for name, dec in self.entries().items():
            tag = (
                f"affine({dec.num_components} components"
                + (", affine part" if dec.affine_part is not None else "")
                + ")"
                if dec.parametric()
                else "nonparametric"
            )
            out.write(f"{prefix}  {name}: {tag}\n")
        if self.parametric():
            out.write(f"{prefix}  parameter_type: {self.parameter_type!r}\n")
        return out.getvalue()

    def __repr__(self):
        return f"{type(self).__name__}(parameter_type={self.parameter_type!r})"
