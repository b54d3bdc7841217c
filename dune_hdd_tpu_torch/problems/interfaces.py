"""Parametric elliptic problem interface.

Counterpart of ``dune_hdd_tpu/problems/interfaces.py``: five data entries —
scalar ``diffusion_factor``, matrix ``diffusion_tensor``, ``force``,
``dirichlet``, ``neumann`` — each a ParametricFunction (AffineDecomposition
of Functions); ``with_mu`` freezes to a nonparametric problem;
``visualize`` writes every data entry (and each affine component) as cell
data.
"""
from __future__ import annotations

import io
from typing import Dict

import torch

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

    def visualize(self, grid, filename_prefix: str, mu=None, device="cuda") -> list:
        """Write each data entry (and each affine component) as cell data on
        the grid, sampled at the cell centroids on ``device`` (the card
        unless the caller asks for the CPU); returns the written paths.
        Matrix-valued entries store their diagonal (interfaces.hh:94-115,
        146-165)."""
        from ..device import resolve_device
        from ..utils.vtk import write_cell_data_vtu

        centroids = torch.as_tensor(grid.cell_centroids, dtype=torch.float64).to(
            resolve_device(device))
        paths = []
        for name, dec in self.entries().items():
            fields = {}

            def sample(fn, tag):
                vals = fn(centroids)
                if vals.ndim == 1:
                    fields[tag] = vals
                elif vals.ndim == 3:  # matrix-valued: store the diagonal
                    fields[tag + "_00"] = vals[:, 0, 0]
                    fields[tag + "_11"] = vals[:, 1, 1]
                else:
                    fields[tag] = vals.reshape(len(vals), -1)[:, 0]

            if dec.affine_part is not None:
                sample(dec.affine_part, f"{name}_affine_part")
            for q in range(dec.num_components):
                sample(dec.components[q], f"{name}_component_{q}")
            if dec.parametric() and mu is not None:
                sample(FrozenAffineFunction(dec, self.parse_parameter(mu)), name)
            paths.append(write_cell_data_vtu(grid, fields, f"{filename_prefix}_{name}"))
        return paths

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
