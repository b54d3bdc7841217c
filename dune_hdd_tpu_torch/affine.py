"""Affinely decomposed containers: Sum_q theta_q(mu) * X_q (+ affine part).

Counterpart of ``dune_hdd_tpu/affine.py``.  The payloads are anything with
scalar ``*`` and ``+``: tensors, ``SparseMatrix``, ``BlockEllMatrix``.
Freezing multiplies each payload by theta_q(mu) as a Python float, so a
payload on the card meets no host tensor.
"""
from __future__ import annotations

from typing import Callable, Generic, List, Optional, Sequence, TypeVar

import torch

from .parameters import ConstantFunctional, Parameter, ParameterFunctional, ParameterType

T = TypeVar("T")

__all__ = ["AffineDecomposition", "affine_from_parts", "coefficient_bounds"]


class AffineDecomposition(Generic[T]):
    """components[q] with coefficients theta_q, plus an optional
    nonparametric affine part."""

    def __init__(
        self,
        components: Optional[Sequence[T]] = None,
        coefficients: Optional[Sequence[ParameterFunctional]] = None,
        affine_part: Optional[T] = None,
    ):
        self.components: List[T] = list(components) if components else []
        self.coefficients: List[ParameterFunctional] = list(coefficients) if coefficients else []
        if len(self.components) != len(self.coefficients):
            raise ValueError("components and coefficients must have equal length")
        self.affine_part: Optional[T] = affine_part

    def register_component(self, component: T, coefficient: ParameterFunctional) -> int:
        self.components.append(component)
        self.coefficients.append(coefficient)
        return len(self.components) - 1

    def register_affine_part(self, part: T) -> None:
        if self.affine_part is not None:
            raise ValueError("affine part already registered")
        self.affine_part = part

    @property
    def num_components(self) -> int:
        return len(self.components)

    def parametric(self) -> bool:
        return bool(self.components)

    @property
    def parameter_type(self) -> ParameterType:
        pt = ParameterType()
        for c in self.coefficients:
            pt = pt | c.parameter_type
        return pt

    def coefficient(self, q: int) -> ParameterFunctional:
        return self.coefficients[q]

    def component(self, q: int) -> T:
        return self.components[q]

    def find_component(self, coefficient: ParameterFunctional) -> Optional[int]:
        for q, c in enumerate(self.coefficients):
            if c == coefficient:
                return q
        return None

    def thetas(self, mu: Parameter) -> torch.Tensor:
        """[Q] float64 host tensor of theta_q(mu)."""
        if not self.components:
            return torch.zeros((0,), dtype=torch.float64)
        return torch.stack([c(mu).to(torch.float64) for c in self.coefficients])

    def freeze(self, mu: Optional[Parameter] = None) -> T:
        """Sum_q theta_q(mu) X_q + affine_part, summed in q order."""
        mu = mu or {}
        if not self.components:
            if self.affine_part is None:
                raise ValueError("empty affine decomposition")
            return self.affine_part
        thetas = [float(c(mu)) for c in self.coefficients]
        acc = self.components[0] * thetas[0]
        for q in range(1, self.num_components):
            acc = acc + self.components[q] * thetas[q]
        if self.affine_part is not None:
            acc = acc + self.affine_part
        return acc

    def map(self, fn: Callable[[T], T]) -> "AffineDecomposition":
        """Apply fn to every component and the affine part."""
        return AffineDecomposition(
            [fn(c) for c in self.components],
            list(self.coefficients),
            fn(self.affine_part) if self.affine_part is not None else None,
        )

    def with_expanded_affine_part(self) -> "AffineDecomposition":
        """The affine part as one more component with coefficient 1."""
        if self.affine_part is None:
            return self
        return AffineDecomposition(
            list(self.components) + [self.affine_part],
            list(self.coefficients) + [ConstantFunctional(1.0)],
        )

    def __repr__(self):
        return (
            f"AffineDecomposition(Q={self.num_components}, "
            f"affine_part={'yes' if self.affine_part is not None else 'no'}, "
            f"type={self.parameter_type!r})"
        )


def affine_from_parts(affine_part: T) -> AffineDecomposition:
    """A nonparametric payload."""
    return AffineDecomposition(affine_part=affine_part)


def coefficient_bounds(decomposition: AffineDecomposition, mu: Parameter,
                       mu_ref: Parameter) -> tuple:
    """(alpha, gamma) = (min_q, max_q) theta_q(mu)/theta_q(mu_ref) over the
    components only (the affine part is excluded)."""
    if not decomposition.components:
        one = torch.tensor(1.0, dtype=torch.float64)
        return one, one
    ratios = decomposition.thetas(mu) / decomposition.thetas(mu_ref)
    return torch.min(ratios), torch.max(ratios)
