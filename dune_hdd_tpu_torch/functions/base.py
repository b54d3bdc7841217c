"""Scalar coefficient functions over 2D space, as torch callables.

Counterpart of the Constant / Indicator / Sum / Scaled functions of
``dune_hdd_tpu/functions/base.py``.  A function takes either a point tensor
``x`` of shape ``[..., 2]`` or a coordinate-plane pair ``(x0, x1)`` of
equal-shape tensors, and returns a tensor of the point shape ``[...]``.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["ConstantFunction", "IndicatorFunction", "SumFunction", "ScaledFunction"]

Points = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _planes(x: Points) -> Tuple[torch.Tensor, torch.Tensor]:
    if isinstance(x, tuple):
        return x
    return x[..., 0], x[..., 1]


class ConstantFunction:
    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, x: Points) -> torch.Tensor:
        x0, _ = _planes(x)
        return torch.full_like(x0, self.value)


class IndicatorFunction:
    """Sum of value_k * 1_{[lower_k, upper_k)}(x).  Boxes are HALF-OPEN so
    adjacent boxes sharing an edge never double-count at points on the
    shared line."""

    def __init__(self, subdomains: Sequence[Tuple[Sequence[float], Sequence[float], float]]):
        self.boxes = [((float(lo[0]), float(lo[1])), (float(up[0]), float(up[1])), float(v))
                      for lo, up, v in subdomains]

    def __call__(self, x: Points) -> torch.Tensor:
        x0, x1 = _planes(x)
        # one box at a time: never materializes a [K, points] intermediate
        # (105 channel boxes at millions of points); the boxes are disjoint,
        # so the summation order cannot change the result
        out = torch.zeros_like(x0)
        for (l0, l1), (u0, u1), v in self.boxes:
            inside = (x0 >= l0) & (x0 < u0) & (x1 >= l1) & (x1 < u1)
            out = out + v * inside.to(x0.dtype)
        return out


class SumFunction:
    def __init__(self, functions: Sequence):
        self.functions = list(functions)

    def __call__(self, x: Points) -> torch.Tensor:
        out = self.functions[0](x)
        for f in self.functions[1:]:
            out = out + f(x)
        return out


class ScaledFunction:
    def __init__(self, function, scale: float):
        self.function = function
        self.scale = float(scale)

    def __call__(self, x: Points) -> torch.Tensor:
        return self.scale * self.function(x)
