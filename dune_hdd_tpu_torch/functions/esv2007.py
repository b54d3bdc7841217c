"""ESV2007 testcase-1 data functions (Ern/Stephansen/Vohralik 2007).

Counterpart of ``dune_hdd_tpu/functions/esv2007.py``: exact solution
u = cos(pi/2 x) cos(pi/2 y) on [-1,1]^2 with unit diffusion, force
f = pi^2/2 cos(pi/2 x) cos(pi/2 y), and the estimator's cutoff ingredients.
"""
from __future__ import annotations

import math

import torch

from .base import Function

__all__ = ["Testcase1Force", "Testcase1ExactSolution", "CutoffFunction"]


class Testcase1Force(Function):
    range_shape = ()

    def __init__(self, order: int = 3, name: str = "force"):
        self.order = order
        self.name = name

    def __call__(self, x):
        p = 0.5 * math.pi
        return (p * math.pi) * torch.cos(p * x[..., 0]) * torch.cos(p * x[..., 1])


class Testcase1ExactSolution(Function):
    range_shape = ()

    def __init__(self, order: int = 2, name: str = "exact_solution"):
        self.order = order
        self.name = name

    def __call__(self, x):
        p = 0.5 * math.pi
        return torch.cos(p * x[..., 0]) * torch.cos(p * x[..., 1])

    def gradient(self, x):
        p = 0.5 * math.pi
        gx = -p * torch.sin(p * x[..., 0]) * torch.cos(p * x[..., 1])
        gy = -p * torch.cos(p * x[..., 0]) * torch.sin(p * x[..., 1])
        return torch.stack([gx, gy], dim=-1)


class CutoffFunction(Function):
    """Elementwise-constant cutoff of the ESV2007 residual estimator,
    cutoff|_T = h_T^2 / (pi^2 min_T eig(lambda kappa)); this class stores
    the ingredients and the smallest eigenvalue of lambda kappa."""

    range_shape = ()

    def __init__(self, diffusion_factor: Function, diffusion_tensor: Function,
                 poincare_constant: float = 1.0 / (math.pi ** 2), name: str = "cutoff"):
        self.diffusion_factor = diffusion_factor
        self.diffusion_tensor = diffusion_tensor
        self.poincare_constant = poincare_constant
        self.name = name

    def min_diffusion_eigenvalue(self, x):
        """min eigenvalue of lambda(x)*kappa(x) at points x [..., 2]."""
        mat = self.diffusion_factor(x)[..., None, None] * self.diffusion_tensor(x)
        a, b, c, d = mat[..., 0, 0], mat[..., 0, 1], mat[..., 1, 0], mat[..., 1, 1]
        disc = torch.sqrt(torch.clamp((a - d) ** 2 + 4.0 * b * c, min=0.0))
        return 0.5 * (a + d - disc)
