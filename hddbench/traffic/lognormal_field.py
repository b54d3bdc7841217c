"""Permeability fields for the SPE10 Model-1 cell: the synthetic Model-1
field times a per-cell log-normal factor, a fresh one for every solve.

Parameters (the cell's workload file, key "traffic"):
  sigma      standard deviation of the factor's natural logarithm
  clip       [lower, upper] bounds of Model 1's permeability
  cells      [nx, nz] permeability cells

The base field is the program's ``_synthetic_model1_field`` (copied here,
since the inputs are the benchmark's): the published Model-1 file is not in
the repository.  The factors come from a ``torch.Generator`` on the device,
seeded with the run's seed, so a seed gives the same fields on one device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Traffic", "synthetic_model1_field"]

MODEL1_MIN = 0.001
MODEL1_MAX = 998.915


def synthetic_model1_field(nx: int = 100, nz: int = 20) -> np.ndarray:
    """Deterministic channelized log-permeability field in [MODEL1_MIN,
    MODEL1_MAX]: sinusoidal layering and a fixed-seed smooth background in
    log10 space, with two meandering high-permeability channels."""
    rng = np.random.default_rng(20140513)
    x = (np.arange(nx) + 0.5) / nx
    z = (np.arange(nz) + 0.5) / nz
    X, Z = np.meshgrid(x, z, indexing="ij")
    log_lo, log_hi = np.log10(MODEL1_MIN), np.log10(MODEL1_MAX)
    background = 0.35 * np.sin(6.0 * np.pi * Z) + 0.2 * np.sin(3.0 * np.pi * X + 2.0)
    for k in range(1, 7):
        amp = rng.normal(0.0, 0.25 / k)
        phx, phz = rng.uniform(0, 2 * np.pi, size=2)
        background += amp * np.sin(2 * np.pi * k * X + phx) * np.sin(2 * np.pi * k * Z + phz)
    for centre, width, level in ((0.3, 0.06, 0.95), (0.72, 0.05, 0.9)):
        path = centre + 0.08 * np.sin(2.5 * np.pi * X)
        background += level * np.exp(-((Z - path) ** 2) / (2 * width**2))
    b = (background - background.min()) / (background.max() - background.min())
    return 10.0 ** (log_lo + b * (log_hi - log_lo))


class Traffic:
    """``next()`` -> a float32 [nx, nz] field on ``device``."""

    def __init__(self, params: dict, seed: int, device):
        nx, nz = params["cells"]
        self.sigma = float(params["sigma"])
        self.lo, self.hi = (float(v) for v in params["clip"])
        self.base = torch.as_tensor(synthetic_model1_field(nx, nz), dtype=torch.float32,
                                    device=device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def next(self) -> torch.Tensor:
        z = torch.randn(self.base.shape, generator=self.gen, device=self.base.device,
                        dtype=torch.float32)
        return torch.clamp(self.base * torch.exp(self.sigma * z), self.lo, self.hi)
