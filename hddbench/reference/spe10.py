"""The reference system of the SPE10 Model-1 configuration: P1 SWIPDG on the
bisected criss grid of Model 1's 100 x 20 cells of [0, 5] x [0, 1], the
diffusion (1 - 0.9 * channel(x)) * kappa(x), the three box forces, all
Dirichlet (u = 0).  The channel and the forces are dune-hdd's
(``spe10_problem.json``)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .swipdg_p1 import assemble, cell_centroids, criss_grid, geometry

__all__ = ["Reference", "boxes"]

PROBLEM = json.loads((Path(__file__).with_name("spe10_problem.json")).read_text())


def boxes(x: np.ndarray, spec) -> np.ndarray:
    """sum_k value_k * 1_[lower_k, upper_k)(x) at points x [N, 2]."""
    out = np.zeros(len(x))
    for (l0, l1), (u0, u1), v in spec:
        out += v * ((x[:, 0] >= l0) & (x[:, 0] < u0) & (x[:, 1] >= l1) & (x[:, 1] < u1))
    return out


class Reference:
    """``system(field)`` -> the assembled float64 system for the permeability
    ``field`` [100, 20].  Every coefficient is constant on the permeability
    cells, which the grid resolves, so it is read at cell centroids."""

    def __init__(self, config: dict, device):
        (lo, up), (nx, nz) = PROBLEM["domain"], PROBLEM["permeability_cells"]
        self.grid = criss_grid(lo, up, (nx, nz), int(config["bisections"]))
        self.geo = geometry(self.grid, device)
        c = cell_centroids(self.grid)
        rel = (c - np.asarray(lo)) / (np.asarray(up) - np.asarray(lo))
        ix = np.clip(np.floor(rel[:, 0] * nx).astype(np.int64), 0, nx - 1)
        iz = np.clip(np.floor(rel[:, 1] * nz).astype(np.int64), 0, nz - 1)
        f64 = dict(dtype=torch.float64, device=device)
        self.lam = torch.as_tensor(1.0 + PROBLEM["channel_scale"] * boxes(c, PROBLEM["channel"]),
                                   **f64)
        self.force = torch.as_tensor(boxes(c, PROBLEM["forces"]), **f64)
        self.index = torch.as_tensor(ix * nz + iz, device=device)

    def system(self, field: torch.Tensor):
        kappa = field.to(device=self.lam.device, dtype=torch.float64).reshape(-1)[self.index]
        tau = self.lam * kappa
        return assemble(self.geo, tau, tau, self.force)
