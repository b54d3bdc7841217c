"""The reference system of the 2 x 2 thermalblock: P1 SWIPDG on the bisected
4 x 4 criss grid of the unit square, diffusion mu[block] on the 2 x 2
checkerboard (blocks numbered x fastest), force 1, all Dirichlet (u = 0).
The weights and the penalty are those of the diffusion at mu = 1 (the
weighting diffusion 1): that keeps the operator affine in mu, and positive
for every mu."""
from __future__ import annotations

import numpy as np
import torch

from .swipdg_p1 import assemble, cell_centroids, criss_grid, geometry

__all__ = ["Reference"]


class Reference:
    """``system(mu)`` -> the assembled float64 system at ``mu``."""

    def __init__(self, config: dict, device):
        lo, up = config["domain"]
        self.grid = criss_grid(lo, up, config["cubes"], int(config["bisections"]))
        self.geo = geometry(self.grid, device)
        c = (cell_centroids(self.grid) - np.asarray(lo)) / (np.asarray(up) - np.asarray(lo))
        nbx, nby = config["blocks"]
        bx = np.clip(np.floor(c[:, 0] * nbx).astype(np.int64), 0, nbx - 1)
        by = np.clip(np.floor(c[:, 1] * nby).astype(np.int64), 0, nby - 1)
        self.block = torch.as_tensor(bx + nbx * by, device=device)
        self.ones = torch.ones(len(c), dtype=torch.float64, device=device)

    def system(self, mu):
        mu = torch.as_tensor(np.asarray(mu, dtype=np.float64), device=self.ones.device)
        return assemble(self.geo, mu[self.block], self.ones, self.ones)
