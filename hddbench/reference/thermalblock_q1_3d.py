"""The reference system of the 3D [2 2 2] thermalblock: Q1 (trilinear)
continuous Galerkin on the tensor lattice of a box, diffusion mu[block] on
the 2 x 2 x 2 checkerboard, force 1, u = 0 on the whole boundary.

The yardstick of the benchmark's check: written from the discretization's
definition, independent of the program under test, plain float64 ``torch``.

* Grid: ``cells`` (n0, n1, n2) boxes per axis; node (i0, i1, i2) is the
  flat index (i0 (n1 + 1) + i1) (n2 + 1) + i2 (the last axis fastest).
* Coefficient: cell (i0, i1, i2) lies in block b0 + nb0 (b1 + nb1 b2),
  b_a = floor(nb_a (i_a + 1/2) / n_a): axis 0 (x) fastest, as dune-hdd's
  checkerboard numbers its blocks.  The diffusion on the cell is mu[block].
* Element matrix: exact, of the trilinear basis on a box of sides
  (h0, h1, h2): K = sum_a (prod_b h_b / h_a^2) S_a (x) M_b (x) M_c, with the
  unit interval's 1D stiffness S = [[1, -1], [-1, 1]] and mass
  M = [[1/3, 1/6], [1/6, 1/3]] (the factor on axis a is S, on the others M).
* Load: exact, int phi_i = h0 h1 h2 / 8 on each corner of each cell.
* Dirichlet nodes (the boundary of the box), as dune-hdd's cg.hh:377-397
  constrains them: their rows and columns of the operator are zero but a
  unit diagonal, their entries of the rhs zero.

The operator is applied matrix-free, cell by cell: the 8 corner values of
every cell are strided views of the node array, and each corner's result
is added back into a view; it is never assembled.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Reference", "System", "element_matrix"]

_S = ((1.0, -1.0), (-1.0, 1.0))
_M = ((1.0 / 3.0, 1.0 / 6.0), (1.0 / 6.0, 1.0 / 3.0))
CORNERS = [(a0, a1, a2) for a0 in (0, 1) for a1 in (0, 1) for a2 in (0, 1)]


def element_matrix(h) -> np.ndarray:
    """[8, 8] trilinear stiffness of a box of sides ``h``, corners in the
    order of ``CORNERS``."""
    vol = float(np.prod(h))
    K = np.zeros((8, 8))
    for i, a in enumerate(CORNERS):
        for j, b in enumerate(CORNERS):
            for ax in range(3):
                term = vol / h[ax] ** 2
                for bx in range(3):
                    term *= (_S if bx == ax else _M)[a[bx]][b[bx]]
                K[i, j] += term
    return K


class System:
    """The system at one mu: ``matvec``, ``diagonal`` and ``rhs`` (flat, in
    the node order of the module docstring), ``to(dtype)`` rounds it."""

    def __init__(self, coef: torch.Tensor, K: torch.Tensor, interior: torch.Tensor,
                 rhs: torch.Tensor):
        self.coef = coef          # [n0, n1, n2] diffusion per cell
        self.K = K                # [8, 8] element matrix
        self.interior = interior  # [n0 + 1, n1 + 1, n2 + 1] 1 off the boundary, else 0
        self.rhs = rhs            # [N]

    def _corner(self, a):
        n0, n1, n2 = self.coef.shape
        return (slice(a[0], a[0] + n0), slice(a[1], a[1] + n1), slice(a[2], a[2] + n2))

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """A u for a flat vector, in the system's dtype."""
        x = u.to(self.K.dtype).reshape(self.interior.shape)
        xi = x * self.interior
        X = [xi[self._corner(b)] for b in CORNERS]
        y = torch.zeros_like(x)
        for i, a in enumerate(CORNERS):
            acc = self.K[i, 0] * X[0]
            for j in range(1, 8):
                acc = acc + self.K[i, j] * X[j]
            y[self._corner(a)] += self.coef * acc
        return (y * self.interior + (1 - self.interior) * x).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        d = torch.zeros_like(self.interior)
        for i, a in enumerate(CORNERS):
            d[self._corner(a)] += self.coef * self.K[i, i]
        return (d * self.interior + (1 - self.interior)).reshape(-1)

    def to(self, dtype: torch.dtype) -> "System":
        return System(self.coef.to(dtype), self.K.to(dtype), self.interior.to(dtype),
                      self.rhs.to(dtype))


class Reference:
    """``system(mu)`` -> the float64 system at ``mu``."""

    def __init__(self, config: dict, device):
        lo, up = (np.asarray(v, dtype=np.float64) for v in config["domain"])
        n = [int(c) for c in config["cells"]]
        nb = [int(b) for b in config["blocks"]]
        h = (up - lo) / np.asarray(n)
        f64 = dict(dtype=torch.float64, device=device)
        b = [np.minimum(((np.arange(n[a]) + 0.5) * nb[a] / n[a]).astype(np.int64), nb[a] - 1)
             for a in range(3)]
        block = b[0][:, None, None] + nb[0] * (b[1][None, :, None] + nb[1] * b[2][None, None, :])
        self.block = torch.as_tensor(block, device=device)
        self.K = torch.as_tensor(element_matrix(h), **f64)
        interior = torch.zeros([m + 1 for m in n], **f64)
        interior[1:-1, 1:-1, 1:-1] = 1.0
        self.interior = interior
        load = torch.zeros_like(interior)
        cell_load = torch.full(n, float(np.prod(h)) / 8.0, **f64)
        for a in CORNERS:
            load[a[0]:a[0] + n[0], a[1]:a[1] + n[1], a[2]:a[2] + n[2]] += cell_load
        self.rhs = (load * interior).reshape(-1)

    def system(self, mu) -> System:
        mu = torch.as_tensor(np.asarray(mu, dtype=np.float64), device=self.K.device)
        return System(mu[self.block], self.K, self.interior, self.rhs)
