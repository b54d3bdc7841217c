"""Parameters mu for the thermalblock's snapshot solves: a fresh mu, uniform
in [lower, upper]^dim, for every solve.

Parameters (the cell's workload file, key "traffic"):
  dim        number of components
  range      [lower, upper]

Solve k (k = 1, 2, ...) takes mu_k = lower + (upper - lower) frac(h_k + d):
h_k the k-th point of the Halton sequence (bases 2, 3, 5, 7, ...), d a
shift uniform in [0, 1)^dim drawn from the seed.  Each mu_k is uniform in
the box, so a window's mean work is that of uniform mu; the points of one
run are spread over the box rather than independent, so that mean swings
less from seed to seed than with independent draws.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Traffic", "halton"]

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _radical_inverse(i: int, base: int) -> float:
    f, out = 1.0, 0.0
    while i:
        f /= base
        i, digit = divmod(i, base)
        out += digit * f
    return out


def halton(k: int, dim: int) -> np.ndarray:
    """The k-th point (k >= 1) of the Halton sequence in [0, 1)^dim."""
    return np.array([_radical_inverse(k, p) for p in _PRIMES[:dim]])


class Traffic:
    """``next()`` -> a float64 numpy mu of length ``dim``."""

    def __init__(self, params: dict, seed: int, device=None):
        self.lo, self.hi = (float(v) for v in params["range"])
        self.dim = int(params["dim"])
        self.shift = np.random.default_rng(int(seed)).random(self.dim)
        self.k = 0

    def next(self) -> np.ndarray:
        self.k += 1
        return self.lo + (self.hi - self.lo) * ((halton(self.k, self.dim) + self.shift) % 1.0)
