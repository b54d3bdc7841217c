"""SPE10 model-1 permeability field (host numpy).

Counterpart of ``dune_hdd_tpu/functions/spe10.py:25-52``.  The SPE10
``perm_case1.dat`` file is not distributed with the repository, so the bench
uses the same deterministic synthetic channelized field as the reference
package: 100 x 20 cells on [0,5] x [0,1] spanning [MODEL1_MIN, MODEL1_MAX].
"""
from __future__ import annotations

import numpy as np

__all__ = ["MODEL1_MIN", "MODEL1_MAX", "MODEL1_NX", "MODEL1_NZ"]

MODEL1_MIN = 0.001
MODEL1_MAX = 998.915
MODEL1_NX = 100
MODEL1_NZ = 20


def _synthetic_model1_field(nx: int = MODEL1_NX, nz: int = MODEL1_NZ) -> np.ndarray:
    """Deterministic channelized log-permeability field in [MODEL1_MIN, MODEL1_MAX].

    A sum of sinusoidal channels + smooth random (fixed-seed) background in
    log10 space, qualitatively matching SPE10 model 1's high-contrast layering.
    """
    rng = np.random.default_rng(20140513)  # fixed: OS2014-era date, deterministic
    x = (np.arange(nx) + 0.5) / nx
    z = (np.arange(nz) + 0.5) / nz
    X, Z = np.meshgrid(x, z, indexing="ij")
    log_lo, log_hi = np.log10(MODEL1_MIN), np.log10(MODEL1_MAX)
    background = 0.35 * np.sin(6.0 * np.pi * Z) + 0.2 * np.sin(3.0 * np.pi * X + 2.0)
    for k in range(1, 7):
        amp = rng.normal(0.0, 0.25 / k)
        phx, phz = rng.uniform(0, 2 * np.pi, size=2)
        background += amp * np.sin(2 * np.pi * k * X + phx) * np.sin(2 * np.pi * k * Z + phz)
    # two high-permeability channels meandering in x
    for centre, width, level in ((0.3, 0.06, 0.95), (0.72, 0.05, 0.9)):
        path = centre + 0.08 * np.sin(2.5 * np.pi * X)
        background += level * np.exp(-((Z - path) ** 2) / (2 * width**2))
    b = (background - background.min()) / (background.max() - background.min())
    return 10.0 ** (log_lo + b * (log_hi - log_lo))
