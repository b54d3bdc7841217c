"""SPE10 model-1 permeability field.

Counterpart of ``dune_hdd_tpu/functions/spe10.py``.  ``Spe10Model1Function``
reads the SPE10 model-1 ASCII file ``perm_case1.dat`` (100 x 20 cells on
[0,5] x [0,1], x fastest) when it finds one, rescaling its values linearly
from the published range [MODEL1_MIN, MODEL1_MAX] into [min, max] (the
identity for the default range, no clamping); the file is not distributed
with the repository, so otherwise it uses the deterministic synthetic
channelized field of ``_synthetic_model1_field`` (``synthetic`` says which).
The bench uses that synthetic field directly.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .base import Function

__all__ = ["Spe10Model1Function", "model1_filename", "MODEL1_MIN", "MODEL1_MAX", "MODEL1_NX",
           "MODEL1_NZ"]

model1_filename = "perm_case1.dat"
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


def _read_model1_file(path: str, min_value: float = MODEL1_MIN,
                      max_value: float = MODEL1_MAX) -> np.ndarray:
    """[NX, NZ] field of a perm_case1.dat-format file: whitespace-separated
    values, x fastest then z, rescaled by ``scale * raw + shift`` with
    ``scale = (max - min) / (MODEL1_MAX - MODEL1_MIN)`` and ``shift = min -
    scale * MODEL1_MIN``.  Line structure is ignored (the last line may be
    ragged)."""
    if not max_value > min_value:
        raise ValueError(f"need max > min, got [{min_value}, {max_value}]")
    with open(path) as fh:
        vals = np.array(fh.read().split(), dtype=float)
    need = MODEL1_NX * MODEL1_NZ
    if vals.size < need:
        raise ValueError(f"SPE10 model1 file {path!r} has {vals.size} values, need {need}")
    scale = (max_value - min_value) / (MODEL1_MAX - MODEL1_MIN)
    shift = min_value - scale * MODEL1_MIN
    return scale * vals[:need].reshape(MODEL1_NZ, MODEL1_NX).T + shift


class Spe10Model1Function(Function):
    """2x2 diagonal tensor field lambda(x) * I from the SPE10 model-1 data.
    ``filename`` is looked up as given, then by its base name in
    ``search_paths`` (default: the working directory, this package's
    ``functions`` directory and the repository's ``data`` directory)."""

    range_shape = (2, 2)

    def __init__(self, filename: str = model1_filename, lower_left=(0.0, 0.0),
                 upper_right=(5.0, 1.0), min_value: float = MODEL1_MIN,
                 max_value: float = MODEL1_MAX, name: str = "diffusion_tensor",
                 search_paths: Optional[list] = None):
        here = os.path.dirname(os.path.abspath(__file__))
        if search_paths is None:
            search_paths = [os.getcwd(), here, os.path.join(here, "..", "..", "data")]
        paths = [filename] + [os.path.join(d, os.path.basename(filename)) for d in search_paths]
        field = None
        for p in paths:
            if os.path.isfile(p):
                field = _read_model1_file(p, min_value, max_value)
                break
        synthetic = field is None
        if synthetic:
            field = np.clip(_synthetic_model1_field(), min_value, max_value)
        self._init(field, lower_left, upper_right, name, synthetic)

    @classmethod
    def from_field(cls, field, lower_left=(0.0, 0.0), upper_right=(5.0, 1.0),
                   name: str = "diffusion_tensor") -> "Spe10Model1Function":
        """The same lookup over a ready [NX, NZ] ``field`` (an array, or a
        tensor whose values are used as they are); ``synthetic`` is False."""
        f = cls.__new__(cls)
        f._init(field, lower_left, upper_right, name, False)
        return f

    def _init(self, field, lower_left, upper_right, name: str, synthetic: bool) -> None:
        self.lower = np.asarray(lower_left, dtype=np.float64)
        self.upper = np.asarray(upper_right, dtype=np.float64)
        self.order = 0
        self.name = name
        self.synthetic = synthetic
        self.field = field  # [NX, NZ]
        self._on = {}

    def _tensors(self, x: torch.Tensor):
        """(field, lower, upper, cell counts) on x's device in x's dtype,
        copied once per device and dtype."""
        key = (str(x.device), x.dtype)
        if key not in self._on:
            self._on[key] = tuple(torch.as_tensor(a, dtype=x.dtype).to(x.device) for a in (
                self.field, self.lower, self.upper, np.array([MODEL1_NX, MODEL1_NZ], float)))
        return self._on[key]

    def permeability(self, x: torch.Tensor) -> torch.Tensor:
        field, lower, upper, nxz = self._tensors(x)
        rel = (x - lower) / (upper - lower)
        ij = torch.minimum(torch.clamp(torch.floor(rel * nxz), min=0.0), nxz - 1).to(torch.long)
        return field[ij[..., 0], ij[..., 1]]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        lam = self.permeability(x)
        return lam[..., None, None] * torch.eye(2, dtype=x.dtype, device=x.device)
