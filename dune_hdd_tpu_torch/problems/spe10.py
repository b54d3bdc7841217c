"""SPE10 model-1 problem.  Counterpart of ``dune_hdd_tpu/problems/spe10.py``.

diffusion_tensor: the SPE10 model-1 permeability field (the file, or the
synthetic field, see ``functions/spe10.py``).  diffusion_factor: 1 + channel,
the channel a sum of sharp boxes (or flat-top boxes with a boundary layer);
the nonparametric variant scales the channel by 0.9, the parametric one
registers it with theta = -mu, so the diffusion is (1 + channel) - mu
channel.  Force: three boxes of +2000 / -1000 / -1000.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..affine import AffineDecomposition
from ..functions.base import (
    ConstantFunction,
    FlatTopFunction,
    Function,
    IndicatorFunction,
    ScaledFunction,
    SumFunction,
    nonparametric,
)
from ..functions.spe10 import Spe10Model1Function, model1_filename
from ..parameters import ParameterFunctional
from .default import DefaultProblem

__all__ = ["Spe10Model1Problem"]

_DEFAULT_FORCES = [
    ((0.95, 0.30), (1.10, 0.45), 2000.0),
    ((3.00, 0.75), (3.15, 0.90), -1000.0),
    ((4.25, 0.25), (4.40, 0.40), -1000.0),
]


def _make_channel(channel_values, boundary_layer) -> Optional[Function]:
    if not channel_values:
        return None
    layer = np.asarray(boundary_layer, dtype=float)
    parts = []
    for lo, hi, val in channel_values:
        if np.allclose(layer, 0.0):
            parts.append(IndicatorFunction([(lo, hi, val)], name="channel"))
        else:
            parts.append(FlatTopFunction(lo, hi, layer, val, name="channel"))
    return parts[0] if len(parts) == 1 else SumFunction(parts, name="channel")


class Spe10Model1Problem(DefaultProblem):
    static_id = DefaultProblem.static_id.rsplit(".", 1)[0] + ".spe10.model1"

    def __init__(self, filename: str = model1_filename, lower_left=(0.0, 0.0),
                 upper_right=(5.0, 1.0), channel_values: Sequence[Tuple] = (),
                 force_values: Sequence[Tuple] = tuple(_DEFAULT_FORCES),
                 channel_boundary_layer=(0.0, 0.0), parametric_channel: bool = False):
        channel = _make_channel(list(channel_values), channel_boundary_layer)
        one = ConstantFunction(1.0, "one")
        tensor = Spe10Model1Function(filename, lower_left, upper_right)
        self.spe10_field = tensor
        force = IndicatorFunction(list(force_values), name="force")
        if parametric_channel:
            if channel is None:
                raise ValueError("parametric_channel requires channel values")
            diffusion = AffineDecomposition(
                affine_part=SumFunction([one, channel], name="diffusion_factor"))
            diffusion.register_component(channel, ParameterFunctional(("mu", 1), "-1.0*mu"))
        elif channel is None:
            diffusion = nonparametric(one)
        else:
            diffusion = nonparametric(SumFunction(
                [one, ScaledFunction(channel, 0.9, "scaled_channel")], name="diffusion_factor"))
        super().__init__(
            diffusion_factor=diffusion,
            diffusion_tensor=nonparametric(tensor),
            force=nonparametric(force),
            dirichlet=nonparametric(ConstantFunction(0.0, "dirichlet")),
            neumann=nonparametric(ConstantFunction(0.0, "neumann")),
        )

    @classmethod
    def default_config(cls) -> dict:
        return {
            "filename": model1_filename,
            "lower_left": (0.0, 0.0),
            "upper_right": (5.0, 1.0),
            "parametric_channel": False,
            "channel_boundary_layer": (0.0, 0.0),
            "forces": list(_DEFAULT_FORCES),
            "channel": [],
        }

    @classmethod
    def create(cls, config=None) -> "Spe10Model1Problem":
        cfg = dict(cls.default_config())
        cfg.update(dict(config or {}))
        return cls(filename=cfg["filename"], lower_left=cfg["lower_left"],
                   upper_right=cfg["upper_right"], channel_values=cfg.get("channel", []),
                   force_values=cfg.get("forces", _DEFAULT_FORCES),
                   channel_boundary_layer=cfg.get("channel_boundary_layer", (0.0, 0.0)),
                   parametric_channel=bool(cfg.get("parametric_channel", False)))
