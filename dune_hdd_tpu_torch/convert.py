"""Carry state across from the reference package as numpy arrays.

The port never imports jax; callers hand over ``np.asarray`` copies of the
reference's arrays (for example the planes of a reference StencilBlockEll,
or its StructuredAssemblyPlan, whose fields are already numpy), so both
sides can run on the same operator and inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .la.block_ell import StructuredBlockEll
from .la.stencil import StencilBlockEll
from .la.stencil_assembly import StructuredAssemblyPlan, _FaceFamily

__all__ = ["stencil_from_numpy", "structured_from_numpy", "assembly_plan_from_numpy"]


def stencil_from_numpy(planes: np.ndarray, plan, device) -> StencilBlockEll:
    """The port's operator from planes [4, 3, 3, 8, KY, KX] and an 8 x 3
    (k_src, dy, dx) plan, on ``device`` in the planes' dtype."""
    planes = np.ascontiguousarray(planes)
    if planes.ndim != 6 or planes.shape[:4] != (4, 3, 3, 8):
        raise ValueError(f"planes must be [4, 3, 3, 8, KY, KX], got {planes.shape}")
    return StencilBlockEll(torch.tensor(planes, device=device), plan)  # a copy


def structured_from_numpy(neighbors: np.ndarray, blocks: np.ndarray, offsets,
                          device) -> StructuredBlockEll:
    """The port's StructuredBlockEll from a neighbour table [nc, 4], blocks
    [nc, 4, nd, nd] and 8 x 3 offsets, on ``device`` in the blocks' dtype."""
    blocks = np.ascontiguousarray(blocks)
    if blocks.ndim != 4 or blocks.shape[1] != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be [nc, 4, nd, nd], got {blocks.shape}")
    return StructuredBlockEll(np.array(neighbors), torch.tensor(blocks, device=device), offsets)


def assembly_plan_from_numpy(splan) -> StructuredAssemblyPlan:
    """The port's StructuredAssemblyPlan from any object with the same
    fields (the reference's plan), copying every array."""
    families = tuple(
        tuple(_FaceFamily(*[np.array(v) if isinstance(v, np.ndarray) else v
                            for v in fam]) for fam in row)
        for row in splan.families)
    return StructuredAssemblyPlan(
        families=families,
        vol_qp=np.array(splan.vol_qp), vol_G=np.array(splan.vol_G),
        vol_wvals=np.array(splan.vol_wvals), dof_perm=np.array(splan.dof_perm),
        plan=tuple(tuple(tuple(int(v) for v in e) for e in row) for row in splan.plan),
        lattice=tuple(int(v) for v in splan.lattice), nd=int(splan.nd),
        sigma_i=float(splan.sigma_i), sigma_b=float(splan.sigma_b),
        beta=float(splan.beta))
