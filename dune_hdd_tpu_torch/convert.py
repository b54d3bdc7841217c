"""Carry state across from the reference package as numpy arrays.

The port never imports jax; callers hand over ``np.asarray`` copies of the
reference's arrays (for example the planes of a reference StencilBlockEll,
its StructuredAssemblyPlan, or the pattern fields and slot values of its
assembled SparseMatrix family), so both sides can run on the same operator
and inputs.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .affine import AffineDecomposition
from .la.block_ell import StructuredBlockEll
from .la.sparse import SparseMatrix, SparsityPattern
from .la.stencil import StencilBlockEll
from .la.stencil_assembly import StructuredAssemblyPlan, _FaceFamily
from .parameters import ParameterFunctional

__all__ = ["stencil_from_numpy", "structured_from_numpy", "assembly_plan_from_numpy",
           "pattern_from_numpy", "sparse_from_numpy", "affine_from_numpy"]

_PATTERN_ARRAYS = ("perm", "seg_ids", "slot_rows", "slot_cols", "ell_cols", "ell_mask",
                   "slot_ell_pos", "diag_slot")


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def pattern_from_numpy(pattern_fields) -> SparsityPattern:
    """The port's SparsityPattern from a mapping or object with the
    reference's pattern fields (shape, nnz, ell_width and the index arrays),
    copying every array."""
    return SparsityPattern(
        shape=tuple(int(v) for v in _field(pattern_fields, "shape")),
        nnz=int(_field(pattern_fields, "nnz")),
        ell_width=int(_field(pattern_fields, "ell_width")),
        **{name: np.array(_field(pattern_fields, name)) for name in _PATTERN_ARRAYS})


def sparse_from_numpy(pattern_fields, values: np.ndarray, device,
                      pattern: Optional[SparsityPattern] = None) -> SparseMatrix:
    """A SparseMatrix of slot ``values`` [nnz] on ``device`` (in the values'
    dtype) over the pattern described by ``pattern_fields`` (or over an
    already converted ``pattern``, to share one between matrices)."""
    pattern = pattern if pattern is not None else pattern_from_numpy(pattern_fields)
    values = np.asarray(values)
    if values.shape != (pattern.nnz,):
        raise ValueError(f"values must be [{pattern.nnz}], got {values.shape}")
    return SparseMatrix(pattern, torch.tensor(values, device=device))


def affine_from_numpy(components: Sequence[np.ndarray], coefficients: Sequence,
                      affine_part: Optional[np.ndarray], device,
                      pattern_fields=None) -> AffineDecomposition:
    """An AffineDecomposition of vectors (``pattern_fields`` None) or of
    SparseMatrix slot values sharing one pattern.  Each coefficient is a
    ``(parameter_type mapping, expression)`` pair or an object with
    ``parameter_type`` and ``expression`` (the reference's functionals)."""
    pattern = None if pattern_fields is None else pattern_from_numpy(pattern_fields)

    def payload(a):
        if pattern is None:
            return torch.tensor(np.asarray(a), device=device)
        return sparse_from_numpy(None, a, device, pattern=pattern)

    def functional(c):
        pt, expr = (c if isinstance(c, tuple) else (c.parameter_type, c.expression))
        return ParameterFunctional(dict(pt.items()), expr)

    return AffineDecomposition([payload(a) for a in components],
                               [functional(c) for c in coefficients],
                               None if affine_part is None else payload(affine_part))


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
