"""Carry state across from the reference package as numpy arrays.

The port never imports jax; callers hand over ``np.asarray`` copies of the
reference's arrays (for example the planes of a reference StencilBlockEll,
its StructuredAssemblyPlan, or the pattern fields and slot values of its
assembled SparseMatrix family), so both sides can run on the same operator
and inputs.  ``coupling_from_numpy`` carries the four blocks of a
BlockSWIPDG coupling operator; ``reduced_model_from_numpy`` carries a
trained reduced model (its dense arrays and coefficient expressions);
``block_ell_from_numpy`` and ``prolongation_from_numpy`` carry a block-ELL
matrix and a multigrid prolongation.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .affine import AffineDecomposition
from .device import resolve_device
from .discretizations.block_swipdg import CouplingOperator
from .la.block_ell import BlockEllMatrix, StructuredBlockEll
from .la.multigrid import DGProlongation
from .la.sparse import SparseMatrix, SparsityPattern
from .la.stencil import StencilBlockEll
from .la.stencil_assembly import StructuredAssemblyPlan, _FaceFamily
from .mor.reductor import ReducedModel
from .parameters import ParameterFunctional

__all__ = ["stencil_from_numpy", "structured_from_numpy", "block_ell_from_numpy",
           "prolongation_from_numpy", "assembly_plan_from_numpy",
           "pattern_from_numpy", "sparse_from_numpy", "coupling_from_numpy", "affine_from_numpy",
           "reduced_model_from_numpy"]

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


def coupling_from_numpy(blocks, device, patterns: Optional[dict] = None) -> CouplingOperator:
    """The port's CouplingOperator from the reference's four coupling
    blocks: ``blocks`` has (as attributes or keys) in_in, in_out, out_in and
    out_out, each with its pattern fields under ``pattern`` and its slot
    values under ``values``, as the reference's SparseMatrix has.  One
    ``patterns`` dict passed for all the affine components of a pair keeps
    one converted pattern per block, as the port's own couplings do."""
    patterns = {} if patterns is None else patterns
    mats = {}
    for name in ("in_in", "in_out", "out_in", "out_out"):
        block = _field(blocks, name)
        if name not in patterns:
            patterns[name] = pattern_from_numpy(_field(block, "pattern"))
        mats[name] = sparse_from_numpy(None, np.asarray(_field(block, "values")), device,
                                       pattern=patterns[name])
    return CouplingOperator(**mats)


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

    return AffineDecomposition([payload(a) for a in components],
                               [_functional(c) for c in coefficients],
                               None if affine_part is None else payload(affine_part))


def _functional(c) -> ParameterFunctional:
    """A ``(parameter_type mapping, expression)`` pair or an object with
    ``parameter_type`` and ``expression`` -> the port's functional."""
    pt, expr = (c if isinstance(c, tuple) else (c.parameter_type, c.expression))
    return ParameterFunctional(dict(pt.items()), expr)


def reduced_model_from_numpy(op_mats: np.ndarray, op_coeffs: Sequence, rhs_vecs: np.ndarray,
                             rhs_coeffs: Sequence, basis: np.ndarray,
                             products: Optional[Mapping[str, np.ndarray]] = None,
                             device="cuda") -> ReducedModel:
    """The port's ReducedModel from a reference model's arrays (op_mats
    [Q, n, n], rhs_vecs [Qr, n], basis [n, N], products {name: [n, n]}) and
    coefficients (as in ``affine_from_numpy``), copied to ``device``."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return ReducedModel(t(op_mats), [_functional(c) for c in op_coeffs], t(rhs_vecs),
                        [_functional(c) for c in rhs_coeffs], t(basis),
                        {name: t(m) for name, m in (products or {}).items()})


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


def block_ell_from_numpy(neighbors: np.ndarray, blocks: np.ndarray, device) -> BlockEllMatrix:
    """The port's BlockEllMatrix from a neighbour table [NC, B] and blocks
    [NC, B, nd, nd], on ``device`` in the blocks' dtype."""
    blocks = np.ascontiguousarray(blocks)
    if blocks.ndim != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be [NC, B, nd, nd], got {blocks.shape}")
    return BlockEllMatrix(np.array(neighbors), torch.tensor(blocks, device=device))


def prolongation_from_numpy(P_cell: np.ndarray, parent: np.ndarray, children_per_parent: int,
                            device) -> DGProlongation:
    """The port's DGProlongation from the per-child interpolation [NCf, nd,
    nd] and the parent map [NCf], on ``device`` in P_cell's dtype."""
    return DGProlongation(torch.tensor(np.asarray(P_cell), device=device),
                          np.array(parent, dtype=np.int64), int(children_per_parent))


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
