"""Helpers shared by the discretizations.

Counterpart of the ``_parts`` helper of ``dune_hdd_tpu/discretizations/cg.py``;
its ``CGDiscretization`` is the next item of ROADMAP queue 1 (slice 2).
"""
from __future__ import annotations

from ..affine import AffineDecomposition

__all__ = ["_parts"]


def _parts(dec: AffineDecomposition):
    """[(payload, coefficient-or-None)] with the affine part last."""
    out = [(dec.components[q], dec.coefficients[q]) for q in range(dec.num_components)]
    if dec.affine_part is not None:
        out.append((dec.affine_part, None))
    return out
