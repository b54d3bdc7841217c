"""SWIPDG penalty constants (dune-gdt SIPDG internals).

Counterpart of ``dune_hdd_tpu/ops/swipdg.py:61-73``; the face integrals
themselves live in ``la/stencil_assembly.py``.
"""
from __future__ import annotations

__all__ = ["inner_sigma", "boundary_sigma", "default_beta"]


def inner_sigma(pol_order: int) -> float:
    """dune-gdt LocalEvaluation::SIPDG::internal::inner_sigma."""
    return {0: 4.0, 1: 8.0, 2: 50.0, 3: 450.0}.get(int(pol_order), 450.0)


def boundary_sigma(pol_order: int) -> float:
    """dune-gdt LocalEvaluation::SIPDG::internal::boundary_sigma."""
    return {0: 14.0, 1: 14.0, 2: 38.0, 3: 74.0}.get(int(pol_order), 74.0)


def default_beta(dim: int = 2) -> float:
    return 1.0 / (dim - 1.0)
