"""pyMOR interoperability shim.

Counterpart of ``dune_hdd_tpu/mor/pymor_shim.py``: ``as_pymor_model``
hands a discretization's affine operators, products and (for block
discretizations) the LRBMS surface to pyMOR, the role of the reference's
bindings generators.

* If pyMOR is importable it returns a genuine
  ``pymor.models.basic.StationaryModel`` whose operator and rhs are
  ``LincombOperator``s over scipy-sparse ``NumpyMatrixOperator``s on the
  host (pyMOR's own arrays), one matrix per affine component.
* Otherwise it returns a ``StationaryModelShim`` with the pyMOR
  ``StationaryModel`` call surface, implemented on the discretization
  (which stays on its device).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["as_pymor_model", "StationaryModelShim", "StationaryMultiscaleModelShim"]


def _scipy_components(decomposition):
    """[(scipy_csr, coefficient)] for an expanded AffineDecomposition of
    SparseMatrix payloads."""
    import scipy.sparse as sp

    out = []
    exp = decomposition.with_expanded_affine_part()
    for q, m in enumerate(exp.components):
        p = m.pattern
        A = sp.csr_matrix((m.values.detach().cpu().double().numpy(), (p.slot_rows, p.slot_cols)),
                          shape=p.shape)
        out.append((A, exp.coefficients[q]))
    return out


class StationaryModelShim:
    """pyMOR ``StationaryModel``-shaped facade over a
    StationaryDiscretization (used when pymor itself is unavailable)."""

    def __init__(self, discretization, name: Optional[str] = None):
        self._d = discretization
        self.name = name or f"{type(discretization).__name__}_pymor_shim"
        self.operator = discretization.get_operator().with_expanded_affine_part()
        self.rhs = discretization.get_rhs().with_expanded_affine_part()
        self.products = {nm: discretization.get_product(nm)
                         for nm in discretization.available_products()}

    @property
    def parameters(self) -> Dict[str, int]:
        """pyMOR Parameters analog: component name -> dimension."""
        return {k: int(v) for k, v in self._d.parameter_type.items()}

    def parse_parameter(self, mu):
        return self._d.problem.parse_parameter(mu) if self._d.parametric() else {}

    def solve(self, mu=None, **kwargs):
        return self._d.solve(self.parse_parameter(mu or {}), options=kwargs.get("solver_options"))

    def output(self, mu=None):
        raise NotImplementedError("the reference workflows define no output functional")

    def visualize(self, u, filename: str = "pymor_shim"):
        return self._d.visualize(u, filename)

    def __repr__(self):
        return f"StationaryModelShim({self.name}, parameters={self.parameters})"


class StationaryMultiscaleModelShim(StationaryModelShim):
    """The multiscale (LRBMS) surface on top of the StationaryModel shape:
    per-subdomain operators, rhs, products, neighbour couplings and
    localization, all as affine decompositions."""

    def __init__(self, block_discretization, name: Optional[str] = None):
        super().__init__(block_discretization, name)
        self._bd = block_discretization

    def num_subdomains(self) -> int:
        return self._bd.num_subdomains()

    def neighbouring_subdomains(self, ss: int):
        return self._bd.neighbouring_subdomains(ss)

    def local_operator(self, ss: int):
        return self._bd.get_local_operator(ss).with_expanded_affine_part()

    def local_rhs(self, ss: int):
        return self._bd.get_local_rhs(ss).with_expanded_affine_part()

    def local_product(self, ss: int, product_id: str):
        return self._bd.get_local_product(ss, product_id)

    def coupling_operator(self, ss: int, nn: int):
        return self._bd.get_coupling_operator(ss, nn)

    def localize_vector(self, vector, ss: int):
        return self._bd.localize_vector(vector, ss)

    def globalize_vectors(self, local_vectors):
        return self._bd.globalize_vectors(local_vectors)

    def solve_for_local_correction(self, local_vectors, ss: int, mu=None):
        return self._bd.solve_for_local_correction(local_vectors, ss, mu)

    def __repr__(self):
        return (f"StationaryMultiscaleModelShim({self.name}, "
                f"subdomains={self.num_subdomains()}, parameters={self.parameters})")


def as_pymor_model(discretization, name: Optional[str] = None):
    """A pyMOR StationaryModel for the discretization, or the API-compatible
    shim when pymor is not installed.  Block (multiscale) discretizations
    get the multiscale shim with the LRBMS surface."""
    from ..discretizations.block_swipdg import BlockSWIPDGDiscretization

    try:
        from pymor.models.basic import StationaryModel
        from pymor.operators.constructions import LincombOperator, VectorOperator
        from pymor.operators.numpy import NumpyMatrixOperator
        from pymor.parameters.functionals import GenericParameterFunctional
        from pymor.vectorarrays.numpy import NumpyVectorSpace
    except ImportError:
        if isinstance(discretization, BlockSWIPDGDiscretization):
            return StationaryMultiscaleModelShim(discretization, name)
        return StationaryModelShim(discretization, name)

    d = discretization

    def wrap_coeff(c):
        if c is None:
            return 1.0
        params = {k: int(v) for k, v in d.parameter_type.items()}
        return GenericParameterFunctional(
            lambda mu, c=c: float(c({k: torch.as_tensor(np.asarray(mu[k], dtype=np.float64))
                                     for k in params})),
            params,
        )

    op_parts = _scipy_components(d.get_operator())
    op = LincombOperator([NumpyMatrixOperator(A) for A, _ in op_parts],
                         [wrap_coeff(c) for _, c in op_parts])

    rhs_exp = d.get_rhs().with_expanded_affine_part()
    space = NumpyVectorSpace(d.space.num_dofs)
    rhs_ops = [VectorOperator(space.from_numpy(v.detach().cpu().double().numpy()[None, :]))
               for v in rhs_exp.components]
    rhs = LincombOperator(rhs_ops, [wrap_coeff(c) for c in rhs_exp.coefficients])

    products = {}
    for nm in d.available_products():
        prod = d.get_product(nm)
        if prod.parametric():
            continue
        products[nm] = NumpyMatrixOperator(sum(A for A, _ in _scipy_components(prod)))

    return StationaryModel(op, rhs, products=products, name=name or "dune_hdd_tpu_model")
