"""EOC (experimental order of convergence) study harness.

Counterpart of ``dune_hdd_tpu/studies/eoc.py``: per refinement level
assemble + solve on ``device`` (the card unless the caller asks for the
CPU), measure error norms against the exact solution (or the
reference-level discrete solution through cell parent chains), evaluate
estimators, report EOC rates.  Besides the errors, each level records its
time to solution, its assembly seconds and the solver's report
(``level_info``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..functions.base import freeze_function
from ..ops.assembly import cell_quadrature
from ..ops.norms import error_norms, evaluate_discrete, evaluate_discrete_gradient
from ..testcases.base import TestCaseBase

__all__ = ["EocStudy", "eoc_rates"]


def eoc_rates(values: Sequence[float]) -> List[float]:
    """EOC between successive levels (grid width halves per level)."""
    return [float(np.log2(values[i] / values[i + 1])) for i in range(len(values) - 1)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _difference_norms(space_f, u_f, space_c, u_c, parent, diffusion=None, order: int = 6):
    """Norms of (u_f - u_c) on the fine grid, with u_c evaluated through the
    fine -> coarse cell map."""
    qp, qw = cell_quadrature(space_f.grid, order, space_f.device, space_f.dtype)
    uf_val = evaluate_discrete(space_f, u_f, qp)
    uf_grad = evaluate_discrete_gradient(space_f, u_f, qp)
    verts_c = space_c.tensor(space_c.grid.cell_vertices[parent])
    vals_c = space_c.shape_values(verts_c, qp)
    grads_c = space_c.shape_gradients(verts_c, qp)
    u_loc = u_c[space_c.tensor(space_c.cell_dofs[parent])]
    ev = uf_val - torch.einsum("cki,ci->ck", vals_c, u_loc)
    eg = uf_grad - torch.einsum("ckia,ci->cka", grads_c, u_loc)
    out = {
        "L2": float(torch.sqrt(torch.sum(qw * ev**2))),
        "H1_semi": float(torch.sqrt(torch.sum(qw * torch.sum(eg**2, dim=-1)))),
    }
    if diffusion is not None:
        lam_fn, kap_fn = diffusion
        lam = lam_fn(qp) if lam_fn is not None else 1.0
        flux = torch.einsum("ckab,ckb->cka", kap_fn(qp), eg)
        out["energy"] = float(torch.sqrt(torch.sum(qw * lam * torch.sum(eg * flux, dim=-1))))
    return out


class EocStudy:
    """``discretization_factory(grid, boundary_info, problem, device=...)``
    builds each level's discretization."""

    def __init__(
        self,
        test_case: TestCaseBase,
        discretization_factory: Callable,
        norms: Sequence[str] = ("L2", "H1_semi", "energy"),
        estimator_types: Sequence[str] = (),
        estimate_fn: Optional[Callable] = None,
        mu=None,
        energy_mu=None,
        solver_options: Optional[Mapping] = None,
        device="cuda",
    ):
        self.test_case = test_case
        self.factory = discretization_factory
        self.norms = tuple(norms)
        self.estimator_types = tuple(estimator_types)
        self.estimate_fn = estimate_fn
        self.mu = mu
        self.energy_mu = energy_mu if energy_mu is not None else mu
        self.solver_options = dict(solver_options or {"type": "direct"})
        self.device = resolve_device(device)
        self.time_to_solution: List[float] = []
        self.level_info: List[Dict] = []
        self.discretizations: List = []
        self.solutions: List = []

    def _energy_diffusion(self):
        problem = self.test_case.problem
        frozen = problem.with_mu(self.energy_mu) if problem.parametric() else problem
        return freeze_function(frozen.diffusion_factor), freeze_function(frozen.diffusion_tensor)

    def _discretize(self, grid):
        return self.factory(grid, self.test_case.boundary_info(), self.test_case.problem,
                            device=self.device)

    def run(self, verbose: bool = True) -> Dict[str, List[float]]:
        tc = self.test_case
        results: Dict[str, List[float]] = {t: [] for t in self.norms + self.estimator_types}
        reference = None
        if not tc.provides_exact_solution():
            ref_disc = self._discretize(tc.reference_grid)
            reference = (ref_disc.space, ref_disc.solve(self.mu, options=self.solver_options))
        lam_kap = self._energy_diffusion()
        for r in range(tc.num_refinements + 1):
            grid = tc.level_grid(r)
            t0 = time.perf_counter()
            disc = self._discretize(grid)
            _sync(self.device)
            t1 = time.perf_counter()
            u = disc.solve(self.mu, options=self.solver_options)
            _sync(self.device)
            t2 = time.perf_counter()
            self.time_to_solution.append(t2 - t0)
            self.level_info.append(dict(disc.last_solve_info, num_dofs=disc.space.num_dofs,
                                        assembly_seconds=t1 - t0, solve_seconds=t2 - t1))
            self.discretizations.append(disc)
            self.solutions.append(u)
            if tc.provides_exact_solution():
                errs = error_norms(disc.space, u, tc.exact_solution,
                                   diffusion_factor=lam_kap[0], diffusion_tensor=lam_kap[1])
            else:
                space_f, u_f = reference
                parent = tc.hierarchy.parent_cells(r, tc.reference_level)
                errs = _difference_norms(space_f, u_f, disc.space, u, parent, lam_kap)
            for t in self.norms:
                results[t].append(errs[t])
            for t in self.estimator_types:
                results[t].append(float(self.estimate_fn(disc, u, t, level=r)))
            if verbose:
                print(f"  ref {r}: " + "  ".join(
                    f"{t}={results[t][-1]:.3e}" for t in self.norms + self.estimator_types))
        self.results = results
        return results

    def eoc(self, type_: str) -> List[float]:
        return eoc_rates(self.results[type_])
