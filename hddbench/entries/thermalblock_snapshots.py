"""Snapshot solves of the parametric thermalblock SWIPDG discretization as the
system under test: ``SWIPDGDiscretization`` of the port, one ``uncached_solve(mu,
options)`` per solve (what ``solve`` runs for a mu it has not cached: the
cache would keep every snapshot and grow through the window).

Configuration keys: domain, cubes, bisections, blocks (the thermalblock's
checkerboard), solver (the solver options).
"""
from __future__ import annotations

import numpy as np
import torch

from hddbench.lib.window import Outcome

__all__ = ["System"]


class System:
    """The snapshot cell's system: ``solve(mu)`` is the timed call."""

    def __init__(self, config: dict, device):
        from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
        from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
        from dune_hdd_tpu_torch.parameters import parse_parameter
        from dune_hdd_tpu_torch.problems import ThermalblockProblem

        lo, up = config["domain"]
        grid = alu_cube_grid(tuple(lo), tuple(up), tuple(config["cubes"]),
                             refinements=int(config["bisections"]))
        self.disc = SWIPDGDiscretization(
            grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
            ThermalblockProblem(tuple(config["blocks"])), only_these_products=(), device=device)
        self.options = dict(config["solver"])
        self.max_iter = int(self.options["max_iter"])
        self.dofs = self.disc.space.num_dofs
        self._parse = lambda mu: parse_parameter(np.asarray(mu), self.disc.parameter_type)

    def _outcome(self, u: torch.Tensor) -> Outcome:
        iters = int(self.disc.last_solve_info["iterations"])
        ok = iters < self.max_iter and bool(torch.isfinite(u).all())
        return Outcome(u, iters, 0, ok)

    def solve(self, mu) -> Outcome:
        """The timed call: freeze the affine system at mu, then PCG."""
        return self._outcome(self.disc.uncached_solve(self._parse(mu), self.options))

    def solve_in_spans(self, mu, span) -> Outcome:
        """The same call in ``span("solve")``, after one freeze of its own in
        ``span("freeze")`` (``pcg_iter_ms`` takes it off the solve's)."""
        mu = self._parse(mu)
        with span("freeze"):
            self.disc.stencil_system(mu)
        with span("solve"):
            u = self.disc.uncached_solve(mu, self.options)
        return self._outcome(u)

    def program_system(self, mu, v: torch.Tensor):
        """({"op_rel": A v}, b) of the frozen system the solve builds at mu,
        A applied as the solve applies it, unscaled, flat, float64."""
        sysm = self.disc.stencil_system(self._parse(mu))
        s = sysm.s.double()
        X = ((v / s)[sysm.to_soa]).reshape(sysm.B.shape).to(sysm.S.planes.dtype)
        Av = sysm.S.matvec(X).double().reshape(-1)[sysm.from_soa] / s
        b = sysm.B.double().reshape(-1)[sysm.from_soa] / s
        return {"op_rel": Av}, b

    def solve_lower(self, mu) -> torch.Tensor:
        """The control: the program's own solve (Jacobi PCG on the same
        frozen system) in float32 in place of float64, to the tolerance the
        solve clamps float32 to (10 eps)."""
        from dune_hdd_tpu_torch.la.stencil import jacobi_smoother, stencil_pcg

        sysm = self.disc.stencil_system(self._parse(mu))
        S = sysm.S.astype(torch.float32)
        B = sysm.B.to(torch.float32)
        bn = torch.linalg.norm(B)
        rtol = max(float(self.options["precision"]), 10.0 * torch.finfo(torch.float32).eps)
        X, _ = stencil_pcg(S, B / bn, jacobi_smoother(S), rtol=rtol, maxiter=self.max_iter)
        return (X.double() * bn.double()).reshape(-1)[sysm.from_soa] * sysm.s.double()
