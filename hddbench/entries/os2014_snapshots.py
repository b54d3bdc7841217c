"""Snapshot solves of the OS2014 parametric test case as the system under
test: the ``BlockSWIPDGDiscretization`` that the OS2014 block study builds
on the test case's level grid (its default products kept, as the LRBMS
offline stage keeps them), one ``uncached_solve(mu, options)`` per solve
(what ``solve`` runs for a mu it has not cached: the cache would keep every
snapshot and grow through the window).  With the studies' options the
solve freezes the "reference"-scheme system at mu into planes, builds the
two-level weighted deflation preconditioner on the macro lattice and runs
its PCG in float64 on ``plane_spmv``.

Configuration keys: level, partitions, dofs (checked), solver (the solver
options, with "macro").
"""
from __future__ import annotations

import numpy as np
import torch

from hddbench.lib.window import Outcome

__all__ = ["System"]


class System:
    """The OS2014 snapshot cell's system: ``solve(mu)`` is the timed call."""

    def __init__(self, config: dict, device):
        from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
        from dune_hdd_tpu_torch.parameters import parse_parameter
        from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase

        level, parts = int(config["level"]), tuple(config["partitions"])
        tc = OS2014MultiscaleTestCase({"mu": 1.0, "mu_bar": 1.0, "mu_hat": 1.0,
                                       "mu_minimizing": 0.1},
                                      num_partitions=parts, num_refinements=level)
        self.disc = BlockSWIPDGDiscretization(tc.level_grid(level), tc.boundary_info(),
                                              tc.problem, num_partitions=parts, device=device)
        self.options = dict(config["solver"])
        self.max_iter = int(self.options["max_iter"])
        self.dofs = self.disc.space.num_dofs
        if self.dofs != int(config["dofs"]):
            raise ValueError(f"level {level} has {self.dofs} DoF, the configuration "
                             f"{config['dofs']}")
        self._parse = lambda mu: parse_parameter(np.asarray(mu), self.disc.parameter_type)

    def _outcome(self, u: torch.Tensor) -> Outcome:
        iters = int(self.disc.last_solve_info["iterations"])
        ok = iters < self.max_iter and bool(torch.isfinite(u).all())
        return Outcome(u, iters, 0, ok)

    def _system(self, mu):
        """The frozen, scaled system in planes that the solve builds at mu."""
        return self.disc._global.stencil_system(mu)

    def _deflation(self, sysm, dtype=torch.float64):
        """M as the solve builds it from ``sysm`` (in ``dtype``): the
        weighted deflation space Z_w = diag(1/s) Z on the macro lattice."""
        from dune_hdd_tpu_torch.la.stencil import stencil_deflation_preconditioner

        S = sysm.S if dtype == sysm.S.planes.dtype else sysm.S.astype(dtype)
        w = (1.0 / sysm.s).to(dtype)[sysm.to_soa].reshape(sysm.B.shape)
        return S, stencil_deflation_preconditioner(S, tuple(self.options["macro"]), weight=w)

    def solve(self, mu) -> Outcome:
        """The timed call: freeze at mu, build M, deflated PCG."""
        return self._outcome(self.disc.uncached_solve(self._parse(mu), self.options))

    def solve_in_spans(self, mu, span) -> Outcome:
        """The same call in ``span("solve")``, after what it does before its
        PCG, once more on its own: a freeze in ``span("freeze")``, a build
        of M from it in ``span("deflation.build")``, and a fresh freeze and
        build in ``span("precondition")`` (``pcg_iter_ms`` takes that span
        off the solve's)."""
        mu = self._parse(mu)
        with span("freeze"):
            sysm = self._system(mu)
        with span("deflation.build"):
            self._deflation(sysm)
        del sysm
        with span("precondition"):
            self._deflation(self._system(mu))
        with span("solve"):
            u = self.disc.uncached_solve(mu, self.options)
        return self._outcome(u)

    def program_system(self, mu, v: torch.Tensor):
        """({"op_rel": A v}, b) of the frozen system the solve builds at mu,
        A applied by ``plane_spmv`` in float64 as the PCG applies it,
        unscaled, flat, float64."""
        sysm = self._system(self._parse(mu))
        s = sysm.s.double()
        X = ((v / s)[sysm.to_soa]).reshape(sysm.B.shape).to(sysm.S.planes.dtype)
        Av = sysm.S.matvec(X).double().reshape(-1)[sysm.from_soa] / s
        b = sysm.B.double().reshape(-1)[sysm.from_soa] / s
        return {"op_rel": Av}, b

    def solve_lower(self, mu) -> torch.Tensor:
        """The control: the same macro-deflated ``stencil_pcg`` on the
        float32 form of the same frozen system, to the tolerance the solve
        clamps float32 to (10 eps)."""
        from dune_hdd_tpu_torch.la.stencil import stencil_pcg

        sysm = self._system(self._parse(mu))
        S, M = self._deflation(sysm, torch.float32)
        B = sysm.B.to(torch.float32)
        bn = torch.linalg.norm(B)
        rtol = max(float(self.options["precision"]), 10.0 * torch.finfo(torch.float32).eps)
        X, _ = stencil_pcg(S, B / bn, M, rtol=rtol, maxiter=self.max_iter)
        return (X.double() * bn.double()).reshape(-1)[sysm.from_soa] * sysm.s.double()
