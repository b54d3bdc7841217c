"""Snapshot solves of the 3D parametric thermalblock on Q1 tensor CG as the
system under test: the discretization that the port's
``ThermalblockExample.initialize_tensor`` builds (every product it builds
kept, as a deployment keeps them), one ``uncached_solve(mu, options)`` per
solve (what ``solve`` runs for a mu it has not cached: the cache would keep
every snapshot and grow through the window).  The solve freezes the 8
sparse components at mu and runs ``la/solvers.cg`` with the Jacobi
preconditioner on ``SparseMatrix.matvec``.

Configuration keys: cells (per axis; the example's cube is the unit cube),
blocks (the checkerboard), solver (the solver options).
"""
from __future__ import annotations

import numpy as np
import torch

from hddbench.lib.window import Outcome

__all__ = ["System"]


class System:
    """The 3D snapshot cell's system: ``solve(mu)`` is the timed call."""

    def __init__(self, config: dict, device):
        from dune_hdd_tpu_torch.cli.examples import ThermalblockExample
        from dune_hdd_tpu_torch.parameters import parse_parameter

        cells = [int(c) for c in config["cells"]]
        self.disc = ThermalblockExample(device=device).initialize_tensor(
            dim=3, num_elements=cells, num_blocks=tuple(config["blocks"])).discretization()
        self.options = dict(config["solver"])
        self.max_iter = int(self.options["max_iter"])
        self.dofs = self.disc.space.num_dofs
        self._parse = lambda mu: parse_parameter(np.asarray(mu), self.disc.parameter_type)

    def _outcome(self, u: torch.Tensor) -> Outcome:
        iters = int(self.disc.last_solve_info["iterations"])
        ok = iters < self.max_iter and bool(torch.isfinite(u).all())
        return Outcome(u, iters, 0, ok)

    def solve(self, mu) -> Outcome:
        """The timed call: freeze the affine system at mu, then Jacobi CG."""
        return self._outcome(self.disc.uncached_solve(self._parse(mu), self.options))

    def solve_in_spans(self, mu, span) -> Outcome:
        """The same call in ``span("solve")``, after one freeze of its own in
        ``span("freeze")`` (``pcg_iter_ms`` takes it off the solve's)."""
        mu = self._parse(mu)
        with span("freeze"):
            self.disc.freeze_operator(mu)
            self.disc.freeze_rhs(mu)
        with span("solve"):
            u = self.disc.uncached_solve(mu, self.options)
        return self._outcome(u)

    def program_system(self, mu, v: torch.Tensor):
        """({"op_rel": A v}, b) of the frozen system the solve builds at mu,
        A applied by ``SparseMatrix.matvec`` in float64, as the CG applies it."""
        mu = self._parse(mu)
        return ({"op_rel": self.disc.freeze_operator(mu).matvec(v)},
                self.disc.freeze_rhs(mu))

    def solve_lower(self, mu) -> torch.Tensor:
        """The control: the program's own solver (``la/solvers.cg`` with the
        Jacobi preconditioner) on the float32 form of the same frozen
        system, to the tolerance float32 allows (10 eps)."""
        from dune_hdd_tpu_torch.la.solvers import cg, make_preconditioner
        from dune_hdd_tpu_torch.la.sparse import SparseMatrix

        mu = self._parse(mu)
        A = self.disc.freeze_operator(mu)
        A = SparseMatrix(A.pattern, A.values.to(torch.float32))
        b = self.disc.freeze_rhs(mu).to(torch.float32)
        rtol = max(float(self.options["precision"]), 10.0 * torch.finfo(torch.float32).eps)
        x, _ = cg(A.matvec, b, tol=rtol, maxiter=self.max_iter,
                  M=make_preconditioner(A, "jacobi"))
        return x.double()
