"""The SPE10 Model-1 bench as the system under test: ``build_spe10_bench``
of the port, one call of ``Spe10Bench.fn`` per solve.

Configuration keys: bisections, tol, preconditioner.
"""
from __future__ import annotations

import torch

from hddbench.lib.window import Outcome

__all__ = ["System"]


class System:
    """The b8 cell's system: ``solve(field)`` is the timed call."""

    def __init__(self, config: dict, device):
        from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

        self.tol = float(config["tol"])
        self.bench = build_spe10_bench(bisections=int(config["bisections"]), tol=self.tol,
                                       device=device, preconditioner=config["preconditioner"])
        self.dofs = self.bench.num_dofs
        self.to_soa = self.bench.to_soa
        self.from_soa = torch.argsort(self.to_soa)

    def _outcome(self, sol) -> Outcome:
        ok = sol.residual <= self.tol and bool(torch.isfinite(sol.u).all())
        return Outcome(sol.u, int(sol.iterations), int(sol.sweeps), ok)

    def solve(self, field: torch.Tensor) -> Outcome:
        """The timed call: assembly, preconditioner build, refined solve."""
        return self._outcome(self.bench.fn(field))

    def solve_in_spans(self, field: torch.Tensor, span) -> Outcome:
        """The same call split at its layers, each in ``span(name)``; the
        preconditioner is built once more on its own, since the solve builds
        it inside (``pcg_iter_ms`` takes that span off the solve's)."""
        with span("assemble"):
            S, B, s = self.bench.assemble(field)
        with span("precondition"):
            self.bench.precondition(S, s)
        with span("solve"):
            sol = self.bench.solve(S, B, s)
        return self._outcome(sol)

    def _system(self, field: torch.Tensor):
        """(the operator the solve applies, its preconditioner, rhs, scaling)
        of the scaled system the timed call assembles for ``field``."""
        S, B, s = self.bench.assemble(field)
        S, M = self.bench.precondition(S, s)
        return S, M, B, s

    def program_system(self, field: torch.Tensor, v: torch.Tensor):
        """({"op_rel": A v, "op_rel64": A v}, b) of the operator and rhs the
        timed call assembles for ``field``: A applied as the solve applies
        it, in float32 by its PCG and in float64 by its refinement, each
        unscaled, flat, float64."""
        S, _, B, s = self._system(field)
        s64 = s.reshape(-1)[self.from_soa].double()
        X = ((v / s64)[self.to_soa]).reshape(B.shape)

        def unscaled(Y):
            return Y.double().reshape(-1)[self.from_soa] / s64

        applied = {"op_rel": unscaled(S.matvec(X.to(S.planes.dtype))),
                   "op_rel64": unscaled(S.astype(torch.float64).matvec(X))}
        return applied, unscaled(B)

    def own_residual(self, field: torch.Tensor, u: torch.Tensor) -> float:
        """The true relative residual of ``u`` in the scaled system that the
        solve solves for ``field`` (the operator it applies, in float64):
        the configuration's 1e-6, recomputed from the answer."""
        S, _, B, s = self._system(field)
        B64 = B.double()
        X = u.double()[self.to_soa].reshape(B.shape) / s.double()
        R = B64 - S.astype(torch.float64).matvec(X)
        return float(torch.linalg.norm(R) / torch.linalg.norm(B64))

    def solve_lower(self, field: torch.Tensor) -> torch.Tensor:
        """The control: the program's float32 PCG on the same operator and
        preconditioner to the same tolerance (or 2,000 iterations, where
        float32 stalls short of it), without the float64 refinement
        (float32 in place of float64)."""
        from dune_hdd_tpu_torch.la.stencil import stencil_pcg

        S, M, B, s = self._system(field)
        bn = torch.linalg.norm(B)
        X, _ = stencil_pcg(S, B / bn, M, rtol=self.tol, maxiter=2000,
                           unroll=self.bench.settings.unroll)
        return (X.double() * bn.double() * s.double()).reshape(-1)[self.from_soa]
