"""The comparison that decides ``correct``: the program's answers against
the plain float64 reference (``hddbench/reference``).

Numbers compared (each against its limit in the cell's workload file), each
the largest over the sampled solves:

* ``res_ref``: the relative residual of the program's solution u in the
  reference's system, diagonally scaled as the solvers scale it:
  ||s (b - A u)|| / ||s b||, s = diag(A)^(-1/2).
* ``op_rel`` (and ``op_rel64``, where the solve also applies its operator
  in float64): ||A_p v - A v|| / ||A v|| for a vector v drawn from the
  seed, A_p the operator the program assembles for the solve's input,
  applied by the kernel its solve applies, in the precision named.
* ``rhs_rel``: ||b_p - b|| / ||b|| of the program's rhs for the input.
* ``res_own`` (a system with ``own_residual``): the true relative residual
  in the system the program solves, read through its float64 operator,
  which ``op_rel64`` holds to the reference.  Where the program's operator
  is float32, its rounding sets a floor under ``res_ref`` that hides
  whether the solve met its own tolerance; this number shows it.

Numbers without a limit in the workload file are reported as readings.
"""
from __future__ import annotations

import torch

__all__ = ["probe_vector", "scaled_residual", "rel", "program_readings", "readings", "verdict"]


def probe_vector(seed: int, n: int, device) -> torch.Tensor:
    """The float64 vector v the operators are applied to, drawn from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0xC0FFEE)
    return torch.randn(n, generator=gen, device=device, dtype=torch.float64)


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm((x - ref).double()) / torch.linalg.norm(ref.double()))


def scaled_residual(op, u: torch.Tensor) -> float:
    s = op.diagonal().rsqrt()
    r = s * (op.rhs - op.matvec(u.double()))
    return float(torch.linalg.norm(r) / torch.linalg.norm(s * op.rhs))


def program_readings(system, kept, inputs, v: torch.Tensor) -> dict:
    """What the check needs of the program, read before its state is
    released: for every sampled input, ({name: A_p v}, b_p) by
    ``system.program_system``, and ``res_own``."""
    out = {"ops": [system.program_system(inputs[i], v) for i, _ in kept]}
    if hasattr(system, "own_residual"):
        out["res_own"] = max(system.own_residual(inputs[i], u) for i, u in kept)
    return out


def readings(reference, kept, inputs, program: dict, v: torch.Tensor) -> dict:
    """``kept``: [(solve index, u)]; ``inputs``: every solve's input;
    ``program``: ``program_readings`` of the same ``kept``."""
    out: dict = {"res_ref": 0.0, "rhs_rel": 0.0}
    for (i, u), (applied, b) in zip(kept, program["ops"]):
        op = reference.system(inputs[i])
        out["res_ref"] = max(out["res_ref"], scaled_residual(op, u))
        out["rhs_rel"] = max(out["rhs_rel"], rel(b, op.rhs))
        Av = op.matvec(v)
        for name, x in applied.items():
            out[name] = max(out.get(name, 0.0), rel(x, Av))
    if "res_own" in program:
        out["res_own"] = program["res_own"]
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, [[name, value, limit]]): every number finite and within its
    limit, and every limit read."""
    rows = [[k, numbers.get(k, float("nan")), float(lim)] for k, lim in limits.items()]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
