"""Solver ms per PCG iteration: the solve spans less the build spans
(the preconditioner build, or the freeze), over the window's iterations."""
from ._spans import iter_ms


def read(run):
    build = "precondition" if "precondition" in (run.spans or {}) else "freeze"
    return iter_ms(run, build)
