"""Mean span of one build of the deflation preconditioner from the frozen
system, as the solve builds it (``stencil_deflation_preconditioner``,
la/stencil.py: the pairing sums, the aggregation, the coarse operator and
its inverse, the AZ planes), ms."""
from ._spans import mean_ms


def read(run):
    return mean_ms(run, "deflation.build")
