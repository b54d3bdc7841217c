"""Mean span of ``Spe10Bench.precondition`` (the symmetrized operator and
the deflation preconditioner's build, la/stencil.py), ms."""
from ._spans import mean_ms


def read(run):
    return mean_ms(run, "precondition")
