"""Mean span of ``Spe10Bench.assemble`` (stencil assembly and scaling,
la/stencil_assembly.py), ms."""
from ._spans import mean_ms


def read(run):
    return mean_ms(run, "assemble")
