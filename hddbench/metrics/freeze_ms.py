"""Mean span of ``SWIPDGDiscretization.stencil_system(mu)`` (the affine
system frozen at mu, scaled and laid out in planes), ms."""
from ._spans import mean_ms


def read(run):
    return mean_ms(run, "freeze")
