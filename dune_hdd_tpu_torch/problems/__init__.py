from .default import DefaultProblem
from .esv2007 import ESV2007Problem
from .interfaces import Problem
from .mixed_boundaries import MixedBoundariesProblem
from .os2014 import ParametricESV2007Problem
from .provider import ProblemsProvider
from .spe10 import Spe10Model1Problem
from .thermalblock import LocalThermalblockProblem, ThermalblockProblem
from .zero_boundary import ZeroBoundaryProblem

__all__ = ["Problem", "DefaultProblem", "ESV2007Problem", "ThermalblockProblem",
           "LocalThermalblockProblem", "ParametricESV2007Problem", "Spe10Model1Problem",
           "ZeroBoundaryProblem", "MixedBoundariesProblem", "ProblemsProvider"]
