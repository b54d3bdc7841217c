from .default import DefaultProblem
from .esv2007 import ESV2007Problem
from .interfaces import Problem
from .thermalblock import LocalThermalblockProblem, ThermalblockProblem

__all__ = ["Problem", "DefaultProblem", "ESV2007Problem", "ThermalblockProblem",
           "LocalThermalblockProblem"]
