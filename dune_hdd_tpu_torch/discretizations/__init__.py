from .base import StationaryDiscretization
from .cg import CGDiscretization
from .swipdg import SWIPDGDiscretization

__all__ = ["StationaryDiscretization", "CGDiscretization", "SWIPDGDiscretization"]
