from .base import StationaryDiscretization
from .swipdg import SWIPDGDiscretization

__all__ = ["StationaryDiscretization", "SWIPDGDiscretization"]
