from .base import StationaryDiscretization
from .block_swipdg import BlockSWIPDGDiscretization
from .cg import CGDiscretization
from .swipdg import SWIPDGDiscretization
from .tensor_cg import TensorCGDiscretization

__all__ = ["StationaryDiscretization", "CGDiscretization", "SWIPDGDiscretization",
           "BlockSWIPDGDiscretization", "TensorCGDiscretization"]
