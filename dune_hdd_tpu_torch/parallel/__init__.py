"""The sharded layer: device meshes and their collectives, the row-split and
subdomain-halo block systems, sharded assembly, the stage pipeline and the
process group.  Counterpart of ``dune_hdd_tpu/parallel/``."""
from .distributed import initialize_distributed, is_distributed, process_info
from .halo import HaloShardedSystem, halo_exchange_spec
from .pipeline import make_stage_mesh, pipeline_parameter_stages
from .sharded import (
    ShardedAffineSystem,
    make_device_mesh,
    sharded_cg,
    sharded_parameter_sweep,
)

__all__ = [
    "initialize_distributed",
    "is_distributed",
    "process_info",
    "HaloShardedSystem",
    "make_stage_mesh",
    "pipeline_parameter_stages",
    "halo_exchange_spec",
    "ShardedAffineSystem",
    "make_device_mesh",
    "sharded_cg",
    "sharded_parameter_sweep",
]
