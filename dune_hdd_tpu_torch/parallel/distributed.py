"""Multi-process initialisation.

Counterpart of ``dune_hdd_tpu/parallel/distributed.py``, on
``torch.distributed.init_process_group``.  The reference initialises
``jax.distributed`` so that its device list spans every process; here a
mesh built after ``initialize_distributed`` spans the processes along its
last axis, and the collectives of ``parallel/collectives.py`` add one
``torch.distributed`` leg there (gloo for CPU tensors, NCCL for CUDA
tensors).  Single-process runs, the tests included, never need to call it.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_distributed", "process_info"]


def _backend() -> str:
    """gloo for CPU tensors, and NCCL for CUDA tensors where there is a card."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise the default process group if a multi-process environment
    is described.  Safe to call more than once; returns False when there is
    nothing to do (one process).

    Resolution order: explicit arguments (``coordinator_address`` as
    "host:port") > MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK > nothing.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address!r} given without the number of "
                         "processes and this process's id (WORLD_SIZE / RANK)")
    dist.init_process_group(_backend(), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """This process's index, the process count, and the devices a mesh takes
    by default: the visible cards (one CPU where there is none), per process
    and over all processes (every process alike)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
    }
