"""The benchmark's CPU tests: ``python -m pytest hddbench/tests`` from the
repository's root (not part of the repository's own test lane).  They run
the harness's functions at small sizes with the kernels' plain versions."""
import pytest
import torch

SMALL = {
    "spe10_m1.b8": {"bisections": 2, "lattice": [20, 100]},
    "thermalblock_2x2.snapshots": {"bisections": 4, "lattice": [8, 8]},
}


@pytest.fixture
def cpu():
    return torch.device("cpu")
