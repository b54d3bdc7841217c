"""The plain reference against the program at small sizes: the same grid,
the same input field, the same operator and rhs within the program's
precision."""
import numpy as np
import pytest
import torch

from hddbench.lib.check import rel
from hddbench.reference import spe10, thermalblock
from hddbench.reference.swipdg_p1 import criss_grid
from hddbench.traffic.lognormal_field import synthetic_model1_field


@pytest.mark.parametrize("case", [("spe10", 2), ("spe10", 4), ("thermalblock", 4),
                                  ("thermalblock", 7)])
def test_grid_is_the_programs(case):
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid

    name, b = case
    lo, up, n = ((0.0, 0.0), (5.0, 1.0), (100, 20)) if name == "spe10" else \
        ((0.0, 0.0), (1.0, 1.0), (4, 4))
    g = alu_cube_grid(lo, up, n, refinements=b)
    r = criss_grid(lo, up, n, b)
    assert np.array_equal(g.vertices[g.cells], r.vertices[r.cells])


def test_synthetic_field_is_the_programs():
    from dune_hdd_tpu_torch.functions.spe10 import _synthetic_model1_field

    assert np.array_equal(synthetic_model1_field(), _synthetic_model1_field())


def _program_vs_reference(system, reference, inp, seed=3):
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(system.dofs, generator=gen, dtype=torch.float64)
    applied, b = system.program_system(inp, v)
    op = reference.system(inp)
    Av = op.matvec(v)
    return max(rel(x, Av) for x in applied.values()), rel(b, op.rhs)


def test_spe10_operator_is_the_programs(cpu):
    from hddbench.entries.spe10_bench import System

    config = {"bisections": 2, "tol": 1e-6, "preconditioner": "stencil2"}
    field = torch.as_tensor(synthetic_model1_field(), dtype=torch.float32) * 1.7
    op_rel, rhs_rel = _program_vs_reference(System(config, cpu), spe10.Reference(config, cpu),
                                            field)
    assert op_rel < 1e-6 and rhs_rel < 1e-6  # the program assembles in float32
    # (applied in float32 and in float64: the largest gap of the two)


def test_thermalblock_operator_is_the_programs(cpu):
    from hddbench.entries.thermalblock_snapshots import System

    config = {"domain": [[0.0, 0.0], [1.0, 1.0]], "cubes": [4, 4], "blocks": [2, 2],
              "bisections": 4, "solver": {"type": "stencil_cg", "precision": 1e-8,
                                          "max_iter": 50000}}
    op_rel, rhs_rel = _program_vs_reference(System(config, cpu),
                                            thermalblock.Reference(config, cpu),
                                            np.array([0.3, 0.9, 0.15, 0.6]))
    assert op_rel < 1e-13 and rhs_rel < 1e-13  # float64 on both sides


def test_reference_operator_is_symmetric(cpu):
    config = {"bisections": 2}
    ref = spe10.Reference(config, cpu)
    op = ref.system(torch.as_tensor(synthetic_model1_field()))
    gen = torch.Generator().manual_seed(0)
    x, y = (torch.randn(op.rhs.shape, generator=gen, dtype=torch.float64) for _ in range(2))
    assert abs(float(x @ op.matvec(y) - y @ op.matvec(x))) < 1e-10 * float(
        torch.linalg.norm(x) * torch.linalg.norm(op.matvec(y)))
