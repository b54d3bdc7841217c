"""The 3D snapshot cell with its timed path broken underneath reads
``correct`` false: a solve that returns its state unchanged (u = 0), half
of the answer left out, one row of the frozen operator's product altered
where ``program_system`` reads it, and one entry of the frozen rhs
altered."""
import pytest
import torch

from hddbench import run as harness
from hddbench.entries.tensor_cg_snapshots import System

CELL = "thermalblock_3d_q1.snapshots"
SMALL = {"cells": [6, 6, 6], "dofs": 343}
ROW = 3 * 49 + 3 * 7 + 3  # the lattice's middle node, off the boundary


class Broken(System):
    fault = None

    def _outcome(self, u):
        out = super()._outcome(u)
        if self.fault == "unchanged":
            return out._replace(u=torch.zeros_like(out.u))
        if self.fault == "half":
            u = out.u.clone()
            u[: u.numel() // 2] = 0.0
            return out._replace(u=u)
        return out

    def program_system(self, mu, v):
        applied, b = super().program_system(mu, v)
        if self.fault == "row":
            applied = {"op_rel": applied["op_rel"].clone()}
            applied["op_rel"][ROW] *= 1.01
        elif self.fault == "rhs":
            b = b.clone()
            b[ROW] *= 1.01
        return applied, b


@pytest.mark.parametrize("fault, caught", [("unchanged", "res_ref"), ("half", "res_ref"),
                                           ("row", "op_rel"), ("rhs", "rhs_rel")])
def test_broken_path_is_not_correct(fault, caught, cpu):
    broken = type("Broken", (Broken,), {"fault": fault})
    result = harness.run_cell(CELL, 2 ** 31 + 3, 0.3, False, cpu, overrides=SMALL,
                              system_factory=broken)
    assert result["correct"] is False
    assert result["check"][caught]["value"] > result["check"][caught]["limit"]
