"""The OS2014 snapshot cell at level 2 (6,144 DoF): the program reads
``correct`` true, traced and untraced, with every metric of the cell that a
CPU run can read; with its timed path broken underneath it reads false: a
solve that returns its state unchanged (u = 0), half of the answer left out,
one row of the frozen operator's product altered where ``program_system``
reads it, and one entry of the frozen rhs altered."""
import json
from pathlib import Path

import pytest
import torch

from hddbench import run as harness
from hddbench.entries.os2014_snapshots import System

CELL = "os2014_l6.snapshots"
SMALL = {"level": 2, "bisections": 6, "dofs": 6144, "lattice": [16, 16]}
ROW = 3 * 1000 + 1  # a DoF of an inner cell
SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
def test_program_is_correct(trace, cpu):
    result = harness.run_cell(CELL, 2 ** 31 + 17, 0.5, bool(trace), cpu, overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[kind] if CELL in m.get("workloads", [CELL])
            and m["source"] != "device_trace"}  # the device's readings need the card
    assert want <= set(result["metrics"])
    if trace:
        assert {"freeze_ms", "deflation_build_ms", "pcg_iter_ms"} <= want


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
