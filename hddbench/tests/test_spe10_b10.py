"""The SPE10 Model-1 cell at 10 bisections, ``spe10_m1.b10``, run at 2
bisections (48,000 DoF): the program reads ``correct`` true, traced and
untraced, with every metric of the cell that a CPU run can read, also on
the float64 operator that 10 bisections take (``operator64``, forced at 2);
with its answer broken (u = 0, half of it left out) it reads false.  The
configuration's lattice, DoF, middle lattice and settings are the program's
at 10 bisections."""
import json
from pathlib import Path

import pytest
import torch

from hddbench import run as harness
from hddbench.entries.spe10_bench import System

CELL = "spe10_m1.b10"
SMALL = {"bisections": 2, "lattice": [20, 100]}
ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _operator64(monkeypatch):
    from dune_hdd_tpu_torch import bench_harness

    settings = bench_harness._solver_settings
    monkeypatch.setattr(bench_harness, "_solver_settings",
                        lambda b, lattice: settings(b, lattice)._replace(operator64=True))


@pytest.mark.parametrize("operator64", [False, True])
@pytest.mark.parametrize("trace", [0, 1])
def test_program_is_correct(trace, operator64, cpu, monkeypatch):
    if operator64:
        _operator64(monkeypatch)
    result = harness.run_cell(CELL, 2 ** 31 + 23, 0.5, bool(trace), cpu, overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[kind] if CELL in m.get("workloads", [CELL])
            and m["source"] != "device_trace"}  # the device's readings need the card
    assert want <= set(result["metrics"])
    if trace:
        assert {"assemble_ms", "precond_build_ms", "pcg_iterations", "pcg_iter_ms"} <= want


def test_configuration_is_the_programs_at_10_bisections():
    from dune_hdd_tpu_torch.bench_harness import _select_mid_level, _solver_settings
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order

    cfg = json.loads((ROOT / "hddbench/configs/spe10_m1_b10.json").read_text())
    assert cfg["bisections"] == 10
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=cfg["bisections"])
    assert list(structured_cell_order(grid).lattice) == cfg["lattice"]
    assert grid.num_cells * cfg["nd"] == cfg["dofs"]
    KY, KX = cfg["lattice"]
    assert _select_mid_level(KY, KX, (100, 20)) == (400, 80)  # 4 x 4 sites an aggregate
    settings = _solver_settings(10, (KY, KX))
    assert settings.inner_rtol == 0.7 and settings.operator64
    assert cfg["precision"]["operator_assembly"] == "float64"


class Broken(System):
    fault = None

    def _outcome(self, sol):
        out = super()._outcome(sol)
        if self.fault == "unchanged":
            return out._replace(u=torch.zeros_like(out.u))
        u = out.u.clone()
        u[: u.numel() // 2] = 0.0
        return out._replace(u=u)


@pytest.mark.parametrize("operator64", [False, True])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_answer_is_not_correct(fault, operator64, cpu, monkeypatch):
    if operator64:
        _operator64(monkeypatch)
    broken = type("Broken", (Broken,), {"fault": fault})
    result = harness.run_cell(CELL, 2 ** 31 + 29, 0.3, False, cpu, overrides=SMALL,
                              system_factory=broken)
    assert result["correct"] is False
    assert result["check"]["res_own"]["value"] > result["check"]["res_own"]["limit"]
