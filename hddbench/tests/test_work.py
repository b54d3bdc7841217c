"""The counted work of the roofline readers against the program's byte
count and plane shapes at the cells' sizes, and the trace arithmetic."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from hddbench.lib.trace import TraceSummary, _label_gaps, busy_union
from hddbench.metrics import device_idle_pct, plane_spmv_roofline_pct, sym_spmv_roofline_pct

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "hddbench/configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,lo,up,cubes", [
    ("spe10_m1_swipdg", (0.0, 0.0), (5.0, 1.0), (100, 20)),
    ("thermalblock_2x2_swipdg", (0.0, 0.0), (1.0, 1.0), (4, 4))])
def test_lattice_and_dofs_are_the_programs(name, lo, up, cubes):
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order

    cfg = _config(name)
    grid = alu_cube_grid(lo, up, cubes, refinements=cfg["bisections"])
    assert list(structured_cell_order(grid).lattice) == cfg["lattice"]
    assert grid.num_cells * cfg["nd"] == cfg["dofs"]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sym_bytes_are_the_programs(itemsize):
    from dune_hdd_tpu_torch.kernels.sym_plane_spmv import sym_plane_bytes

    cfg = _config("spe10_m1_swipdg")
    for lattice in (cfg["lattice"], (7, 12)):
        assert sym_spmv_roofline_pct.sym_plane_bytes(cfg["nd"], lattice, itemsize) == \
            sym_plane_bytes(cfg["nd"], lattice, itemsize)


def test_plane_bytes_are_the_plane_shapes():
    cfg = _config("thermalblock_2x2_swipdg")
    nd, (KY, KX) = cfg["nd"], cfg["lattice"]
    planes = torch.empty((4, nd, nd, 8, KY, KX), dtype=torch.float64, device="meta")
    X = torch.empty((nd, 8, KY, KX), dtype=torch.float64, device="meta")
    want = (planes.numel() + 2 * X.numel()) * 8
    assert plane_spmv_roofline_pct.plane_bytes(nd, (KY, KX), 8) == want


def test_busy_union_and_gaps():
    busy, gaps = busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)])
    assert busy == 5 and gaps == [(3, 5), (6, 8)]
    host = [(0, -10, "outer"), (2.5, -5.5, "inner")]
    assert _label_gaps(gaps, host) == {"inner": 2e-9, "outer": 2e-9}


def _run(device_s, outcomes, cfg, busy=0.5, window=2.0, ops=10):
    summary = TraceSummary(busy, window, device_s, {}, ops)
    return SimpleNamespace(trace=SimpleNamespace(summary=summary, outcomes=outcomes,
                                                 untraced_s=window), config=cfg)


def test_roofline_readers():
    cfg = _config("spe10_m1_swipdg")
    need = 100 * sym_spmv_roofline_pct.sym_plane_bytes(3, cfg["lattice"], 4) + \
        9 * sym_spmv_roofline_pct.sym_plane_bytes(3, cfg["lattice"], 8)
    seconds = need / 3.35e12 / 0.5  # half the bandwidth
    names = {"void sym_plane_spmv_kernel<3, float>(float const*)": seconds / 2,
             "void sym_plane_spmv_kernel<3, double>(double const*)": seconds / 2,
             "void plane_spmv_kernel<3, float>(CUtensorMap)": 1.0}
    run = _run(names, [{"iterations": 100, "sweeps": 9}], cfg)
    assert sym_spmv_roofline_pct.read(run) == pytest.approx(50.0)
    cfg = _config("thermalblock_2x2_swipdg")
    need = 1000 * plane_spmv_roofline_pct.plane_bytes(3, cfg["lattice"], 8)
    run = _run({"void plane_spmv_kernel<3, double>(CUtensorMap)": need / 3.35e12 / 0.8,
                "void sym_plane_spmv_kernel<3, double>(double const*)": 5.0},
               [{"iterations": 1000, "sweeps": 0}], cfg)
    assert plane_spmv_roofline_pct.read(run) == pytest.approx(80.0)
    assert device_idle_pct.read(run) == pytest.approx(75.0)
    assert plane_spmv_roofline_pct.read(_run({}, [{"iterations": 5, "sweeps": 0}], cfg)) is None
