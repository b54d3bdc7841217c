"""The benchmark's OS2014 cell (``os2014_l6.snapshots``) at levels 2-3 on the
CPU: the plain reference (``hddbench/reference/os2014_swipdg.py``) against
its quadrature tables and, at mu = 1, the SWIPDG reference of a constant
diffusion; the program's frozen "reference"-scheme system against it on
seeded mu; the answer of the studies' solver (``stencil_cg`` with the macro
(4, 4), two-level weighted deflation, float64, 1e-12) in the reference's
system; the deflation preconditioner's spans and counters; and a run of the
cell through the harness with the readers of its spans."""
import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hddbench import run as harness  # noqa: E402
from hddbench.lib.check import probe_vector, rel, scaled_residual  # noqa: E402
from hddbench.reference.os2014_swipdg import Reference, cell_rule, face_rule  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
CELL = "os2014_l6.snapshots"
CONFIG = json.loads((ROOT / "hddbench/configs/os2014_swipdg.json").read_text())
LIMITS = json.loads((ROOT / f"hddbench/workloads/{CELL}.json").read_text())["limits"]
CPU = torch.device("cpu")


def _small(level):
    side = 4 << level
    return {"level": level, "bisections": 2 + 2 * level, "dofs": 3 * 8 * side * side,
            "lattice": [side, side]}


def _mus(seed, n=3):
    return np.random.default_rng(seed).uniform(0.1, 1.0, n)


@pytest.fixture(scope="module", params=[2, 3], ids=lambda lv: f"level{lv}")
def pair(request):
    """(the cell's system, the reference) at a small level."""
    from hddbench.entries.os2014_snapshots import System

    config = dict(CONFIG, **_small(request.param))
    return System(config, CPU), Reference(config, CPU)


def test_quadrature_tables_are_exact_to_their_degree():
    """The cell rule integrates x^a y^b, a + b <= 5, over the reference
    triangle exactly (a! b! / (a + b + 2)!); the face rule t^k, k <= 7, over [0, 1]."""
    pts, w = cell_rule()
    for a in range(6):
        for b in range(6 - a):
            exact = math.factorial(a) * math.factorial(b) / math.factorial(a + b + 2)
            assert float((w * pts[:, 0] ** a * pts[:, 1] ** b).sum()) == pytest.approx(
                exact, rel=1e-14, abs=1e-16)
    t, tw = face_rule()
    for k in range(8):
        assert float((tw * t ** k).sum()) == pytest.approx(1.0 / (k + 1), rel=1e-14)


def test_reference_at_mu_one_is_constant_diffusion_swipdg():
    """At mu = 1 the diffusion is 1: the operator is ``swipdg_p1``'s SWIPDG
    of the unit diffusion, assembled there per cell and with 2 Gauss points."""
    from hddbench.reference import swipdg_p1

    config = dict(CONFIG, **_small(2))
    op = Reference(config, CPU).system(1.0)
    grid = swipdg_p1.criss_grid(*config["domain"], config["cubes"], config["bisections"])
    ones = torch.ones(len(grid.cells), dtype=torch.float64)
    unit = swipdg_p1.assemble(swipdg_p1.geometry(grid, CPU), ones, ones, ones)
    v = probe_vector(2 ** 31 + 9, config["dofs"], CPU)
    assert rel(op.matvec(v), unit.matvec(v)) <= 1e-13
    torch.testing.assert_close(op.diagonal(), unit.diagonal(), rtol=1e-13, atol=0)


def test_program_system_is_the_reference(pair):
    system, reference = pair
    v = probe_vector(2 ** 31 + 1, system.dofs, CPU)
    for mu in _mus(2 ** 31 + 1):
        applied, b = system.program_system(np.array([mu]), v)
        op = reference.system(mu)
        assert rel(applied["op_rel"], op.matvec(v)) <= 1e-12
        assert rel(b, op.rhs) <= 1e-12


def test_deflated_answer_meets_the_residual(pair):
    system, reference = pair
    mu = _mus(2 ** 31 + 2, 1)
    out = system.solve(mu)
    assert out.ok and out.iterations > 0
    assert scaled_residual(reference.system(mu), out.u) <= 1e-9 < LIMITS["res_ref"]


def test_float32_control_fails_the_residual_limit(pair):
    """The control that sets the limit from above: the same deflated PCG on
    the float32 form of the system reads ``res_ref`` above the cell's limit."""
    system, reference = pair
    mu = _mus(2 ** 31 + 2, 1)
    assert scaled_residual(reference.system(mu), system.solve_lower(mu)) > LIMITS["res_ref"]


def test_solve_records_the_deflation_build_and_applies(pair):
    """One solve: one ``deflation.build`` span under ``precond.build``, the
    dense coarse branch once, 16 aggregates, and one ``deflation.applies``
    per application of M (each in a ``precond.apply`` span on the CPU);
    recording leaves the iterates bitwise as they are."""
    from dune_hdd_tpu_torch.utils.profiling import recording

    system, _ = pair
    mu = _mus(2 ** 31 + 3, 1)
    quiet = system.solve(mu)
    with recording() as rec:
        out = system.solve(mu)
    assert out.iterations == quiet.iterations and torch.equal(out.u, quiet.u)
    builds = [i for i, s in enumerate(rec.spans) if s.name == "deflation.build"]
    assert len(builds) == 1 and rec.path(builds[0])[-2:] == ("precond.build", "deflation.build")
    assert rec.totals_under("deflation.coarse.") == {"dense": 1}
    assert rec.total("deflation.aggregates") == 16
    applies = sum(1 for s in rec.spans if s.name == "precond.apply")
    assert rec.total("deflation.applies") == applies == out.iterations + 1


def test_three_level_build_counts_the_multilevel_branch(pair):
    """The three-level form (a middle lattice, as the SPE10 bench builds it)
    counts ``deflation.coarse.multilevel`` and no other branch, and the
    middle lattice's aggregates."""
    from dune_hdd_tpu_torch.la.stencil import stencil_deflation_preconditioner
    from dune_hdd_tpu_torch.utils.profiling import recording

    system, _ = pair
    sysm = system._system(system._parse(_mus(2 ** 31 + 4, 1)))
    side = sysm.S.lattice[0]
    w = (1.0 / sysm.s)[sysm.to_soa].reshape(sysm.B.shape)
    with recording() as rec:
        M = stencil_deflation_preconditioner(sysm.S, (4, 4), weight=w,
                                             mid_shape=(side // 2, side // 2))
        M(sysm.B)
    assert rec.totals_under("deflation.coarse.") == {"multilevel": 1}
    assert rec.total("deflation.aggregates") == (side // 2) ** 2
    assert rec.total("deflation.applies") == 1
    assert [s.name for s in rec.spans] == ["deflation.build"]


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_at_small_size(trace):
    result = harness.run_cell(CELL, 2 ** 31 + 17, 0.5, bool(trace), CPU, overrides=_small(2))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    metrics = result["metrics"]
    if trace:
        spans = ("freeze_ms", "deflation_build_ms", "pcg_iterations", "pcg_iter_ms")
        assert all(metrics[m]["value"] > 0 for m in spans)
        assert set(metrics) == set(spans)  # no device trace on the CPU
    else:
        assert set(metrics) == {"tts_s", "peak_gb", "setup_s"}


def test_reference_imports_neither_jax_nor_the_port():
    """The reference and the grid module it takes from ``swipdg_p1``."""
    for name, wanted in (("os2014_swipdg", {"__future__", "math", "numpy", "torch",
                                            ".swipdg_p1"}),
                         ("swipdg_p1", {"__future__", "math", "typing", "numpy", "torch"})):
        names = set()
        for node in ast.walk(ast.parse((ROOT / f"hddbench/reference/{name}.py").read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add("." + node.module if node.level else node.module.split(".")[0])
        assert names == wanted
