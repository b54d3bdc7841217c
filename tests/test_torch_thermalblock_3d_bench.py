"""The benchmark's 3D thermalblock cell (``thermalblock_3d_q1.snapshots``) at
small sizes on the CPU: the plain Q1 reference (``hddbench/reference/
thermalblock_q1_3d.py``) against its own definition and against the
program's frozen system, the answer of a 1e-10 ``cg.jacobi`` solve in the
reference's system, a run of the cell through the harness with the readers
of its spans, and the roofline reader's entry count, arithmetic and kernel
names."""
import ast
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hddbench import run as harness  # noqa: E402
from hddbench.lib.check import probe_vector, rel, scaled_residual  # noqa: E402
from hddbench.reference.thermalblock_q1_3d import (CORNERS, Reference,  # noqa: E402
                                                   element_matrix)
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
CELL = "thermalblock_3d_q1.snapshots"
CONFIG = json.loads((ROOT / "hddbench/configs/thermalblock_3d_q1.json").read_text())
LIMITS = json.loads((ROOT / f"hddbench/workloads/{CELL}.json").read_text())["limits"]
MU = np.array([0.1, 1.0, 0.5, 0.2, 0.9, 0.3, 0.7, 0.45])
CPU = torch.device("cpu")


def _small(cells):
    return {"cells": list(cells), "dofs": int(np.prod([c + 1 for c in cells]))}


@pytest.fixture(scope="module", params=[(6, 6, 6), (8, 8, 8), (4, 6, 8)],
                ids=lambda c: "x".join(map(str, c)))
def pair(request):
    """(the cell's system, the reference) at a small lattice."""
    from hddbench.entries.tensor_cg_snapshots import System

    config = dict(CONFIG, **_small(request.param))
    return System(config, CPU), Reference(config, CPU)


def test_element_matrix_is_the_trilinear_stiffness():
    """On a cube of side h: h/3 on the diagonal, 0 to an edge neighbour,
    -h/12 across a face diagonal and across the body diagonal; symmetric,
    rows summing to 0."""
    h = 0.25
    K = element_matrix([h, h, h])
    for i, a in enumerate(CORNERS):
        for j, b in enumerate(CORNERS):
            apart = sum(x != y for x, y in zip(a, b))
            assert K[i, j] == pytest.approx({0: h / 3, 1: 0.0, 2: -h / 12, 3: -h / 12}[apart],
                                            abs=1e-15)
    np.testing.assert_allclose(K.sum(axis=1), 0.0, atol=1e-15)
    np.testing.assert_array_equal(K, K.T)


def test_reference_diagonal_and_symmetry():
    """The matrix-free operator read column by column at 3^3 cells:
    symmetric, its diagonal ``diagonal()``, identity rows at the boundary."""
    config = dict(CONFIG, **_small((3, 3, 3)))
    op = Reference(config, CPU).system(MU)
    n = config["dofs"]
    A = torch.stack([op.matvec(e) for e in torch.eye(n, dtype=torch.float64)], dim=1)
    torch.testing.assert_close(A, A.T, rtol=0, atol=1e-16)
    torch.testing.assert_close(torch.diagonal(A), op.diagonal(), rtol=0, atol=1e-16)
    boundary = (op.interior.reshape(-1) == 0).nonzero().reshape(-1)
    torch.testing.assert_close(A[boundary], torch.eye(n, dtype=torch.float64)[boundary])
    assert float(op.rhs.sum()) == pytest.approx(8 / 27)  # 2^3 interior nodes, h^3 each


def test_program_system_is_the_reference(pair):
    system, reference = pair
    v = probe_vector(2 ** 31 + 1, system.dofs, CPU)
    applied, b = system.program_system(MU, v)
    op = reference.system(MU)
    assert rel(applied["op_rel"], op.matvec(v)) <= 1e-12
    assert rel(b, op.rhs) <= 1e-12


@pytest.mark.parametrize("cells", [(6, 6, 6), (4, 6, 8)], ids=lambda c: "x".join(map(str, c)))
def test_roofline_counts_the_operators_stored_entries(cells):
    """The entries the roofline reader counts are those the frozen operator
    stores, whatever the ELL's padded width."""
    from hddbench.entries.tensor_cg_snapshots import System
    from hddbench.metrics.ell_spmv_roofline_pct import stored_entries

    system = System(dict(CONFIG, **_small(cells)), CPU)
    A = system.disc.freeze_operator(system._parse(MU))
    assert stored_entries(cells) == A.values.numel() < system.dofs * CONFIG["ell_width"]


def test_cg_answer_meets_the_cells_limit(pair):
    system, reference = pair
    out = system.solve(MU)
    assert out.ok and out.iterations > 0
    assert scaled_residual(reference.system(MU), out.u) < LIMITS["res_ref"]


def test_float32_control_fails_the_residual_limit(pair):
    """The control that sets the limit from above: the same CG on the
    float32 form of the system reads ``res_ref`` above the cell's limit."""
    system, reference = pair
    assert scaled_residual(reference.system(MU), system.solve_lower(MU)) > LIMITS["res_ref"]


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_at_small_size(trace):
    result = harness.run_cell(CELL, 2 ** 31 + 17, 0.5, bool(trace), CPU,
                              overrides=_small((6, 6, 6)))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    metrics = result["metrics"]
    if trace:
        spans = ("freeze_ms", "pcg_iterations", "pcg_iter_ms")
        assert all(metrics[m]["value"] > 0 for m in spans)
        # no device trace on the CPU
        assert "ell_spmv_roofline_pct" not in metrics and "device_idle_pct" not in metrics
        assert set(metrics) == set(spans)
    else:
        assert set(metrics) == {"tts_s", "peak_gb", "setup_s"}


def test_reference_imports_neither_jax_nor_the_port():
    path = ROOT / "hddbench/reference/thermalblock_q1_3d.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    assert names == {"__future__", "numpy", "torch"}


# kernel names of the traced 3D snapshot solve (torch 2.x on an H100)
_NAMES = {
    "product": "void at::native::vectorized_elementwise_kernel<2, at::native::BinaryFunctor<double, "
               "double, double, at::native::binary_internal::MulFunctor<double> >, "
               "std::array<char*, 3ul> >(int, ...)",
    "gather": "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
              "at::native::index_kernel_impl<at::native::OpaqueType<8> >(...)",
    "row_sum": "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<double, "
               "at::native::func_wrapper_t<double, at::native::sum_functor<double, double, "
               "double>::operator()(...)",
    "hand": "ell_spmv_f64_kernel",
    "ell_build": "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<"
                 "at::native::index_put_kernel_impl<at::native::OpaqueType<8> >(...)",
    "scaled_p": "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
                "at::native::BinaryFunctor<double, double, double, "
                "at::native::binary_internal::MulFunctor<double> > >(...)",
    "freeze": "void at::native::vectorized_elementwise_kernel<2, at::native::AUnaryFunctor<double, "
              "double, double, at::native::binary_internal::MulFunctor<double> >, ...)",
    "add": "void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<double>, "
           "std::array<char*, 3ul> >(...)",
    "dot": "void dot_kernel<double, 128, 0, cublasDotParams<cublasGemvTensor<double const>, ...)",
}


def test_roofline_reader_reads_the_spmv_kernels():
    from hddbench.metrics import ell_spmv_roofline_pct as reader

    rx = re.compile(reader.KERNELS)
    matched = {k for k, name in _NAMES.items() if rx.search(name)}
    assert matched == {"product", "gather", "row_sum", "hand"}
    assert reader.stored_entries(CONFIG["cells"]) == 385 ** 3 == 57_066_625
    assert reader.ell_bytes(2_146_689, 57_066_625) == 57_066_625 * 12 + 2_146_689 * 16
    seconds = {_NAMES[k]: 0.1 for k in _NAMES}
    trace = SimpleNamespace(summary=SimpleNamespace(device_s=seconds),
                            outcomes=[{"iterations": 399}, {"iterations": 400}])
    run = SimpleNamespace(trace=trace, config=CONFIG)
    want = 100 * (400 + 401) * reader.ell_bytes(CONFIG["dofs"], 57_066_625) / 3.35e12 / 0.4
    assert reader.read(run) == pytest.approx(want)
    assert reader.read(SimpleNamespace(trace=None, config=CONFIG)) is None
