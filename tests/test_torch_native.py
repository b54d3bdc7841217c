"""The native host-side index builders of the PyTorch port (native.py, built
from its own csrc/hdd_native.cpp with g++ into dune_hdd_tpu_torch/_build/)
against the JAX package's bindings of the same C++ and the port's numpy
connectivity (grid/structured._build_connectivity): the same faces, numbered
by first touch instead of sorted, with the same cells on each side and the
inside cell's orientation (``chip_smoke.same_connectivity``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.grid.structured import Grid, alu_cube_grid, rectangle_grid  # noqa: E402
from dune_hdd_tpu_torch.native import build_connectivity, dedup_pattern, native_available  # noqa: E402

from chip_smoke import same_connectivity  # noqa: E402  (the check chip_smoke.py runs at 12.29M)
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def toolchain():
    if not native_available():
        pytest.skip("no g++")


def test_native_connectivity_matches_numpy(toolchain):
    from dune_hdd_tpu.native import build_connectivity as j_build

    g = rectangle_grid((0, 0), (1, 1), (7, 5), "triangle")
    out = build_connectivity(g.cells)
    assert same_connectivity(out, g)
    for a, b in zip(out, j_build(np.asarray(g.cells))):
        np.testing.assert_array_equal(a, b)
    # a consistent Grid can be built on the native connectivity
    faces, cell_faces, face_cells, face_local = out
    g2 = Grid(vertices=g.vertices, cells=g.cells, cell_type="triangle", faces=faces,
              cell_faces=cell_faces, face_cells=face_cells, face_local=face_local)
    assert g2.cell_volumes.sum() == pytest.approx(1.0)
    for f in range(g2.num_faces):
        cin, cout = g2.face_cells[f]
        assert g2.cell_faces[cin, g2.face_local[f, 0]] == f
        if cout >= 0:
            assert g2.cell_faces[cout, g2.face_local[f, 1]] == f


def test_native_dedup_matches_numpy(toolchain):
    from dune_hdd_tpu.native import dedup_pattern as j_dedup

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, 1000) * 50 + rng.integers(0, 50, 1000)
    perm, seg_ids, slot_keys = dedup_pattern(keys)
    np.testing.assert_array_equal(perm, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(slot_keys, np.unique(keys))
    np.testing.assert_array_equal(slot_keys[seg_ids], keys[perm])
    for a, b in zip((perm, seg_ids, slot_keys), j_dedup(keys)):
        np.testing.assert_array_equal(a, b)


def test_native_grid_end_to_end(toolchain):
    """A grid built on the native connectivity solves as the reference's
    native-path grid does (its L2 error) and as the numpy-connectivity grid."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.functions.esv2007 import Testcase1ExactSolution
    from dune_hdd_tpu_torch.ops.norms import error_norms
    from dune_hdd_tpu_torch.problems import ESV2007Problem

    g = alu_cube_grid((-1, -1), (1, 1), (4, 4), refinements=2)
    faces, cell_faces, face_cells, face_local = build_connectivity(g.cells)
    assert same_connectivity((faces, cell_faces, face_cells, face_local), g)
    gn = Grid(vertices=g.vertices, cells=g.cells, cell_type=g.cell_type, faces=faces,
              cell_faces=cell_faces, face_cells=face_cells, face_local=face_local)
    errors = []
    for grid in (gn, g):
        d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                 ESV2007Problem(), device="cpu", only_these_products=())
        u = d.solve(options={"type": "direct"})
        errors.append(float(error_norms(d.space, u, Testcase1ExactSolution())["L2"]))
    assert errors[0] == pytest.approx(1.83e-2, rel=5e-3)
    assert errors[0] == pytest.approx(errors[1], rel=1e-12)
