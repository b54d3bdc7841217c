"""Host geometry of the PyTorch port (grid, structured order, stencil plan,
structured assembly plan, SoA index maps) is bitwise equal to the JAX
package's at 0, 2 and 4 bisections."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info as jx_binfo  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as jx_grid  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order as jx_order  # noqa: E402
from dune_hdd_tpu.la.stencil import stencil_plan as jx_plan  # noqa: E402
from dune_hdd_tpu.la.stencil_assembly import (  # noqa: E402
    build_structured_assembly as jx_build,
    geometric_soa_maps as jx_maps,
)
from dune_hdd_tpu_torch.convert import assembly_plan_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.grid.boundaryinfo import make_boundary_info  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu_torch.la.stencil import stencil_plan  # noqa: E402
from dune_hdd_tpu_torch.la.stencil_assembly import (  # noqa: E402
    build_structured_assembly,
    geometric_soa_maps,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}


@pytest.fixture(autouse=True)
def _reference_defaults(monkeypatch):
    for key in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(key)


def _both(bisections):
    args = ((0.0, 0.0), (5.0, 1.0), (100, 20))
    g_j = jx_grid(*args, refinements=bisections)
    g_t = alu_cube_grid(*args, refinements=bisections)
    return g_j, g_t


def _assert_plans_equal(p_t, p_j):
    assert p_t.plan == p_j.plan
    assert p_t.lattice == tuple(p_j.lattice) and p_t.nd == p_j.nd
    assert (p_t.sigma_i, p_t.sigma_b, p_t.beta) == (p_j.sigma_i, p_j.sigma_b, p_j.beta)
    for name in ("vol_qp", "vol_G", "vol_wvals", "dof_perm"):
        np.testing.assert_array_equal(getattr(p_t, name), np.asarray(getattr(p_j, name)),
                                      err_msg=name)
    for row_t, row_j in zip(p_t.families, p_j.families, strict=True):
        for fam_t, fam_j in zip(row_t, row_j, strict=True):
            assert fam_t._fields == fam_j._fields
            for name, a, b in zip(fam_t._fields, fam_t, fam_j):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("bisections", [0, 2, 4])
def test_grid_order_and_plan_bitwise(bisections):
    g_j, g_t = _both(bisections)
    for name in ("vertices", "cells", "faces", "cell_faces", "face_cells", "face_local"):
        np.testing.assert_array_equal(getattr(g_t, name), getattr(g_j, name), err_msg=name)
    np.testing.assert_array_equal(g_t.face_normals, g_j.face_normals)
    np.testing.assert_array_equal(make_boundary_info(g_t, BI).dirichlet_faces,
                                  jx_binfo(g_j, BI).dirichlet_faces)

    o_j = jx_order(g_j, (0.0, 0.0), (5.0, 1.0))
    o_t = structured_cell_order(g_t, (0.0, 0.0), (5.0, 1.0))
    if bisections == 0:
        # the unrefined criss grid has 2 cell orientations, not 8 subclasses
        assert o_t is None and o_j is None
        return
    for name in ("perm", "inv", "offsets", "slot_source"):
        np.testing.assert_array_equal(getattr(o_t, name), getattr(o_j, name), err_msg=name)
    assert o_t.lattice == o_j.lattice and o_t.nxy == o_j.nxy
    assert stencil_plan(o_t) == jx_plan(o_j)


@pytest.mark.parametrize("bisections", [2, 4])
def test_assembly_plan_and_soa_maps_bitwise(bisections):
    g_j, g_t = _both(bisections)
    o_j = jx_order(g_j, (0.0, 0.0), (5.0, 1.0))
    o_t = structured_cell_order(g_t, (0.0, 0.0), (5.0, 1.0))
    p_j = jx_build(g_j, o_j, jx_binfo(g_j, BI))
    p_t = build_structured_assembly(g_t, o_t, make_boundary_info(g_t, BI))
    _assert_plans_equal(p_t, p_j)
    for a, b in zip(geometric_soa_maps(o_t, p_t), jx_maps(o_j, p_j), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the converted reference plan is the same plan
    _assert_plans_equal(assembly_plan_from_numpy(p_j), p_j)
