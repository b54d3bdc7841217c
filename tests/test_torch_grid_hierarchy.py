"""Grids of the PyTorch port against the JAX package's, bitwise: bisect's
and refine's RefinementInfo and fine grids, GridHierarchy.parent_cells of
the ESV2007 hierarchy, boundary faces, boundary ids and every boundary-info
type (host numpy on both sides, the same arithmetic)."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from dune_hdd_tpu.grid import boundaryinfo as jbi  # noqa: E402
from dune_hdd_tpu.grid import hierarchy as jh  # noqa: E402
from dune_hdd_tpu.grid import structured as js  # noqa: E402
from dune_hdd_tpu_torch.grid import boundaryinfo as tbi  # noqa: E402
from dune_hdd_tpu_torch.grid import hierarchy as th  # noqa: E402
from dune_hdd_tpu_torch.grid import structured as ts  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

GRID_FIELDS = ("vertices", "cells", "faces", "cell_faces", "face_cells", "face_local")
GEOMETRY = ("cell_volumes", "cell_diameters", "face_volumes", "face_normals",
            "boundary_faces", "boundary_vertices", "cell_centroids")
INFO_FIELDS = ("vertex_parents", "parent_cell", "child_index")


def _same_grid(g, h):
    for name in GRID_FIELDS + GEOMETRY:
        np.testing.assert_array_equal(getattr(g, name), getattr(h, name), err_msg=name)


def _same_info(a, b):
    for name in INFO_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
def test_bisect_refinement_info(steps):
    g = ts.alu_cube_grid((-1, -1), (1, 1), (4, 4), refinements=1)
    h = js.alu_cube_grid((-1, -1), (1, 1), (4, 4), refinements=1)
    for _ in range(steps):
        (g, gi), (h, hi) = ts.bisect(g), js.bisect(h)
        _same_info(gi, hi)
        _same_grid(g, h)


@pytest.mark.parametrize("start", ["alu", "rectangle"])
def test_red_refinement(start):
    if start == "alu":
        g = ts.alu_cube_grid((0, 0), (1, 1), (3, 2), refinements=2)
        h = js.alu_cube_grid((0, 0), (1, 1), (3, 2), refinements=2)
    else:
        g = ts.rectangle_grid((0, 0), (2, 1), (3, 2))
        h = js.rectangle_grid((0, 0), (2, 1), (3, 2))
    for _ in range(2):
        (g, gi), (h, hi) = ts.refine(g), js.refine(h)
        _same_info(gi, hi)
        _same_grid(g, h)


def test_hierarchy_parent_cells_and_prolongation():
    g0 = ts.alu_cube_grid((-1, -1), (1, 1), (4, 4), refinements=2)
    h0 = js.alu_cube_grid((-1, -1), (1, 1), (4, 4), refinements=2)
    gh = th.GridHierarchy(g0, 3, refine_fn=ts.bisect, steps_per_level=2)
    hh = jh.GridHierarchy(h0, 3, refine_fn=js.bisect, steps_per_level=2)
    assert len(gh) == len(hh) == 4
    _same_grid(gh.reference, hh.reference)
    for coarse in range(4):
        for fine in range(coarse, 4):
            np.testing.assert_array_equal(gh.parent_cells(coarse, fine),
                                          hh.parent_cells(coarse, fine))
    for a, b in zip(gh.infos(1), hh.infos(1)):
        _same_info(a, b)
    with pytest.raises(ValueError):
        gh.info(0)
    red = th.GridHierarchy(ts.rectangle_grid((0, 0), (1, 1), (2, 2)), 2)
    red_ref = jh.GridHierarchy(js.rectangle_grid((0, 0), (1, 1), (2, 2)), 2)
    _same_info(red.info(1), red_ref.info(1))
    v = np.random.default_rng(0).standard_normal(red[1].num_vertices)
    np.testing.assert_array_equal(th.prolong_vertex_values(v, red.info(1)),
                                  jh.prolong_vertex_values(v, red_ref.info(1)))


BOUNDARY_CONFIGS = [
    {"type": "stuff.grid.boundaryinfo.alldirichlet"},
    {"type": "stuff.grid.boundaryinfo.allneumann"},
    {"type": "stuff.grid.boundaryinfo.normalbased", "default": "dirichlet",
     "neumann": [[-1, 0], [1, 0]]},
    {"type": "stuff.grid.boundaryinfo.normalbased", "default": "neumann",
     "dirichlet": [[0, 1]]},
    {"type": "stuff.grid.boundaryinfo.idbased", "dirichlet": [1, 3], "neumann": "2"},
    {"type": "stuff.grid.boundaryinfo.idbased", "default": "neumann", "dirichlet": 4},
]


@pytest.mark.parametrize("config", BOUNDARY_CONFIGS, ids=lambda c: c["type"].rsplit(".", 1)[1])
def test_boundary_info(config):
    g = ts.alu_cube_grid((0, 0), (2, 1), (4, 2), refinements=3)
    h = js.alu_cube_grid((0, 0), (2, 1), (4, 2), refinements=3)
    np.testing.assert_array_equal(tbi.boundary_id_faces(g), jbi.boundary_id_faces(h))
    a, b = tbi.make_boundary_info(g, config), jbi.make_boundary_info(h, config)
    np.testing.assert_array_equal(a.dirichlet_faces, b.dirichlet_faces)
    np.testing.assert_array_equal(a.neumann_faces, b.neumann_faces)
    np.testing.assert_array_equal(a.dirichlet_vertices, b.dirichlet_vertices)
    assert (a.has_dirichlet, a.has_neumann) == (b.has_dirichlet, b.has_neumann)


def test_boundary_info_errors():
    g = ts.alu_cube_grid((0, 0), (1, 1), (2, 2))
    with pytest.raises(ValueError):
        tbi.make_boundary_info(g, {"type": "stuff.grid.boundaryinfo.idbased",
                                   "dirichlet": [1], "neumann": [1]})
    with pytest.raises(ValueError):
        tbi.make_boundary_info(g, {"type": "stuff.grid.boundaryinfo.unknown"})
