"""Quad and interval grids of the PyTorch port against the JAX package's
(x64, CPU):

* grids: counts, geometry, connectivity and the nested red refinement of
  quads and intervals, the grid providers, the normal- and id-based
  boundary infos: exact;
* Q1 / Q2 and interval order 1-3 spaces: DoF maps, nodal points, shape
  values and gradients: exact or 1e-14 x max;
* SWIPDG (quads: ESV2007 on the level-0 cube grid, 8x8 quads, Q1 and Q2;
  intervals: orders 1-3 on 8 cells) and CG (Q1, Q2; intervals P1) operators, rhs and
  products: 1e-12 x max; direct solutions: 1e-10 x max; interval EOC and
  the order-3 cubic, as the reference's own interval tests;
* the ESV2007 cube hierarchy (the "cube" variant's 1 initial red
  refinement);
* BlockSWIPDG [2 2] on the level-1 cube grid with eta_OS2014 and its
  per-subdomain indicators on the reference's solution: 1e-8 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations import CGDiscretization as JCG  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.grid import structured as jg  # noqa: E402
from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info as j_bi  # noqa: E402
from dune_hdd_tpu.grid.hierarchy import GridProviders as JProviders  # noqa: E402
from dune_hdd_tpu.ops.spaces import Space as JSpace  # noqa: E402
from dune_hdd_tpu.problems import ESV2007Problem as JP  # noqa: E402
from dune_hdd_tpu.problems.interfaces import Problem as JProblem  # noqa: E402
from dune_hdd_tpu.testcases import ESV2007TestCase as JTC  # noqa: E402
from dune_hdd_tpu_torch.discretizations import CGDiscretization as TCG  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.grid import structured as tg  # noqa: E402
from dune_hdd_tpu_torch.grid.boundaryinfo import make_boundary_info as t_bi  # noqa: E402
from dune_hdd_tpu_torch.grid.hierarchy import GridProviders as TProviders  # noqa: E402
from dune_hdd_tpu_torch.ops.norms import error_norms  # noqa: E402
from dune_hdd_tpu_torch.ops.spaces import Space as TSpace  # noqa: E402
from dune_hdd_tpu_torch.problems import ESV2007Problem as TP  # noqa: E402
from dune_hdd_tpu_torch.problems.interfaces import Problem as TProblem  # noqa: E402
from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase as TTC  # noqa: E402

DIRICHLET = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
NORMAL = {"type": "stuff.grid.boundaryinfo.normalbased", "default": "dirichlet",
          "neumann": [[1.0, 0.0]]}
IDS = {"type": "stuff.grid.boundaryinfo.idbased", "default": "dirichlet", "neumann": "2 4"}
GRID_ARRAYS = ("vertices", "cells", "faces", "cell_faces", "face_cells", "face_local",
               "face_normals", "face_volumes", "cell_volumes", "cell_diameters",
               "cell_centroids", "boundary_vertices")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rel=1e-12, atol=None):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    bound = atol if atol is not None else rel * max(np.abs(b).max(), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=bound)


def _same_grid(t, j):
    assert t.cell_type == j.cell_type
    for name in GRID_ARRAYS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


@pytest.mark.parametrize("kind", ["quad", "interval"])
def test_grid_refinement_matches_reference(kind):
    if kind == "quad":
        t, j = (pkg.rectangle_grid((-1, -1), (1, 1), (3, 2), "quad") for pkg in (tg, jg))
    else:
        t, j = tg.interval_grid(0, 1, 5), jg.interval_grid(0, 1, 5)
    _same_grid(t, j)
    for _ in range(2):
        (t, ti), (j, ji) = tg.refine(t), jg.refine(j)
        _same_grid(t, j)
        for name in ("vertex_parents", "parent_cell", "child_index"):
            np.testing.assert_array_equal(getattr(ti, name), getattr(ji, name))
    assert t.num_cells == j.num_cells == (6 * 16 if kind == "quad" else 20)
    assert np.isclose(t.cell_volumes.sum(), 4.0 if kind == "quad" else 1.0)
    with pytest.raises(ValueError):
        tg.bisect(t)


def test_grid_providers():
    cube = {"lower_left": -1, "upper_right": 1, "num_elements": 4, "cell_type": "quad",
            "num_refinements": 1}
    interval = {"lower_left": 0.0, "upper_right": 2.0, "num_elements": 4, "num_refinements": 1}
    for name, cfg in (("stuff.grid.provider.cube", cube), ("cube", cube),
                      ("stuff.grid.provider.interval", interval), ("interval", interval)):
        _same_grid(TProviders.create(name, cfg), JProviders.create(name, cfg))
    assert TProviders.available() == JProviders.available()
    with pytest.raises(ValueError):
        TProviders.create("bogus")


@pytest.mark.parametrize("kind", ["quad", "interval"])
@pytest.mark.parametrize("config", [DIRICHLET, NORMAL, IDS])
def test_boundary_infos(kind, config):
    if kind == "quad":
        t, j = (pkg.rectangle_grid((0, 0), (1, 1), (3, 3), "quad") for pkg in (tg, jg))
    else:
        t, j = tg.interval_grid(0, 1, 4), jg.interval_grid(0, 1, 4)
        if config is NORMAL:
            config = dict(NORMAL, neumann=[[1.0]])
    bt, bj = t_bi(t, config), j_bi(j, config)
    for name in ("dirichlet_faces", "neumann_faces", "dirichlet_vertices"):
        np.testing.assert_array_equal(getattr(bt, name), getattr(bj, name), err_msg=name)


@pytest.mark.parametrize("kind,order,continuous,basis", [
    ("quad", 1, False, "nodal"), ("quad", 1, True, "nodal"), ("quad", 1, False, "p1"),
    ("quad", 2, False, "nodal"), ("interval", 1, False, "nodal"),
    ("interval", 2, False, "nodal"), ("interval", 3, False, "nodal"),
    ("interval", 2, True, "nodal"), ("interval", 3, True, "nodal")])
def test_spaces(kind, order, continuous, basis):
    if kind == "quad":
        t, j = (pkg.rectangle_grid((-1, -1), (1, 1), (3, 2), "quad") for pkg in (tg, jg))
    else:
        t, j = tg.interval_grid(0, 1, 5), jg.interval_grid(0, 1, 5)
    ts = TSpace(t, continuous, order, basis=basis, device="cpu")
    js_ = JSpace(j, continuous, order, basis=basis)
    assert (ts.num_dofs, ts.shape_count) == (js_.num_dofs, js_.shape_count)
    np.testing.assert_array_equal(ts.cell_dofs, js_.cell_dofs)
    if basis == "nodal":
        np.testing.assert_array_equal(ts.nodal_points, js_.nodal_points)
    verts = t.cell_vertices
    pts = verts.mean(axis=1, keepdims=True) * 0.6 + 0.4 * verts
    for name in ("shape_values", "shape_gradients"):
        _close(getattr(ts, name)(torch.as_tensor(verts), torch.as_tensor(pts)),
               getattr(js_, name)(jnp.asarray(verts), jnp.asarray(pts)), rel=1e-14)


def _sine(fn, pkg, lib):
    """-u'' = pi^2 sin(pi x) on (0,1), u = sin(pi x), zero Dirichlet."""
    exact = fn.LambdaFunction(lambda x: lib.sin(np.pi * x[..., 0]), order=8, name="exact")
    problem = pkg(fn.ConstantFunction(1.0, "diffusion_factor"), fn.constant_matrix(1.0, dim=1),
                  fn.LambdaFunction(lambda x: np.pi * np.pi * lib.sin(np.pi * x[..., 0]),
                                    order=8, name="force"),
                  fn.ConstantFunction(0.0, "dirichlet"), fn.ConstantFunction(0.0, "neumann"))
    return exact, problem


def _cubic(fn, pkg):
    """-u'' = -6x with u = x^3 on the boundary: order 3 is exact."""
    return pkg(fn.ConstantFunction(1.0, "diffusion_factor"), fn.constant_matrix(1.0, dim=1),
               fn.LambdaFunction(lambda x: -6.0 * x[..., 0], order=1, name="force"),
               fn.LambdaFunction(lambda x: x[..., 0] ** 3, order=3, name="dirichlet"),
               fn.ConstantFunction(0.0, "neumann"))


PRODUCTS = ("l2", "h1_semi", "boundary_l2", "penalty", "energy")


def _same_discretization(d, jd, products=PRODUCTS):
    assert d.space.num_dofs == jd.space.num_dofs
    _close(d.freeze_operator({}).values, jd.freeze_operator(None).values)
    _close(d.freeze_rhs({}), jd.freeze_rhs(None))
    for p in products:
        _close(d.product_matrix(p).values, jd.product_matrix(p).values)
    _close(d.solve(options={"type": "direct"}), jd.solve(None, options={"type": "direct"}),
           rel=1e-10)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interval_swipdg_matches_reference(order):
    _, tprob = _sine(tf, TProblem, torch)
    _, jprob = _sine(jf, JProblem, jnp)
    bi = NORMAL | {"neumann": [[1.0]]}
    d = TD(tg.interval_grid(0, 1, 8), bi, tprob, order=order, only_these_products=PRODUCTS,
           device="cpu")
    jd = JD(jg.interval_grid(0, 1, 8), bi, jprob, order=order, only_these_products=PRODUCTS)
    _same_discretization(d, jd)


def test_interval_cg_matches_reference():
    """CG P1 on intervals (the reference's SGrid<1,1> CG example)."""
    _, tprob = _sine(tf, TProblem, torch)
    _, jprob = _sine(jf, JProblem, jnp)
    d = TCG(tg.interval_grid(0, 1, 8), DIRICHLET, tprob, device="cpu")
    jd = JCG(jg.interval_grid(0, 1, 8), DIRICHLET, jprob)
    _same_discretization(d, jd, ("l2", "h1_semi", "energy"))
    _close(d.solve_with_dirichlet_shift(options={"type": "direct"}),
           jd.solve_with_dirichlet_shift(options={"type": "direct"}), rel=1e-10)


@pytest.mark.parametrize("order,rates", [(1, (2.0, 1.0)), (2, (3.0, 2.0))])
def test_interval_swipdg_eoc(order, rates):
    """The reference test's bars (tests/test_interval_swipdg.py), 8-32 cells."""
    exact, problem = _sine(tf, TProblem, torch)
    errs = []
    for n in (8, 16, 32):
        d = TD(tg.interval_grid(0, 1, n), DIRICHLET, problem, order=order,
               only_these_products=(), device="cpu")
        errs.append(error_norms(d.space, d.solve(options={"type": "direct"}), exact))
    for norm, rate in zip(("L2", "H1_semi"), rates):
        e = [x[norm] for x in errs]
        assert np.mean([np.log2(e[i] / e[i + 1]) for i in range(2)]) > rate - 0.2, (norm, e)


def test_interval_order3_exact_for_cubic():
    d = TD(tg.interval_grid(0, 1, 4), DIRICHLET, _cubic(tf, TProblem), order=3, device="cpu")
    u = d.solve(options={"type": "direct"})
    e = error_norms(d.space, u, tf.LambdaFunction(lambda x: x[..., 0] ** 3, order=3))
    assert e["L2"] < 1e-9 and e["H1_semi"] < 1e-8, e
    jd = JD(jg.interval_grid(0, 1, 4), DIRICHLET, _cubic(jf, JProblem), order=3)
    _close(u, jd.solve(None, options={"type": "direct"}), rel=1e-10)


_QUAD = {}
QUAD_PRODUCTS = ("l2", "h1_semi", "elliptic", "boundary_l2", "penalty")


def _quad_case(order, level, kind):
    """(port, reference) SWIPDG or CG discretization of ESV2007 on the
    level-``level`` cube grid."""
    key = (order, level, kind)
    if key not in _QUAD:
        ttc, jtc = TTC(num_refinements=1, grid_variant="cube"), JTC(num_refinements=1,
                                                                    grid_variant="cube")
        if kind == "swipdg":
            T, J, kw = TD, JD, {"only_these_products": QUAD_PRODUCTS}
        else:
            T, J, kw = TCG, JCG, {}
        _QUAD[key] = (T(ttc.level_grid(level), NORMAL, TP(), order=order, device="cpu", **kw),
                      J(jtc.level_grid(level), NORMAL, JP(), order=order, **kw))
    return _QUAD[key]


@pytest.mark.parametrize("order,level", [(1, 0), (2, 0)])
def test_quad_swipdg_matches_reference(order, level):
    d, jd = _quad_case(order, level, "swipdg")
    assert d.space.grid.cell_type == "quad" and d.space.grid.num_cells == 64 * 4 ** level
    _same_discretization(d, jd, QUAD_PRODUCTS)


@pytest.mark.parametrize("order", [1, 2])
def test_quad_cg_matches_reference(order):
    d, jd = _quad_case(order, 0, "cg")
    _same_discretization(d, jd, ("l2", "h1_semi", "energy"))
    _close(d.solve_with_dirichlet_shift(options={"type": "direct"}),
           jd.solve_with_dirichlet_shift(options={"type": "direct"}), rel=1e-10)


def test_quad_stencil_cg_runs_block_cg():
    """A quad grid has no structured order: stencil_cg is the reference's
    block_cg.jacobi there."""
    d, jd = _quad_case(1, 0, "swipdg")
    u = d.solve(options={"type": "stencil_cg", "precision": 1e-12})
    assert d.last_solve_info["type"] == "block_cg.jacobi"
    _close(u, jd.solve(None, options={"type": "direct"}), rel=1e-9)


def test_cube_hierarchy_matches_reference():
    ttc, jtc = TTC(num_refinements=2, grid_variant="cube"), JTC(num_refinements=2,
                                                                grid_variant="cube")
    assert len(ttc.hierarchy) == len(jtc.hierarchy) == 4
    for level in range(4):
        _same_grid(ttc.hierarchy[level], jtc.hierarchy[level])
    assert ttc.level_grid(0).num_cells == 64
    np.testing.assert_array_equal(ttc.hierarchy.parent_cells(0, 3),
                                  jtc.hierarchy.parent_cells(0, 3))


def test_block_swipdg_os2014_on_quads():
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB
    from dune_hdd_tpu.estimators.block_swipdg import BlockSWIPDGEstimators as JBE
    from dune_hdd_tpu_torch.discretizations.block_swipdg import BlockSWIPDGDiscretization as TB
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators as TBE

    ttc, jtc = TTC(num_refinements=1, grid_variant="cube"), JTC(num_refinements=1,
                                                                grid_variant="cube")
    d = TB(ttc.level_grid(1), ttc.boundary_info(), ttc.problem, num_partitions=(2, 2),
           device="cpu")
    jd = JB(jtc.level_grid(1), jtc.boundary_info(), jtc.problem, num_partitions=(2, 2))
    u_ref = np.asarray(jd.solve(options={"type": "direct"}))
    _close(d.solve(options={"type": "direct"}), u_ref, rel=1e-10)
    pars = {"mu": None, "mu_bar": None, "mu_hat": None}
    u = torch.as_tensor(u_ref.copy())
    eta = TBE.estimate(d, u, "eta_OS2014", pars)
    assert eta == pytest.approx(JBE.estimate(jd, jnp.asarray(u_ref), "eta_OS2014", pars),
                                rel=1e-8)
    _close(TBE.estimate_local(d, u, "eta_OS2014", pars),
           JBE.estimate_local(jd, jnp.asarray(u_ref), "eta_OS2014", pars), rel=1e-8)
