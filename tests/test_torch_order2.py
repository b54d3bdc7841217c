"""Orders 2-3 of the PyTorch port against the JAX package's (x64, CPU), on
the ESV2007 ALU-conforming grids of levels 0-1 (2 and 4 bisections of the
4x4 cube):

* P2 / P3 / Q2 space structure (DoF counts, DoF maps, nodal points, shape
  values and gradients): exact, or 1e-14 x max where a value is computed;
* SWIPDG P2 (levels 0-1) / P3 (level 0) operators and rhs: 1e-12 x max;
  direct solutions: 1e-10 (each reference build costs 13-19 s of op-by-op
  compiles, so P3 stops at level 0);
* the stencil planes at nd = 6 (level 1) and 10 (level 0) against the reference's
  ``StencilBlockEll.from_block_ell`` and the plain plane SpMV against its
  ``StencilBlockEll.matvec``: 1e-13 x max;
* the nd = 6 block-Jacobi smoother: 1e-13 x max;
* stencil_cg (plain Jacobi and the 4x4 deflation) at level 0 against the
  reference's stencil_cg solution: 1e-10 x max (both to a relative 1e-12).

The kernels at nd = 6 and 10 are held to their plain versions on the card by
the ``cuda`` tests of test_torch_plane_spmv.py and test_torch_structured_spmv.py,
which need no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.grid import structured as jg  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order as j_order  # noqa: E402
from dune_hdd_tpu.la import stencil as js  # noqa: E402
from dune_hdd_tpu.la.block_ell import block_ell_from_sparse as j_block_ell  # noqa: E402
from dune_hdd_tpu.la.block_ell import symmetric_diagonal_scaling as j_scaling  # noqa: E402
from dune_hdd_tpu.ops.spaces import Space as JSpace  # noqa: E402
from dune_hdd_tpu.problems import ESV2007Problem as JP  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.grid import structured as tg  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as ts  # noqa: E402
from dune_hdd_tpu_torch.ops.spaces import Space as TSpace  # noqa: E402
from dune_hdd_tpu_torch.problems import ESV2007Problem as TP  # noqa: E402

DIRICHLET = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
LOWER, UPPER = (-1.0, -1.0), (1.0, 1.0)


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


_BUILT = {}


def _disc(order, level):
    """(port SWIPDG, reference SWIPDG) on ESV2007 ALU level ``level``."""
    key = (order, level)
    if key not in _BUILT:
        n = 2 + 2 * level
        _BUILT[key] = (TD(tg.alu_cube_grid(LOWER, UPPER, (4, 4), n), DIRICHLET, TP(),
                          order=order, only_these_products=(), device="cpu"),
                       JD(jg.alu_cube_grid(LOWER, UPPER, (4, 4), n), DIRICHLET, JP(), order=order,
                          only_these_products=()))
    return _BUILT[key]


@pytest.mark.parametrize("order,cell_type,continuous", [
    (2, "triangle", False), (2, "triangle", True), (3, "triangle", False),
    (3, "triangle", True), (2, "quad", False), (2, "quad", True)])
def test_space_structure(order, cell_type, continuous):
    t = TSpace(tg.rectangle_grid(LOWER, UPPER, (3, 2), cell_type), continuous, order,
               device="cpu")
    j = JSpace(jg.rectangle_grid(LOWER, UPPER, (3, 2), cell_type), continuous, order)
    assert (t.num_dofs, t.shape_count) == (j.num_dofs, j.shape_count)
    np.testing.assert_array_equal(t.cell_dofs, j.cell_dofs)
    np.testing.assert_array_equal(t.nodal_points, j.nodal_points)
    verts = t.grid.cell_vertices
    pts = verts.mean(axis=1, keepdims=True) * 0.7 + 0.3 * verts  # inside each cell
    tv = torch.as_tensor(verts)
    _close(t.shape_values(tv, torch.as_tensor(pts)),
           j.shape_values(jnp.asarray(verts), jnp.asarray(pts)), rel=1e-14)
    _close(t.shape_gradients(tv, torch.as_tensor(pts)),
           j.shape_gradients(jnp.asarray(verts), jnp.asarray(pts)), rel=1e-14)


def test_space_rules_match_reference():
    quad = tg.rectangle_grid(LOWER, UPPER, (2, 2), "quad")
    with pytest.raises(NotImplementedError):
        TSpace(quad, False, 3, device="cpu")  # order 3 is triangle/interval-only
    with pytest.raises(NotImplementedError):
        TSpace(quad, False, 4, device="cpu")
    with pytest.raises(ValueError):
        TSpace(quad, False, 2, basis="p1", device="cpu")


@pytest.mark.parametrize("order,level", [(2, 0), (2, 1), (3, 0)])
def test_swipdg_operator_rhs_and_direct_solution(order, level):
    d, jd = _disc(order, level)
    assert d.space.num_dofs == jd.space.num_dofs
    _close(d.freeze_operator({}).values, jd.freeze_operator(None).values)
    _close(d.freeze_rhs({}), jd.freeze_rhs(None))
    _close(d.solve(options={"type": "direct"}), jd.solve(None, options={"type": "direct"}),
           rel=1e-10)


def _stencil_pair(order, level):
    """(port StencilBlockEll, reference StencilBlockEll, port system) of the
    scaled SWIPDG operator."""
    d, jd = _disc(order, level)
    system = d.stencil_system()
    A = j_block_ell(jd.space, jd.freeze_operator(None))
    A_s, _, _ = j_scaling(A, jd.freeze_rhs(None))
    return system.S, js.StencilBlockEll.from_block_ell(A_s, j_order(jd.space.grid)), system


@pytest.mark.parametrize("order,nd", [(2, 6), (3, 10)])
def test_stencil_planes_and_plain_spmv(order, nd):
    S, S_j, _ = _stencil_pair(order, 3 - order)
    assert S.nd == S_j.nd == nd
    assert S.plan == S_j.plan
    _close(S.planes, S_j.planes, rel=1e-13)
    X = np.random.default_rng(order).standard_normal(tuple(S.planes.shape[1:2])
                                                      + tuple(S.planes.shape[3:]))
    _close(plane_spmv_reference(S.planes, torch.as_tensor(X), S.plan),
           S_j.matvec(jnp.asarray(X)), rel=1e-13)
    before = plane_spmv.launches
    _close(plane_spmv(S.planes, torch.as_tensor(X), S.plan), S_j.matvec(jnp.asarray(X)),
           rel=1e-13)
    assert plane_spmv.launches == before  # CPU tensors take the plain version


def test_jacobi_smoother_nd6():
    S, S_j, _ = _stencil_pair(2, 1)
    R = np.random.default_rng(11).standard_normal((6,) + tuple(S.planes.shape[3:]))
    _close(ts.jacobi_smoother(S)(torch.as_tensor(R)), js.jacobi_smoother(S_j)(jnp.asarray(R)),
           rel=1e-13)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("macro", [None, (4, 4)])
def test_stencil_cg_matches_reference(order, macro):
    d, jd = _disc(order, 0)
    opts = {"type": "stencil_cg", "precision": 1e-12, "max_iter": 5000}
    if macro is not None:
        opts["macro"] = macro
    u = d.solve(options=opts)
    assert d.last_solve_info["type"] == "stencil_cg"
    _close(u, jd.solve(None, options=opts), rel=1e-10)
