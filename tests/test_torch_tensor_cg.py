"""The tensor-product Q1 CG path of the PyTorch port (``grid/tensor.py``,
``ops/tensor_space.py``, ``discretizations/tensor_cg.py``,
``testcases/tensor.py``) against the JAX package's (x64, CPU), for the cases
of the reference's ``tests/test_tensor_cg.py``:

* the grid arrays (vertices, corner order, boundary facets, masks) exactly,
  and the boundary classification of every boundary-info type;
* the Q1 basis, the Gauss rules and every element kernel (elliptic, l2,
  force, the Neumann functional) to 1e-13 relative;
* the assembled operator, rhs, products and Dirichlet vector per affine
  component, the reference's side converted with ``convert.affine_from_numpy``
  (its pattern's slots equal, the values to 1e-13 relative), for the
  thermalblock in d = 1, 2, 3, the parametric bump, the parametric Dirichlet
  cross-products and the 3D Neumann case;
* the solves in d = 1, 2, 3 at 4-8 cells per axis to 1e-10, the error norms
  to 1e-10, and the reference test's own gates (EOC, exact Q1 solutions, the
  façade in every dimension).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import affine as ja  # noqa: E402
from dune_hdd_tpu import parameters as jpar  # noqa: E402
from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu.discretizations.tensor_cg import TensorCGDiscretization as JTCG  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.grid import tensor as jg  # noqa: E402
from dune_hdd_tpu.ops import tensor_space as js  # noqa: E402
from dune_hdd_tpu.testcases.tensor import TensorSineTestcase as JSine  # noqa: E402
from dune_hdd_tpu_torch import affine as ta  # noqa: E402
from dune_hdd_tpu_torch import parameters as tpar  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from dune_hdd_tpu_torch.convert import affine_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.discretizations.tensor_cg import TensorCGDiscretization as TTCG  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.grid import tensor as tg  # noqa: E402
from dune_hdd_tpu_torch.ops import tensor_space as ts  # noqa: E402
from dune_hdd_tpu_torch.studies import EocStudy, eoc_rates  # noqa: E402
from dune_hdd_tpu_torch.testcases.tensor import TensorSineTestcase as TSine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CG_OPTS = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000}
RTOL = 1e-13
SOLVE_RTOL = 1e-10


def _close(a, b, rel=RTOL, atol=None):
    a = np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    bound = atol if atol is not None else rel * max(np.abs(b).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=bound)


SHAPES = {1: (5,), 2: (3, 4), 3: (2, 3, 4)}


def _grids(d, shape=None, lo=None, hi=None):
    shape = shape or SHAPES[d]
    lo = lo if lo is not None else [0.0] * d
    hi = hi if hi is not None else [1.0 + 0.5 * a for a in range(d)]
    return tg.tensor_grid(lo, hi, shape), jg.tensor_grid(lo, hi, shape)


# -- grids and boundary infos ---------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3])
def test_grid_arrays(d):
    t, j = _grids(d)
    assert (t.dim, t.num_cells, t.num_vertices, t.vertex_shape) == (
        j.dim, j.num_cells, j.num_vertices, j.vertex_shape)
    np.testing.assert_array_equal(t.h, j.h)
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.cells, j.cells)
    np.testing.assert_array_equal(t.cell_vertices, j.cell_vertices)
    np.testing.assert_array_equal(t.boundary_vertices, j.boundary_vertices)
    tf_, jf_ = t.boundary_facets, j.boundary_facets
    for name in ("corners", "axis", "side", "measure"):
        np.testing.assert_array_equal(getattr(tf_, name), getattr(jf_, name))
    np.testing.assert_array_equal(tf_.normals(d), jf_.normals(d))
    np.testing.assert_array_equal(t.refine().cells, j.refine().cells)
    th, jh = tg.TensorGridHierarchy(t, 2), jg.TensorGridHierarchy(j, 2)
    assert len(th) == len(jh) == 3
    assert th.reference.shape == jh.reference.shape == tuple(4 * n for n in t.shape)


BOUNDARIES = {
    "alldirichlet": {"type": "stuff.grid.boundaryinfo.alldirichlet"},
    "allneumann": {"type": "stuff.grid.boundaryinfo.allneumann"},
    "normal_dirichlet_default": {"type": "stuff.grid.boundaryinfo.normalbased",
                                 "default": "dirichlet", "neumann": [[1.0, 0.0, 0.0]]},
    "normal_neumann_default": {"type": "stuff.grid.boundaryinfo.normalbased",
                               "default": "neumann", "dirichlet": [[-1.0, 0.0, 0.0],
                                                                   [0.0, 1.0, 0.0]]},
}


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", list(BOUNDARIES))
def test_boundary_classification(d, kind):
    cfg = dict(BOUNDARIES[kind])
    for key in ("neumann", "dirichlet"):
        if key in cfg:
            cfg[key] = [v[:d] for v in cfg[key]]
    t, j = _grids(d)
    tb_, jb_ = tg.make_tensor_boundary_info(t, cfg), jg.make_tensor_boundary_info(j, cfg)
    np.testing.assert_array_equal(tb_.dirichlet_facets, jb_.dirichlet_facets)
    np.testing.assert_array_equal(tb_.neumann_facets, jb_.neumann_facets)
    np.testing.assert_array_equal(tb_.dirichlet_vertices, jb_.dirichlet_vertices)
    assert (tb_.has_dirichlet, tb_.has_neumann) == (jb_.has_dirichlet, jb_.has_neumann)
    assert tg.make_tensor_boundary_info(t, tb_) is tb_
    with pytest.raises(ValueError):
        tg.make_tensor_boundary_info(t, {"type": "stuff.grid.boundaryinfo.idbased"})


def test_boundary_info_classification_2d():
    """The reference test's case: Neumann left/right, Dirichlet top/bottom
    with the corners."""
    grid = tg.tensor_grid([0.0, 0.0], [1.0, 1.0], [4, 4])
    f = grid.boundary_facets
    assert f.num == 16
    bi = tg.make_tensor_boundary_info(grid, {
        "type": "stuff.grid.boundaryinfo.normalbased", "default": "dirichlet",
        "neumann": [[1.0, 0.0], [-1.0, 0.0]]})
    assert (bi.neumann_facets == (np.abs(f.normals(2)[:, 0]) > 0.5)).all()
    assert not (bi.dirichlet_facets & bi.neumann_facets).any()
    vy = grid.vertices[:, 1]
    np.testing.assert_array_equal(bi.dirichlet_vertices, (vy == 0.0) | (vy == 1.0))


# -- basis, rules and element kernels ---------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 3])
def test_q1_basis_and_rules(d):
    rel = np.random.default_rng(d).uniform(0, 1, (6, 5, d))
    _close(ts.q1_values(torch.tensor(rel), d), js.q1_values(jnp.asarray(rel), d))
    _close(ts.q1_gradients(torch.tensor(rel), d), js.q1_gradients(jnp.asarray(rel), d))
    for order in (0, 2, 5, 8):
        tp_, tw_ = ts._gauss_tensor(d, order)
        jp_, jw_ = js._gauss_tensor(d, order)
        np.testing.assert_array_equal(tp_, jp_)
        np.testing.assert_array_equal(tw_, jw_)
    t, j = _grids(d)
    qp, qw = ts.tensor_cell_quadrature(t, 4, "cpu")
    jqp, jqw = js.tensor_cell_quadrature(j, 4)
    _close(qp, jqp)
    _close(qw, jqw)


def _kernel_functions(d, pkg_f):
    cb = pkg_f.make_checkerboard_decomposition([0.0] * d, [1.0 + 0.5 * a for a in range(d)],
                                               (2,) * d)
    kap = pkg_f.ConstantFunction(np.diag(np.arange(1.0, d + 1)) + 0.1, "diffusion_tensor")
    return cb.components[-1], kap


@pytest.mark.parametrize("d", [1, 2, 3])
def test_element_kernels(d):
    t, j = _grids(d)
    tspace, jspace = ts.tensor_q1_space(t, device="cpu"), js.tensor_q1_space(j)
    (tlam, tkap), (jlam, jkap) = _kernel_functions(d, tf), _kernel_functions(d, jf)
    _close(ts.tensor_elliptic_cell_matrices(tspace, tlam, tkap),
           js.tensor_elliptic_cell_matrices(jspace, jlam, jkap))
    _close(ts.tensor_l2_cell_matrices(tspace), js.tensor_l2_cell_matrices(jspace))
    _close(ts.tensor_l2_cell_matrices(tspace, tlam), js.tensor_l2_cell_matrices(jspace, jlam))
    tforce = tf.ExpressionFunction("1+x[0]*x[0]", 2) if d == 1 else tf.ExpressionFunction(
        "sin(x[0])*cos(x[1])+x[1]", 3)
    jforce = jf.ExpressionFunction("1+x[0]*x[0]", 2) if d == 1 else jf.ExpressionFunction(
        "sin(x[0])*cos(x[1])+x[1]", 3)
    _close(ts.tensor_force_cell_vectors(tspace, tforce),
           js.tensor_force_cell_vectors(jspace, jforce))
    cfg = {"type": "stuff.grid.boundaryinfo.normalbased", "default": "neumann",
           "dirichlet": [[-1.0] + [0.0] * (d - 1)]}
    _close(ts.tensor_neumann_functional(tspace, tforce, tg.make_tensor_boundary_info(t, cfg)),
           js.tensor_neumann_functional(jspace, jforce, jg.make_tensor_boundary_info(j, cfg)))


def test_chunked_kernels_equal_one_chunk(monkeypatch):
    """The cell kernels over many chunks equal one chunk (1e-13)."""
    t, _ = _grids(3, shape=(4, 3, 5))
    space = ts.tensor_q1_space(t, device="cpu")
    lam, kap = _kernel_functions(3, tf)
    force = tf.ExpressionFunction("sin(x[0])*cos(x[1])+x[1]", 3)
    whole = (ts.tensor_elliptic_cell_matrices(space, lam, kap),
             ts.tensor_force_cell_vectors(space, force), ts.tensor_l2_cell_matrices(space, lam))
    monkeypatch.setattr(ts, "CHUNK_POINTS", 37)
    chunked = (ts.tensor_elliptic_cell_matrices(space, lam, kap),
               ts.tensor_force_cell_vectors(space, force), ts.tensor_l2_cell_matrices(space, lam))
    for a, b in zip(chunked, whole):
        _close(a, b)


# -- discretizations ---------------------------------------------------------------


def _parametric_problem(d, pkg_f, pkg_p, pkg_a, pkg_par):
    """1 + mu * 1_box diffusion factor (the reference test's bump)."""
    box = ([0.25] * d, [0.75] * d, 1.0)
    return pkg_p.Problem(
        pkg_a.AffineDecomposition(
            [pkg_f.IndicatorFunction([box], name="bump")],
            [pkg_par.ParameterFunctional(("mu", 1), "mu")],
            pkg_f.ConstantFunction(1.0, "diffusion_factor"),
        ),
        pkg_f.nonparametric(pkg_f.constant_matrix(1.0, dim=d)),
        pkg_f.nonparametric(pkg_f.ConstantFunction(1.0, "force")),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "dirichlet")),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "neumann")),
    )


def _dirichlet_cross_problem(pkg_f, pkg_p, pkg_a, pkg_par, lam_x):
    return pkg_p.Problem(
        pkg_a.AffineDecomposition([pkg_f.ConstantFunction(1.0, "one")],
                                  [pkg_par.ParameterFunctional(("mu", 1), "mu")]),
        pkg_f.nonparametric(pkg_f.constant_matrix(1.0, dim=1)),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "force")),
        pkg_a.AffineDecomposition([pkg_f.LambdaFunction(lam_x, order=1, name="g")],
                                  [pkg_par.ParameterFunctional(("nu", 1), "nu")]),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "neumann")),
    )


def _neumann_problem(pkg_f, pkg_p, where):
    return pkg_p.Problem(
        pkg_f.nonparametric(pkg_f.ConstantFunction(1.0, "diffusion_factor")),
        pkg_f.nonparametric(pkg_f.constant_matrix(1.0, dim=3)),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "force")),
        pkg_f.nonparametric(pkg_f.ConstantFunction(0.0, "dirichlet")),
        pkg_f.nonparametric(pkg_f.LambdaFunction(
            lambda x: where(x[..., 0] > 1.0 - 1e-9, 0.75, 0.0), order=0, name="neumann")),
    )


NEUMANN_3D = {"type": "stuff.grid.boundaryinfo.normalbased", "default": "neumann",
              "dirichlet": [[-1.0, 0.0, 0.0]]}
CASES = {  # name -> (dim, cells per axis, boundary, mu)
    "thermalblock_1d": (1, 8, None, {"diffusion_factor": [0.3, 2.0]}),
    "thermalblock_2d": (2, 6, None, {"diffusion_factor": [0.1, 1.0, 0.5, 2.0]}),
    "thermalblock_3d": (3, 4, None, {"diffusion_factor": [0.1, 1.0, 0.5, 2.0, 1.0, 0.3, 4.0,
                                                          1.0]}),
    "bump_1d": (1, 8, None, {"mu": [0.7]}),
    "bump_3d": (3, 4, None, {"mu": [0.7]}),
    "dirichlet_cross_1d": (1, 8, None, {"mu": [0.3], "nu": [2.0]}),
    "neumann_3d": (3, 4, NEUMANN_3D, None),
}
_BUILT = {}


def _case(name):
    """(port discretization, reference discretization, mu), built once."""
    if name not in _BUILT:
        d, n, boundary, mu = CASES[name]
        kind = name.rsplit("_", 1)[0]
        if kind == "thermalblock":
            probs = tp.ThermalblockProblem((2,) * d), jp.ThermalblockProblem((2,) * d)
        elif kind == "bump":
            probs = (_parametric_problem(d, tf, tp, ta, tpar),
                     _parametric_problem(d, jf, jp, ja, jpar))
        elif kind == "dirichlet_cross":
            probs = (_dirichlet_cross_problem(tf, tp, ta, tpar, lambda x: x[..., 0]),
                     _dirichlet_cross_problem(jf, jp, ja, jpar, lambda x: x[..., 0]))
        else:
            probs = _neumann_problem(tf, tp, torch.where), _neumann_problem(jf, jp, jnp.where)
        lo, hi = [0.0] * d, [1.0] * d
        _BUILT[name] = (TTCG(tg.tensor_grid(lo, hi, [n] * d), boundary, probs[0], device="cpu"),
                        JTCG(jg.tensor_grid(lo, hi, [n] * d), boundary, probs[1]), mu)
    return _BUILT[name]


def _converted(dec, pattern=None):
    """The reference's decomposition as the port's, through ``convert``."""
    payloads = dec.components + ([dec.affine_part] if dec.affine_part is not None else [])
    is_matrix = hasattr(payloads[0], "pattern")

    def arr(p):
        return np.asarray(p.values if is_matrix else p)

    return affine_from_numpy([arr(c) for c in dec.components], dec.coefficients,
                             None if dec.affine_part is None else arr(dec.affine_part), "cpu",
                             pattern_fields=payloads[0].pattern if is_matrix else None)


def _same_decomposition(t, j):
    c = _converted(j)
    assert t.num_components == c.num_components
    assert ([q.expression for q in t.coefficients] == [q.expression for q in c.coefficients])
    assert (t.affine_part is None) == (c.affine_part is None)
    for a, b in zip(t.components + [t.affine_part], c.components + [c.affine_part]):
        if a is None:
            continue
        if hasattr(a, "pattern"):
            np.testing.assert_array_equal(a.pattern.slot_rows, b.pattern.slot_rows)
            np.testing.assert_array_equal(a.pattern.slot_cols, b.pattern.slot_cols)
            assert a.pattern.ell_width == b.pattern.ell_width
            _close(a.values, b.values.numpy())
        else:
            _close(a, b.numpy())


def _mu(mu):
    return None if mu is None else {k: np.asarray(v, dtype=float) for k, v in mu.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_operator_rhs_products_vectors(name):
    t, j, _ = _case(name)
    assert t.space.num_dofs == j.space.num_dofs
    assert repr(t.parameter_type) == repr(j.parameter_type)
    _same_decomposition(t.get_operator(), j.get_operator())
    _same_decomposition(t.get_rhs(), j.get_rhs())
    assert t.available_products() == j.available_products()
    for p in t.available_products():
        _same_decomposition(t.get_product(p), j.get_product(p))
    _same_decomposition(t.get_vector("dirichlet"), j.get_vector("dirichlet"))
    assert t.purely_neumann == j.purely_neumann


@pytest.mark.parametrize("name", list(CASES))
def test_solve(name):
    t, j, mu = _case(name)
    u_t = t.solve(_mu(mu), CG_OPTS)
    u_j = np.asarray(j.solve(_mu(mu), CG_OPTS))
    _close(u_t, u_j, rel=SOLVE_RTOL)
    _close(t.solve_with_dirichlet_shift(_mu(mu), CG_OPTS),
           np.asarray(j.solve_with_dirichlet_shift(_mu(mu), CG_OPTS)), rel=SOLVE_RTOL)
    assert t.last_solve_info["type"] == "cg.jacobi"
    A, b = t.freeze_operator(_mu(mu)), t.freeze_rhs(_mu(mu))
    assert float(torch.linalg.norm(A.matvec(u_t) - b) / torch.linalg.norm(b)) < 1e-10


@pytest.mark.parametrize("d", [1, 2, 3])
def test_sine_testcase_error_norms(d):
    """TensorSineTestcase: the same problem, grid and exact solution; the
    error norms of the port's solution equal the reference's (1e-10)."""
    tc, jc = TSine(d, initial_cells=4, num_refinements=1), JSine(d, initial_cells=4,
                                                                num_refinements=1)
    grid, jgrid = tc.level_grid(0), jc.level_grid(0)
    np.testing.assert_array_equal(tc.level_grid(1).vertices, jc.level_grid(1).vertices)
    np.testing.assert_array_equal(grid.vertices, jgrid.vertices)
    x = np.random.default_rng(d).uniform(0, 1, (7, d))
    _close(tc.exact_solution(torch.tensor(x)), jc.exact_solution(jnp.asarray(x)))
    _close(tc.exact_solution.gradient(torch.tensor(x)),
           jc.exact_solution.gradient(jnp.asarray(x)))
    t = TTCG(grid, tc.boundary_info(), tc.problem, device="cpu")
    j = JTCG(jgrid, jc.boundary_info(), jc.problem)
    u_t, u_j = t.solve(None, CG_OPTS), j.solve(None, CG_OPTS)
    _close(u_t, np.asarray(u_j), rel=SOLVE_RTOL)
    e_t = t.error_norms(u_t, tc.exact_solution)
    e_j = j.error_norms(u_j, jc.exact_solution)
    for key in ("L2", "H1_semi"):
        assert math.isclose(e_t[key], e_j[key], rel_tol=1e-10), (key, e_t, e_j)


# -- the reference test's own gates on the port -------------------------------------


def _sine(d, lib):
    def exact(x):
        return lib.prod(lib.sin(math.pi * x), -1)

    def exact_grad(x):
        out = []
        for a in range(d):
            g = math.pi * lib.cos(math.pi * x[..., a])
            for b in range(d):
                if b != a:
                    g = g * lib.sin(math.pi * x[..., b])
            out.append(g)
        return lib.stack(out, -1)

    return exact, exact_grad, (lambda x: d * math.pi ** 2 * exact(x))


@pytest.mark.parametrize("d,n0,levels", [(1, 8, 3), (2, 4, 3), (3, 4, 2)])
def test_tensor_cg_eoc(d, n0, levels):
    exact, exact_grad, force = _sine(d, torch)
    grid = tg.tensor_grid([0.0] * d, [1.0] * d, [n0] * d)
    l2, h1 = [], []
    for _ in range(levels):
        disc = TTCG(grid, force=force, device="cpu")
        u = disc.solve(options=CG_OPTS)
        e = disc.error_norms(u, exact, exact_grad)
        l2.append(e["L2"])
        h1.append(e["H1_semi"])
        grid = grid.refine()
    assert all(r > 1.85 for r in eoc_rates(l2)), l2
    assert all(r > 0.9 for r in eoc_rates(h1)), h1


@pytest.mark.parametrize("d", [1, 3])
def test_tensor_cg_eoc_study(d):
    tc = TSine(d, initial_cells=8 if d == 1 else 4, num_refinements=2 if d == 1 else 1)
    study = EocStudy(tc, TTCG, norms=("L2", "H1_semi"), solver_options=CG_OPTS, device="cpu")
    results = study.run(verbose=False)
    assert all(r > 1.8 for r in eoc_rates(results["L2"])), results["L2"]
    assert all(r > 0.85 for r in eoc_rates(results["H1_semi"])), results["H1_semi"]
    assert [i["type"] for i in study.level_info] == ["cg.jacobi"] * len(study.level_info)


@pytest.mark.parametrize("d", [1, 3])
def test_tensor_cg_affine_surface(d):
    grid = tg.tensor_grid([0.0] * d, [1.0] * d, [8] * d)
    disc = TTCG(grid, None, _parametric_problem(d, tf, tp, ta, tpar), device="cpu")
    op = disc.get_operator()
    assert op.num_components == 1 and op.affine_part is not None
    assert disc.parametric()
    assert set(disc.available_products()) == {"l2", "h1_semi", "energy"}
    x = torch.tensor(np.random.default_rng(0).standard_normal(disc.space.num_dofs))
    _close(disc.freeze_operator({"mu": [0.7]}).matvec(x),
           op.affine_part.matvec(x) + 0.7 * op.components[0].matvec(x), rel=1e-14)
    for mv in (0.1, 1.0):
        mu = {"mu": [mv]}
        u = disc.solve(mu, options=CG_OPTS)
        A, b = disc.freeze_operator(mu), disc.freeze_rhs(mu)
        assert float(torch.linalg.norm(A.matvec(u) - b) / torch.linalg.norm(b)) < 1e-8
    assert disc.get_product("energy").num_components == op.num_components
    assert "direct" in disc.solver_types()


def test_dirichlet_shift_exact_1d():
    grid = tg.tensor_grid([0.0], [1.0], [16])
    problem = tp.Problem(
        tf.nonparametric(tf.ConstantFunction(1.0, "diffusion_factor")),
        tf.nonparametric(tf.constant_matrix(1.0, dim=1)),
        tf.nonparametric(tf.ConstantFunction(0.0, "force")),
        tf.nonparametric(tf.LambdaFunction(lambda x: x[..., 0], order=1, name="dirichlet")),
        tf.nonparametric(tf.ConstantFunction(0.0, "neumann")))
    disc = TTCG(grid, None, problem, device="cpu")
    _close(disc.solve_with_dirichlet_shift(options=CG_OPTS), grid.vertices[:, 0], atol=1e-8)


def test_parametric_dirichlet_cross_products_exact():
    """u = nu x for any (mu, nu): the shift's ProductFunctional components."""
    disc, _, _ = _case("dirichlet_cross_1d")
    assert any(q.expression.count("*") for q in disc.get_rhs().coefficients)
    for mu, nu in [(1.0, 1.0), (0.3, 2.0)]:
        u = disc.solve_with_dirichlet_shift({"mu": [mu], "nu": [nu]}, options=CG_OPTS)
        _close(u, nu * disc.space.grid.vertices[:, 0], atol=1e-7)


def test_neumann_exact_3d():
    disc, _, _ = _case("neumann_3d")
    u = disc.solve(options=CG_OPTS)
    _close(u, 0.75 * disc.space.grid.vertices[:, 0], atol=1e-7)


def test_facade_dimensions():
    from dune_hdd_tpu_torch.cli.examples import LinearellipticExampleTensorCG

    for d in (1, 2, 3):
        disc = LinearellipticExampleTensorCG(device="cpu").initialize_tensor(
            dim=d, num_elements=4).discretization()
        u = disc.solve(options=CG_OPTS)
        assert u.shape == (disc.space.num_dofs,) and bool(torch.isfinite(u).all())


def test_space_shared_per_grid_and_visualize_raises_like_reference(tmp_path):
    """Discretizations on one grid share its Q1 space (and so the pattern);
    ``visualize`` of a tensor solution raises the reference's error (its
    writer has no hexahedra)."""
    t, j, _ = _case("thermalblock_3d")
    other = TTCG(t.space.grid, None, only_these_products=(), device="cpu")
    assert other.space is t.space and other.pattern() is t.pattern()
    u = t.solve({"diffusion_factor": np.ones(8)}, CG_OPTS)
    with pytest.raises(AttributeError) as port_err:
        t.visualize(u, str(tmp_path / "u"))
    with pytest.raises(AttributeError) as ref_err:
        j.visualize(j.solve({"diffusion_factor": np.ones(8)}, CG_OPTS), str(tmp_path / "j"))
    assert str(port_err.value) == str(ref_err.value)
