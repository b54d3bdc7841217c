"""The CG discretization of the PyTorch port against the JAX package's (x64,
CPU), P1 on triangles:

* operator, rhs, the three products and the Dirichlet vector, component by
  component, and the solution with the Dirichlet shift: 1e-12 x max, on
  ESV2007 (``rectangle_grid`` with 1-2 red refinements, ``alu_cube_grid``
  with 2 and 4 bisections), the 2x2 thermalblock (parametric: coefficient
  products of the shift) and mixed Dirichlet/Neumann boundaries with a
  nonzero Dirichlet value;
* orders 2-3 (P2/P3 on triangles, Q2 on quads): operator, rhs and the
  solution with the Dirichlet shift against the reference's;
* the reference's own CG tests that need only ported modules (its quad
  cases run here on triangles): EOC
  above 1.85 (L2) and 0.95 (H1_semi) over 3 levels, solver types, products,
  the Dirichlet shift, id- against normal-based boundaries, affine
  consistency and the solution cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu.discretizations import CGDiscretization as JCG  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.grid import structured as jg  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from dune_hdd_tpu_torch.discretizations import CGDiscretization as TCG  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.functions import esv2007 as tesv  # noqa: E402
from dune_hdd_tpu_torch.grid import structured as tg  # noqa: E402
from dune_hdd_tpu_torch.ops.norms import error_norms, induced_norm  # noqa: E402

ALL_DIRICHLET = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MIXED = {"type": "stuff.grid.boundaryinfo.normalbased", "default": "dirichlet",
         "neumann": [[-1.0, 0.0], [1.0, 0.0]]}
MU = np.array([0.1, 1.0, 0.5, 0.3])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mixed_boundaries(fn, pkg):
    """The reference's MixedBoundariesProblem: unit diffusion, force 1,
    Dirichlet 0.25 x y, Neumann 0.1."""
    return pkg.DefaultProblem(
        diffusion_factor=fn.nonparametric(fn.ConstantFunction(1.0, "diffusion_factor")),
        diffusion_tensor=fn.nonparametric(fn.constant_matrix(1.0)),
        force=fn.nonparametric(fn.ConstantFunction(1.0, "force")),
        dirichlet=fn.nonparametric(fn.ExpressionFunction("0.25*x[0]*x[1]", 2, "dirichlet")),
        neumann=fn.nonparametric(fn.ConstantFunction(0.1, "neumann")))


def _grids(kind, n):
    if kind == "rectangle":  # 8x8 squares, n red refinements
        t, j = tg.rectangle_grid((-1, -1), (1, 1), (8, 8)), jg.rectangle_grid((-1, -1), (1, 1),
                                                                              (8, 8))
        for _ in range(n):
            t, j = tg.refine(t)[0], jg.refine(j)[0]
        return t, j
    lo, hi = ((0, 0), (1, 1)) if kind == "unit" else ((-1, -1), (1, 1))
    return (tg.alu_cube_grid(lo, hi, (4, 4), refinements=n),
            jg.alu_cube_grid(lo, hi, (4, 4), refinements=n))


CASES = {  # name -> (grid kind, refinements, problem, boundary, mu)
    "esv2007_rectangle_1": ("rectangle", 1, "esv2007", ALL_DIRICHLET, None),
    "esv2007_rectangle_2": ("rectangle", 2, "esv2007", ALL_DIRICHLET, None),
    "esv2007_alu_2": ("alu", 2, "esv2007", ALL_DIRICHLET, None),
    "esv2007_alu_4": ("alu", 4, "esv2007", ALL_DIRICHLET, None),
    "thermalblock_alu_4": ("unit", 4, "thermalblock", ALL_DIRICHLET, MU),
    "mixed_alu_4": ("unit", 4, "mixed", MIXED, None),
}
_BUILT = {}


def _case(name):
    """(port discretization, reference discretization, mu), built once."""
    if name not in _BUILT:
        kind, n, problem, boundary, mu = CASES[name]
        t_grid, j_grid = _grids(kind, n)
        probs = {"esv2007": lambda: (tp.ESV2007Problem(), jp.ESV2007Problem()),
                 "thermalblock": lambda: (tp.ThermalblockProblem((2, 2)),
                                          jp.ThermalblockProblem((2, 2))),
                 "mixed": lambda: (_mixed_boundaries(tf, tp), _mixed_boundaries(jf, jp))}[problem]()
        _BUILT[name] = (TCG(t_grid, boundary, probs[0], device="cpu"),
                        JCG(j_grid, boundary, probs[1]), mu)
    return _BUILT[name]


def _close(a, b, rel=1e-12, atol=None):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    bound = atol if atol is not None else rel * max(np.abs(b).max(), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=bound)


def _payload(p):
    return p.values if hasattr(p, "pattern") else p  # a SparseMatrix's slot values


def _same_decomposition(t, j):
    assert t.num_components == j.num_components
    assert [c.expression for c in t.coefficients] == [c.expression for c in j.coefficients]
    assert (t.affine_part is None) == (j.affine_part is None)
    for a, b in zip(t.components + [t.affine_part], j.components + [j.affine_part]):
        if a is not None:
            _close(_payload(a), _payload(b))


@pytest.mark.parametrize("name", list(CASES))
def test_operator_rhs_products_vectors(name):
    d, jd, _ = _case(name)
    assert d.space.num_dofs == jd.space.num_dofs
    _same_decomposition(d.get_operator(), jd.get_operator())
    _same_decomposition(d.get_rhs(), jd.get_rhs())
    assert d.available_products() == jd.available_products() == ["energy", "h1_semi", "l2"]
    for p in d.available_products():
        _same_decomposition(d.get_product(p), jd.get_product(p))
    assert d.available_vectors() == jd.available_vectors() == ["dirichlet"]
    _same_decomposition(d.get_vector("dirichlet"), jd.get_vector("dirichlet"))


@pytest.mark.parametrize("name", list(CASES))
def test_solution_with_dirichlet_shift(name):
    d, jd, mu = _case(name)
    jmu = None if mu is None else {"diffusion_factor": jnp.asarray(mu)}
    u = d.solve_with_dirichlet_shift(mu, options={"type": "direct"})
    _close(u, jd.solve_with_dirichlet_shift(jmu, options={"type": "direct"}))
    if name.startswith("mixed"):  # the shift reproduces g = 0.25 x y on Dirichlet vertices
        mask = d.boundary_info.dirichlet_vertices
        v = d.space.grid.vertices
        np.testing.assert_allclose(u.numpy()[mask], 0.25 * v[mask, 0] * v[mask, 1], atol=1e-12)
        assert float(u.max()) > 0.25


def test_cg_esv2007_converges():
    """ESV2007 + CG-P1 over 3 levels of red refinement: EOC ~ {2, 1}."""
    problem, exact = tp.ESV2007Problem(), tesv.Testcase1ExactSolution()
    errors = []
    grid = tg.rectangle_grid((-1, -1), (1, 1), (8, 8))
    for _ in range(3):
        disc = TCG(grid, ALL_DIRICHLET, problem, device="cpu")
        u = disc.solve_with_dirichlet_shift(options={"type": "cg.jacobi", "precision": 1e-13})
        errors.append(error_norms(disc.space, u, exact))
        grid, _ = tg.refine(grid)
    for norm, rate in (("L2", 1.85), ("H1_semi", 0.95)):
        e = [x[norm] for x in errors]
        eoc = [np.log2(e[i] / e[i + 1]) for i in range(2)]
        assert all(r > rate for r in eoc), (norm, e, eoc)


def test_cg_solver_types_agree():
    d, jd, _ = _case("esv2007_rectangle_1")
    u_direct = d.solve(options={"type": "direct"})
    for t in ("cg.jacobi", "bicgstab.jacobi"):
        u = d.solve(options={"type": t, "precision": 1e-12})
        assert float(torch.max(torch.abs(u - u_direct))) < 1e-8, t
    gmres = {"type": "gmres.jacobi", "precision": 1e-10}
    _close(d.solve(options=gmres), jd.solve(options=gmres), rel=1e-8)


def test_cg_products():
    problem = tp.ESV2007Problem()
    grid = tg.rectangle_grid((-1, -1), (1, 1), (16, 16))
    disc = TCG(grid, ALL_DIRICHLET, problem, device="cpu")
    ones = torch.ones(disc.space.num_dofs, dtype=torch.float64)
    # || 1 ||_L2 over [-1,1]^2 = 2
    assert float(induced_norm(disc.product_matrix("l2"), ones)) == pytest.approx(2.0, rel=1e-12)
    # h1_semi of linear x: ||grad x||_L2 = 2; energy == h1_semi for unit diffusion
    lin = torch.as_tensor(grid.vertices[:, 0])
    for p in ("h1_semi", "energy"):
        assert float(induced_norm(disc.product_matrix(p), lin)) == pytest.approx(2.0, rel=1e-12)


def test_cg_idbased_boundary_matches_normalbased():
    """Id-based boundary info gives the discretization of the equivalent
    normal-based classification."""
    problem = _mixed_boundaries(tf, tp)
    grid = tg.rectangle_grid((0, 0), (1, 1), (12, 12))
    bi_id = {"type": "stuff.grid.boundaryinfo.idbased", "default": "dirichlet", "neumann": "1 2"}
    u_id = TCG(grid, bi_id, problem, device="cpu").solve_with_dirichlet_shift(
        options={"type": "direct"})
    u_nb = TCG(grid, MIXED, problem, device="cpu").solve_with_dirichlet_shift(
        options={"type": "direct"})
    np.testing.assert_allclose(u_id.numpy(), u_nb.numpy(), atol=1e-13)


def test_cg_parametric_affine_consistency():
    """The frozen parametric operator equals the operator assembled from the
    frozen problem."""
    d, _, mu = _case("thermalblock_alu_4")
    assert d.parametric()
    frozen = TCG(d.space.grid, ALL_DIRICHLET, d.problem.with_mu(mu), device="cpu")
    _close(d.freeze_operator(mu).values, frozen.freeze_operator({}).values)
    _close(d.solve(mu, options={"type": "direct"}), frozen.solve(options={"type": "direct"}),
           atol=1e-10)


def test_cg_thermalblock_solution_cache():
    problem = tp.ThermalblockProblem((2, 2))
    grid = tg.rectangle_grid((0, 0), (1, 1), (8, 8))
    disc = TCG(grid, ALL_DIRICHLET, problem, device="cpu")
    mu = {"diffusion_factor": np.array([1.0, 2.0, 3.0, 4.0])}
    u1 = disc.solve(mu)
    assert disc.solve(mu) is u1  # cache hit (base.hh:151-178 semantics)
    assert float(u1.max()) > 0.0


def test_orders_above_one_and_default_device():
    """Orders 2 (P2 triangles, Q2 quads) and 3 (P3) equal the reference's:
    operator, rhs, Dirichlet vector and the shifted direct solution."""
    for order, cell_type in ((2, "triangle"), (3, "triangle"), (2, "quad")):
        t = tg.rectangle_grid((-1, -1), (1, 1), (4, 4), cell_type)
        j = jg.rectangle_grid((-1, -1), (1, 1), (4, 4), cell_type)
        d = TCG(t, MIXED, _mixed_boundaries(tf, tp), order=order, device="cpu")
        jd = JCG(j, MIXED, _mixed_boundaries(jf, jp), order=order)
        assert d.space.num_dofs == jd.space.num_dofs
        _close(d.freeze_operator({}).values, jd.freeze_operator(None).values)
        _close(d.freeze_rhs({}), jd.freeze_rhs(None))
        _close(d._vectors["dirichlet"].affine_part, jd._vectors["dirichlet"].affine_part)
        _close(d.solve_with_dirichlet_shift(options={"type": "direct"}),
               jd.solve_with_dirichlet_shift(options={"type": "direct"}), atol=1e-10)
    grid = tg.rectangle_grid((0, 0), (1, 1), (2, 2))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCG(grid, ALL_DIRICHLET, tp.ESV2007Problem())
