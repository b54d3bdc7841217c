"""The SWIPDG discretization of the PyTorch port against the JAX package's
(x64, CPU), for ESV2007 levels 0-1 and the 2x2 thermalblock at 2 and 4
bisections:

* operator, rhs and all six product components: 1e-12 x max;
* solves with every solver option against the reference's direct solve:
  atol 1e-8 (precision 1e-12), as the reference's own stencil_cg test;
* make_solve_fn at 3 values of mu against the reference's: 1e-8 x max
  (both stop at a relative recurrence residual of 1e-10);
* the purely-Neumann pinning, the scheme guard's warning, the reference's
  assembled operator solved in the port (``convert.py``), and the
  block_cg fallback of stencil_cg on an unstructured grid.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu.affine import AffineDecomposition as JAffine  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from dune_hdd_tpu_torch.affine import AffineDecomposition as TAffine  # noqa: E402
from dune_hdd_tpu_torch.convert import affine_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import rectangle_grid as t_rect  # noqa: E402
from dune_hdd_tpu_torch.la.solvers import solve as t_solve  # noqa: E402
from dune_hdd_tpu_torch.parameters import parse_parameter  # noqa: E402

ALL_PRODUCTS = ("l2", "h1_semi", "elliptic", "boundary_l2", "penalty", "energy")
DIRICHLET = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MU = np.array([0.1, 1.0, 0.5, 0.3])  # <= penalty_mu componentwise (CG-class solvers)
CASES = {
    "esv2007_l0": ((-1, -1), (1, 1), 2, "esv2007"),
    "esv2007_l1": ((-1, -1), (1, 1), 4, "esv2007"),
    "thermalblock_b2": ((0, 0), (1, 1), 2, "thermalblock"),
    "thermalblock_b4": ((0, 0), (1, 1), 4, "thermalblock"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_BUILT = {}


def _case(name):
    """(port discretization, reference discretization, mu or None), built once."""
    if name not in _BUILT:
        lo, hi, bisections, problem = CASES[name]
        tg, jg = t_grid(lo, hi, (4, 4), refinements=bisections), j_grid(
            lo, hi, (4, 4), refinements=bisections)
        if problem == "esv2007":
            probs, mu = (tp.ESV2007Problem(), jp.ESV2007Problem()), None
        else:
            probs, mu = (tp.ThermalblockProblem((2, 2)), jp.ThermalblockProblem((2, 2))), MU
        _BUILT[name] = (TD(tg, DIRICHLET, probs[0], only_these_products=ALL_PRODUCTS,
                           device="cpu"),
                        JD(jg, DIRICHLET, probs[1], only_these_products=ALL_PRODUCTS), mu)
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
def test_operator_rhs_products(name):
    d, jd, _ = _case(name)
    assert d.scheme == jd.scheme
    _same_decomposition(d.get_operator(), jd.get_operator())
    _same_decomposition(d.get_rhs(), jd.get_rhs())
    assert d.available_products() == jd.available_products()
    for p in ALL_PRODUCTS:
        _same_decomposition(d.get_product(p), jd.get_product(p))


SOLVERS = [
    {"type": "direct"},
    {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000},
    {"type": "bicgstab.jacobi", "precision": 1e-12, "max_iter": 20000},
    {"type": "block_cg.jacobi", "precision": 1e-12},
    {"type": "stencil_cg", "precision": 1e-12},
    {"type": "stencil_cg", "precision": 1e-12, "macro": (4, 4)},
]


@pytest.mark.parametrize("name", ["esv2007_l1", "thermalblock_b2", "thermalblock_b4"])
@pytest.mark.parametrize("options", SOLVERS, ids=lambda o: o["type"] + ("+macro" if "macro" in o
                                                                       else ""))
def test_solve(name, options):
    d, jd, mu = _case(name)
    u = d.solve(mu, options=options)
    u_ref = jd.solve(None if mu is None else {"diffusion_factor": jnp.asarray(mu)},
                     options={"type": "direct"})
    _close(u, u_ref, atol=1e-8)
    if options["type"] in ("block_cg.jacobi", "stencil_cg"):
        assert 0 < d.last_solve_info["iterations"] < 10000
        assert d.last_solve_info["type"] == options["type"]


def test_make_solve_fn():
    d, jd, _ = _case("thermalblock_b4")
    solve_fn, thetas = d.make_solve_fn(tol=1e-10, maxiter=5000, device="cpu")
    jsolve_fn, jthetas = jd.make_solve_fn(tol=1e-10, maxiter=5000)
    rng = np.random.default_rng(3)
    for mu in rng.uniform(0.1, 1.0, (3, 4)):
        u, res, iters = solve_fn(*thetas(mu))
        ju, jres = jsolve_fn(*jthetas({"diffusion_factor": jnp.asarray(mu)}))
        assert float(res) <= 1e-10 and 0 < iters < 5000
        _close(u, ju, rel=1e-8)
        # the port's own recheck: the unscaled float64 residual
        A, b = d.freeze_operator(mu), d.freeze_rhs(mu)
        assert float(torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b)) <= 1e-9


def test_purely_neumann():
    config = {"type": "stuff.grid.boundaryinfo.allneumann"}
    d = TD(t_grid((-1, -1), (1, 1), (4, 4), refinements=2), config, tp.ESV2007Problem(),
           device="cpu")
    jd = JD(j_grid((-1, -1), (1, 1), (4, 4), refinements=2), config, jp.ESV2007Problem())
    assert d.purely_neumann and jd.purely_neumann
    u = d.solve(options={"type": "direct"})
    _close(u, jd.solve(options={"type": "direct"}), rel=1e-10)
    assert abs(float(u.mean())) < 1e-12


def test_scheme_guard_warning():
    """A sign-indefinite affine part: an explicit scheme="reference" warns and
    falls back to penalty_mu in both packages."""
    from dune_hdd_tpu.parameters import ParameterFunctional as JPF
    from dune_hdd_tpu_torch.parameters import ParameterFunctional as TPF

    def problem(fn, aff, pf, pkg):
        dec = aff()
        dec.register_component(fn.ConstantFunction(1.0), pf({"mu": 1}, "mu"))
        dec.register_affine_part(fn.ExpressionFunction("x[0] - 0.5"))
        return pkg.DefaultProblem(diffusion_factor=dec)

    tg, jg = t_grid((0, 0), (1, 1), (2, 2), refinements=2), j_grid((0, 0), (1, 1), (2, 2),
                                                                   refinements=2)
    with pytest.warns(RuntimeWarning, match="penalty_mu"):
        d = TD(tg, DIRICHLET, problem(tf, TAffine, TPF, tp), scheme="reference", device="cpu")
    with pytest.warns(RuntimeWarning, match="penalty_mu"):
        jd = JD(jg, DIRICHLET, problem(jf, JAffine, JPF, jp), scheme="reference")
    assert d.scheme == jd.scheme == "penalty_mu"
    assert d.scheme_substituted and jd.scheme_substituted
    _same_decomposition(d.get_operator(), jd.get_operator())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the implicit default substitutes silently
        assert TD(tg, DIRICHLET, problem(tf, TAffine, TPF, tp), device="cpu").scheme_substituted


def test_reference_operator_through_convert():
    """The reference's assembled operator and rhs, carried across as numpy
    arrays, solved in the port."""
    _, jd, mu = _case("thermalblock_b2")
    op, rhs = jd.get_operator(), jd.get_rhs()
    p = op.components[0].pattern
    fields = {name: getattr(p, name) for name in ("shape", "nnz", "ell_width", "perm", "seg_ids",
                                                  "slot_rows", "slot_cols", "ell_cols",
                                                  "ell_mask", "slot_ell_pos", "diag_slot")}
    A = affine_from_numpy([np.asarray(m.values) for m in op.components], op.coefficients,
                          np.asarray(op.affine_part.values), "cpu", pattern_fields=fields)
    b = affine_from_numpy([np.asarray(v) for v in rhs.components], rhs.coefficients,
                          np.asarray(rhs.affine_part), "cpu")
    tmu = parse_parameter({"diffusion_factor": mu})
    u = t_solve(A.freeze(tmu), b.freeze(tmu), {"type": "cg.jacobi", "precision": 1e-12})
    u_ref = jd.solve({"diffusion_factor": jnp.asarray(mu)}, options={"type": "direct"})
    _close(u, u_ref, atol=1e-8)


def test_stencil_cg_falls_back_on_unstructured_grid_and_errors():
    """An odd lattice has no structured cell order: stencil_cg runs block_cg.
    gmres.jacobi there equals the reference's gmres.jacobi solution."""
    from dune_hdd_tpu.grid.structured import rectangle_grid as j_rect

    d = TD(t_rect((0, 0), (1, 1), (5, 5)), DIRICHLET, tp.ThermalblockProblem((2, 2)),
           device="cpu")
    u = d.solve(MU, options={"type": "stencil_cg", "precision": 1e-12})
    assert d.last_solve_info["type"] == "block_cg.jacobi"
    _close(u, d.solve(MU, options={"type": "direct"}), atol=1e-7)
    jd = JD(j_rect((0, 0), (1, 1), (5, 5)), DIRICHLET, jp.ThermalblockProblem((2, 2)))
    gmres = {"type": "gmres.jacobi", "precision": 1e-10}
    _close(d.solve(MU, options=gmres),
           jd.solve({"diffusion_factor": jnp.asarray(MU)}, options=gmres), rel=1e-8)


def test_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    grid = t_grid((0, 0), (1, 1), (2, 2), refinements=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD(grid, DIRICHLET, tp.ESV2007Problem())
    d = TD(grid, DIRICHLET, tp.ThermalblockProblem((2, 2)), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        d.make_solve_fn()
