"""GMRES of the PyTorch port against the JAX package's
``jax.scipy.sparse.linalg.gmres`` (x64, CPU): "gmres" and "gmres.jacobi"
(restart 50, the reference's defaults) on ESV2007 ALU levels 0-1 with SWIPDG
P1 and with CG P1, and on the 2x2 thermalblock (SWIPDG, a parametric
operator at one mu): the solutions equal the reference's to 1e-8 x max
(both stop at a relative 1e-10).  Plus the solver's own semantics:
``maxiter`` counts restarts, the stopping test reads the preconditioned
residual, and an invariant Krylov space ends a restart exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu.discretizations import CGDiscretization as JCG  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from dune_hdd_tpu_torch.discretizations import CGDiscretization as TCG  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.la.solvers import gmres, solver_options  # noqa: E402

DIRICHLET = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MU = np.array([0.1, 1.0, 0.5, 0.3])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, rel):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


_BUILT = {}


def _case(kind, bisections):
    key = (kind, bisections)
    if key not in _BUILT:
        lo, hi = ((0, 0), (1, 1)) if kind == "thermalblock" else ((-1, -1), (1, 1))
        tg, jg = t_grid(lo, hi, (4, 4), bisections), j_grid(lo, hi, (4, 4), bisections)
        if kind == "thermalblock":
            probs = tp.ThermalblockProblem((2, 2)), jp.ThermalblockProblem((2, 2))
        else:
            probs = tp.ESV2007Problem(), jp.ESV2007Problem()
        T, J = (TCG, JCG) if kind == "cg" else (TD, JD)
        kw = {} if kind == "cg" else {"only_these_products": ()}
        _BUILT[key] = (T(tg, DIRICHLET, probs[0], device="cpu", **kw),
                       J(jg, DIRICHLET, probs[1], **kw))
    return _BUILT[key]


@pytest.mark.parametrize("kind,bisections", [("swipdg", 2), ("swipdg", 4), ("cg", 2),
                                             ("cg", 4), ("thermalblock", 2)])
@pytest.mark.parametrize("type_", ["gmres", "gmres.jacobi"])
def test_gmres_matches_reference(kind, bisections, type_):
    d, jd = _case(kind, bisections)
    opts = dict(solver_options(type_), precision=1e-10)
    assert (opts["restart"], opts["max_iter"]) == (50, 2000)
    mu = MU if kind == "thermalblock" else None
    jmu = {"diffusion_factor": jnp.asarray(MU)} if kind == "thermalblock" else None
    _close(d.solve(mu, options=opts), jd.solve(jmu, options=opts), rel=1e-8)


def test_gmres_semantics():
    rng = np.random.default_rng(0)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = torch.as_tensor(Q @ np.diag(np.linspace(1.0, 100.0, n)) @ Q.T
                        + 0.1 * rng.standard_normal((n, n)))
    b = torch.as_tensor(rng.standard_normal(n))
    x_ref = torch.linalg.solve(A, b)
    # maxiter counts restarts: one restart of 5 Arnoldi steps, then stop
    _, steps, restarts = gmres(lambda v: A @ v, b, tol=1e-14, restart=5, maxiter=1)
    assert (steps, restarts) == (5, 1)
    x, steps, restarts = gmres(lambda v: A @ v, b, tol=1e-12, restart=10, maxiter=1000)
    assert float(torch.linalg.norm(A @ x - b) / torch.linalg.norm(b)) < 1e-11
    assert restarts > 1 and steps <= 10 * restarts
    # full restart length: an invariant Krylov space ends the first restart exactly
    x, steps, restarts = gmres(lambda v: A @ v, b, tol=1e-12, restart=n, maxiter=3)
    assert restarts == 1 and steps <= n
    _close(x, x_ref, rel=1e-10)
    # the stopping test reads M (b - A x) against tol ||b||: a preconditioner
    # scaled by 1e-3 stops 1e3 earlier in the true residual
    x, _, _ = gmres(lambda v: A @ v, b, tol=1e-9, restart=10, maxiter=1000,
                    M=lambda r: 1e-3 * r)
    true = float(torch.linalg.norm(A @ x - b) / torch.linalg.norm(b))
    assert 1e-9 < true < 1e-5
