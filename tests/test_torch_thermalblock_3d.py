"""The 3D parametric thermalblock of the PyTorch port (the reference's
ThermalblockExample<SGrid<3,3>>: a [2 2 2] checkerboard diffusion through
the Q1 tensor CG discretization and the RB greedy) against the JAX package's
(x64, CPU), mirroring ``tests/test_thermalblock_3d.py`` at 6^3 cells:

* the 3D checkerboard numbering ix + nx*(iy + ny*iz), the partition of
  unity, the problem's ``create``;
* the affine solve at the reference test's mu to 1e-10, its residual, mu = 1
  against the constant-diffusion solve, monotonicity;
* the true-error greedy: the same selected mu and maximum errors (1e-8
  relative), decreasing;
* the TensorCG cases of ``tests/test_mor_batch.py``: batched reduced solves
  and Riesz estimates equal to the loop (the reference test's bars), the
  estimator greedy, the 12x12 certification in [0.99, 10]; the reduced
  solves and estimates equal to the reference's (1e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations.tensor_cg import TensorCGDiscretization as JTCG  # noqa: E402
from dune_hdd_tpu.grid.tensor import tensor_grid as jtensor_grid  # noqa: E402
from dune_hdd_tpu.mor.greedy import greedy_rb as jgreedy_rb  # noqa: E402
from dune_hdd_tpu.problems.thermalblock import ThermalblockProblem as JTB  # noqa: E402
from dune_hdd_tpu_torch.cli.examples import ThermalblockExample  # noqa: E402
from dune_hdd_tpu_torch.discretizations.tensor_cg import TensorCGDiscretization as TTCG  # noqa: E402
from dune_hdd_tpu_torch.functions.base import (  # noqa: E402
    CheckerboardFunction, make_checkerboard_decomposition)
from dune_hdd_tpu_torch.grid.tensor import tensor_grid  # noqa: E402
from dune_hdd_tpu_torch.mor import (  # noqa: E402
    RBReductor, RieszResidualEstimator, greedy_rb, min_theta_coercivity)
from dune_hdd_tpu_torch.mor.batch import (  # noqa: E402
    batched_estimates, batched_reduced_solve, stack_parameters)
from dune_hdd_tpu_torch.mor.greedy import _extend  # noqa: E402
from dune_hdd_tpu_torch.parameters import ParameterType  # noqa: E402
from dune_hdd_tpu_torch.problems.thermalblock import ThermalblockProblem  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

CG_OPTS = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000}
MU = np.array([0.1, 1.0, 0.5, 2.0, 1.0, 0.3, 4.0, 1.0])


def _np(a):
    return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, dtype=np.float64)


def test_checkerboard_3d_block_numbering():
    ne = (2, 3, 2)
    vals = np.arange(np.prod(ne), dtype=float)
    f = CheckerboardFunction((0, 0, 0), (1, 1, 1), ne, vals)
    x = np.random.default_rng(3).random((40, 3))
    ij = np.minimum((x * np.array(ne)).astype(int), np.array(ne) - 1)
    expected = ij[:, 0] + ne[0] * (ij[:, 1] + ne[1] * ij[:, 2])
    np.testing.assert_array_equal(_np(f(torch.tensor(x))), expected.astype(float))


def test_checkerboard_3d_partition_of_unity():
    dec = make_checkerboard_decomposition((0, 0, 0), (1, 1, 1), (2, 2, 2))
    assert dec.num_components == 8
    x = torch.tensor(np.random.default_rng(0).random((25, 3)))
    np.testing.assert_allclose(_np(sum(c(x) for c in dec.components)), 1.0)


def test_thermalblock_problem_3d():
    p = ThermalblockProblem(num_blocks=(2, 2, 2))
    assert p.diffusion_factor.parameter_type == ParameterType({"diffusion_factor": 8})
    assert p.diffusion_factor.num_components == 8
    p3 = ThermalblockProblem.create({"dim": 3, "diffusion_factor": {"num_elements": [2, 2, 2]}})
    assert p3.num_blocks == (2, 2, 2)
    assert ThermalblockProblem.create({"diffusion_factor": {"num_elements": [4, 4, 4]}}
                                      ).num_blocks == (4, 4)


@pytest.fixture(scope="module")
def discs():
    """(port, reference) TensorCG thermalblock [2 2 2] at 6^3 cells."""
    return (TTCG(tensor_grid((0.0,) * 3, (1.0,) * 3, (6, 6, 6)), None,
                 ThermalblockProblem((2, 2, 2)), device="cpu"),
            JTCG(jtensor_grid((0.0,) * 3, (1.0,) * 3, (6, 6, 6)), None, JTB((2, 2, 2))))


def test_affine_solve(discs):
    t, j = discs
    assert len(t.get_operator().components) == 8
    mu = {"diffusion_factor": MU}
    u = t.solve(mu, CG_OPTS)
    uj = _np(j.solve(mu, CG_OPTS))
    np.testing.assert_allclose(_np(u), uj, rtol=0, atol=1e-10 * np.abs(uj).max())
    A, b = t.freeze_operator(mu), t.freeze_rhs(mu)
    assert float(torch.linalg.norm(A.matvec(u) - b)) <= 1e-8 * max(1.0, float(
        torch.linalg.norm(b)))
    u1 = t.solve({"diffusion_factor": np.ones(8)}, CG_OPTS)
    uref = TTCG(t.space.grid, None, device="cpu").solve(None, CG_OPTS)
    np.testing.assert_allclose(_np(u1), _np(uref), atol=1e-10)
    u10 = t.solve({"diffusion_factor": 10 * np.ones(8)}, CG_OPTS)
    assert float(u10.abs().max()) < float(u1.abs().max())


def test_rb_greedy_matches_reference(discs):
    t, j = discs
    rng = np.random.default_rng(7)
    training = [{"diffusion_factor": 10 ** rng.uniform(-1, 1, 8)} for _ in range(6)]
    res = greedy_rb(t, training, target_error=1e-8, max_extensions=5, error_norm="h1_semi",
                    solver_options=CG_OPTS)
    jres = jgreedy_rb(j, training, target_error=1e-8, max_extensions=5, error_norm="h1_semi",
                      solver_options=CG_OPTS)
    assert ([next(i for i, m in enumerate(training) if m is mu) for mu in res.selected_mus]
            == [next(i for i, m in enumerate(training) if m is mu) for mu in jres.selected_mus])
    np.testing.assert_allclose(res.max_errors, jres.max_errors, rtol=1e-8)
    errs = [e for e in res.max_errors if e >= 0]
    assert len(errs) >= 2 and errs[-1] < errs[0]
    rom = res.reduced_model
    mu = training[0]
    u_red = rom.reconstruct(rom.solve(mu))
    u_det = t.solve(mu, CG_OPTS)
    prod = t.product_matrix("h1_semi")
    e = u_det - u_red
    err = float(torch.sqrt(e @ prod.matvec(e)))
    assert err <= 1e-3 * max(float(torch.sqrt(u_det @ prod.matvec(u_det))), 1e-12)


def test_thermalblock_example_tensor_3d():
    d = ThermalblockExample(device="cpu").initialize_tensor(
        dim=3, num_elements=4, num_blocks=(2, 2, 2)).discretization()
    assert d.space.dim == 3 and len(d.get_operator().components) == 8
    assert bool(torch.isfinite(d.solve({"diffusion_factor": np.ones(8)}, CG_OPTS)).all())


# -- the TensorCG cases of tests/test_mor_batch.py ---------------------------------


def _setup(pkg="port"):
    grid = ((tensor_grid if pkg == "port" else jtensor_grid)((0.0, 0.0), (1.0, 1.0), (8, 8)))
    d = (TTCG(grid, None, ThermalblockProblem((2, 2)), device="cpu") if pkg == "port"
         else JTCG(grid, None, JTB((2, 2))))
    rng = np.random.default_rng(11)
    mus = [{"diffusion_factor": 10 ** rng.uniform(-1, 1, 4)} for _ in range(7)]
    return d, mus


@pytest.fixture(scope="module")
def batch_case():
    d, mus = _setup()
    basis = torch.zeros((0, d.space.num_dofs), dtype=torch.float64)
    for mu in mus[:3]:
        basis = _extend(basis, d.solve(mu, CG_OPTS), "gram_schmidt", d.product_matrix("h1_semi"))
    return d, RBReductor(d).reduce(basis), basis, mus


def test_batched_reduced_solve_matches_loop(batch_case):
    d, rm, _, mus = batch_case
    C = _np(batched_reduced_solve(rm, stack_parameters(d.problem, mus)))
    for m, mu in enumerate(mus):
        np.testing.assert_allclose(C[m], _np(rm.solve(mu)), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("with_coercivity", [False, True])
def test_batched_estimates_match_loop(batch_case, with_coercivity):
    d, rm, basis, mus = batch_case
    alpha = (min_theta_coercivity(d.get_operator(), d.problem.parse_parameter(mus[0]))
             if with_coercivity else None)
    online = RieszResidualEstimator(d, product="h1_semi", coercivity=alpha).offline(basis)
    coercs = (np.asarray([float(alpha(d.problem.parse_parameter(mu))) for mu in mus])
              if with_coercivity else None)
    etas = batched_estimates(online, rm, stack_parameters(d.problem, mus), coercs)
    refs = np.asarray([online.estimate(mu, rm.solve(mu)) for mu in mus])
    np.testing.assert_allclose(etas, refs, rtol=1e-3, atol=2e-3 * float(refs.max()))


def test_reduced_solves_and_estimates_match_reference(batch_case):
    """The same basis construction in the reference package: equal reduced
    solutions and Riesz estimates (1e-8)."""
    from dune_hdd_tpu.mor.greedy import _extend as jextend
    from dune_hdd_tpu.mor.reductor import RBReductor as JRBReductor
    from dune_hdd_tpu.mor.residual import RieszResidualEstimator as JRiesz

    d, rm, basis, mus = batch_case
    jd, _ = _setup("reference")
    jbasis = jnp.zeros((0, jd.space.num_dofs))
    for mu in mus[:3]:
        jbasis = jextend(jbasis, jd.solve(mu, CG_OPTS), "gram_schmidt",
                         jd.product_matrix("h1_semi"))
    np.testing.assert_allclose(_np(basis), np.asarray(jbasis), rtol=0, atol=1e-9)
    jrm = JRBReductor(jd).reduce(jbasis)
    online = RieszResidualEstimator(d, product="h1_semi").offline(basis)
    jonline = JRiesz(jd, product="h1_semi").offline(jbasis)
    for mu in mus[3:]:
        c, jc = _np(rm.solve(mu)), np.asarray(jrm.solve(mu))
        np.testing.assert_allclose(c, jc, rtol=1e-8, atol=1e-12)
        assert np.isclose(online.estimate(mu, rm.solve(mu)), jonline.estimate(mu, jrm.solve(mu)),
                          rtol=1e-8)


def test_greedy_estimator_mode_uses_batched_path(batch_case):
    d, _, _, mus = batch_case
    res = greedy_rb(d, mus, target_error=1e-10, max_extensions=4, use_estimator=True,
                    solver_options=CG_OPTS)
    errs = [e for e in res.max_errors if e >= 0]
    assert len(errs) >= 2 and errs[-1] < errs[0]
    assert np.isfinite(res.max_errors[0])


def test_cg_estimator_certifies_energy_error():
    grid = tensor_grid((0.0, 0.0), (1.0, 1.0), (12, 12))
    d = TTCG(grid, None, ThermalblockProblem((2, 2)), device="cpu")
    opts = {"type": "cg.jacobi", "precision": 1e-13, "max_iter": 30000}
    rng = np.random.default_rng(3)
    mus = [{"diffusion_factor": 10 ** rng.uniform(-1, 1, 4)} for _ in range(8)]
    basis = torch.zeros((0, d.space.num_dofs), dtype=torch.float64)
    for mu in mus[:3]:
        basis = _extend(basis, d.solve(mu, opts), "gram_schmidt", d.product_matrix("h1_semi"))
    rm = RBReductor(d).reduce(basis)
    alpha = min_theta_coercivity(d.get_operator(),
                                 d.problem.parse_parameter({"diffusion_factor": np.ones(4)}))
    online = RieszResidualEstimator(d, product="h1_semi", coercivity=alpha).offline(basis)
    for mu in mus[3:]:
        u = d.solve(mu, opts)
        e = u - rm.reconstruct(rm.solve(mu))
        err = float(torch.sqrt(torch.clamp(e @ d.freeze_operator(mu).matvec(e), min=0.0)))
        eta = online.estimate(mu, rm.solve(mu))
        assert 0.99 * err <= eta <= 10.0 * err, (err, eta)
