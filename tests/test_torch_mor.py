"""Model order reduction of the PyTorch port (dune_hdd_tpu_torch/mor) against
the JAX package's (x64, CPU), on the reference's fixture: the 2x2
thermalblock SWIPDG on the unit square at 2 bisections (384 DoF), and the
CG discretization of the same problem for the Dirichlet-constrained branch:

* sampling, gram_schmidt (with and without a product) at 1e-12, pod (modes
  up to sign per mode) and its singular values at 1e-10, trivial_extension;
* RBReductor.reduce (op_mats, rhs_vecs, products) at 1e-12 on one basis,
  the column-chunked projection against one unchunked call at 1e-13, the
  reduced solve, true_error and residual_norm;
* RieszResidualEstimator's G_ff, G_fa, G_aa at 1e-10 (DG h1_semi; the
  parametric energy product at mu_bar with min-theta coercivity; the
  Dirichlet-constrained CG h1_semi), the device Gramians against the host
  einsum formula at 1e-12, OnlineResidual.estimate at 1e-10;
* greedy_rb in its three modes (true error, "algebraic", "riesz"): the same
  selections, max_errors and basis at 1e-8; checkpoint/resume equal to the
  uninterrupted run;
* the batched sweeps equal the loop and the reference's batch at 1e-10;
* io: the port's round trip bitwise, a reference-saved model loaded by the
  port, a port-saved one loaded by the reference, and
  convert.reduced_model_from_numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import mor as jmor  # noqa: E402
from dune_hdd_tpu.discretizations import CGDiscretization as JCG  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.grid import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.mor import batch as jbatch  # noqa: E402
from dune_hdd_tpu.mor import io as jio  # noqa: E402
from dune_hdd_tpu.problems import ThermalblockProblem as JTB  # noqa: E402
from dune_hdd_tpu_torch import mor as tmor  # noqa: E402
from dune_hdd_tpu_torch.convert import reduced_model_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.discretizations import CGDiscretization as TCG  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.mor import batch as tbatch  # noqa: E402
from dune_hdd_tpu_torch.mor import io as tio  # noqa: E402
from dune_hdd_tpu_torch.mor.reductor import project  # noqa: E402
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MODES = [False, "algebraic", "riesz"]


@pytest.fixture(scope="module")
def discs():
    """(reference SWIPDG, port SWIPDG) of the reference's fixture."""
    return (JD(j_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, JTB((2, 2))),
            TD(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu"))


@pytest.fixture(scope="module")
def training(discs):
    jd, td = discs
    return (jmor.sample_randomly(jd.parameter_type, 0.1, 1.0, 6, seed=5),
            tmor.sample_randomly(td.parameter_type, 0.1, 1.0, 6, seed=5))


@pytest.fixture(scope="module")
def greedies(discs, training):
    """{mode: (reference result, port result)}, 4 extensions each."""
    jd, td = discs
    jtr, ttr = training
    return {mode: (jmor.greedy_rb(jd, jtr, target_error=1e-8, max_extensions=4,
                                  use_estimator=mode),
                   tmor.greedy_rb(td, ttr, target_error=1e-8, max_extensions=4,
                                  use_estimator=mode))
            for mode in MODES}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _mu_index(training, mu):
    return next(i for i, m in enumerate(training)
                if all(np.array_equal(np.asarray(m[k]), np.asarray(mu[k])) for k in m))


def test_sampling_matches_reference(discs, training):
    jtr, ttr = training
    for j, t in zip(jtr, ttr, strict=True):
        np.testing.assert_array_equal(t["diffusion_factor"].numpy(),
                                      np.asarray(j["diffusion_factor"]))
    jd, td = discs
    for j, t in zip(jmor.sample_uniformly(jd.parameter_type, 0.1, 1.0, 3),
                    tmor.sample_uniformly(td.parameter_type, 0.1, 1.0, 3), strict=True):
        np.testing.assert_array_equal(t["diffusion_factor"].numpy(),
                                      np.asarray(j["diffusion_factor"]))


@pytest.mark.parametrize("product", [None, "l2", "h1_semi"])
def test_gram_schmidt_matches_reference(discs, product):
    jd, td = discs
    vecs = np.random.default_rng(0).normal(size=(4, td.space.num_dofs))
    vecs = np.concatenate([vecs, vecs[:1] + vecs[1:2]])  # a dependent row is dropped
    jp = None if product is None else jd.product_matrix(product)
    tp = None if product is None else td.product_matrix(product)
    got = tmor.gram_schmidt(_t(vecs), tp)
    want = jmor.gram_schmidt(jnp.asarray(vecs), jp)
    assert got.shape[0] == 4
    _close(got, want, 1e-12)


@pytest.mark.parametrize("product", [None, "l2"])
def test_pod_matches_reference(discs, product):
    jd, td = discs
    base = np.random.default_rng(1).normal(size=(3, td.space.num_dofs))
    snaps = np.concatenate([base, base[0:1] + 2 * base[1:2]])  # rank 3
    jp = None if product is None else jd.product_matrix(product)
    tp = None if product is None else td.product_matrix(product)
    modes, svals = tmor.pod(_t(snaps), tp)
    jmodes, jsvals = jmor.pod(jnp.asarray(snaps), jp)
    _close(svals, jsvals, 1e-10)
    assert modes.shape == (3, td.space.num_dofs)
    jm = np.asarray(jmodes)
    for mode, ref in zip(modes.numpy(), jm, strict=True):
        sign = np.sign(mode @ ref)
        _close(sign * mode, ref, 1e-10)


def test_trivial_extension(discs):
    _, td = discs
    v = torch.arange(float(td.space.num_dofs), dtype=torch.float64)
    b = tmor.trivial_extension(torch.zeros((0, td.space.num_dofs), dtype=torch.float64), v)
    b = tmor.trivial_extension(b, 2 * v)
    np.testing.assert_array_equal(b.numpy(), np.asarray(
        jmor.trivial_extension(jmor.trivial_extension(jnp.zeros((0, v.numel())),
                                                      jnp.asarray(v.numpy())),
                               jnp.asarray(2 * v.numpy()))))


def test_reduce_matches_reference(discs, greedies):
    jd, td = discs
    basis = np.asarray(greedies[False][0].basis)
    jrm = jmor.RBReductor(jd).reduce(jnp.asarray(basis))
    trm = tmor.RBReductor(td).reduce(_t(basis))
    _close(trm.op_mats, jrm.op_mats, 1e-12, "op_mats")
    _close(trm.rhs_vecs, jrm.rhs_vecs, 1e-12, "rhs_vecs")
    assert sorted(trm.products) == sorted(jrm.products) == ["h1_semi", "l2"]
    for name in trm.products:
        _close(trm.products[name], jrm.products[name], 1e-12, name)
    assert [c.expression for c in trm.op_coeffs] == [c.expression for c in jrm.op_coeffs]
    empty = tmor.RBReductor(td).reduce(torch.zeros((0, td.space.num_dofs), dtype=torch.float64))
    assert empty.op_mats.shape == (5, 0, 0) and empty.rhs_vecs.shape[1] == 0


def test_chunked_projection_equals_one_call(discs, greedies):
    _, td = discs
    basis = greedies[False][1].basis
    A = td.get_operator().components[0]
    one = basis @ A.matmat(basis.T)
    per_column = A.shape[0] * A.pattern.ell_width * 8  # one column per chunk
    for gather_bytes in (per_column, 2 * per_column, 1 << 30):
        _close(project(A, basis, gather_bytes), one, 1e-13, str(gather_bytes))


def test_reduced_solve_and_errors_match_reference(discs, training, greedies):
    jd, td = discs
    jres, tres = greedies[False]
    jred, tred = jmor.RBReductor(jd), tmor.RBReductor(td)
    for jmu, tmu in zip(*training):
        _close(tres.reduced_model.solve(tmu), jres.reduced_model.solve(jmu), 1e-10, "solve")
        assert tred.true_error(tres.reduced_model, tmu) == pytest.approx(
            jred.true_error(jres.reduced_model, jmu), rel=1e-8)
        assert tred.residual_norm(tres.reduced_model, tmu) == pytest.approx(
            jred.residual_norm(jres.reduced_model, jmu), rel=1e-8)


def _estimators(kind, discs):
    """(reference estimator, port estimator, reference disc, port disc)."""
    jd, td = discs
    if kind == "h1_semi":
        return (jmor.RieszResidualEstimator(jd, "h1_semi"),
                tmor.RieszResidualEstimator(td, "h1_semi"), jd, td)
    if kind == "energy":
        mu_bar = np.ones(4)
        jc = jmor.min_theta_coercivity(jd.get_operator().with_expanded_affine_part(),
                                       jd.problem.parse_parameter(mu_bar))
        tc = tmor.min_theta_coercivity(td.get_operator().with_expanded_affine_part(),
                                       td.problem.parse_parameter(mu_bar))
        return (jmor.RieszResidualEstimator(jd, "energy", coercivity=jc,
                                            mu_bar={"diffusion_factor": jnp.asarray(mu_bar)}),
                tmor.RieszResidualEstimator(td, "energy", coercivity=tc,
                                            mu_bar={"diffusion_factor": mu_bar}), jd, td)
    jcg = JCG(j_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, JTB((2, 2)))
    tcg = TCG(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu")
    return (jmor.RieszResidualEstimator(jcg, "h1_semi"),
            tmor.RieszResidualEstimator(tcg, "h1_semi"), jcg, tcg)


@pytest.mark.parametrize("kind", ["h1_semi", "energy", "cg_constrained"])
def test_riesz_gramians_match_reference(kind, discs, training):
    jest, test_, jd, td = _estimators(kind, discs)
    snaps = np.stack([np.asarray(jd.solve(mu, options={"type": "direct"}))
                      for mu in training[0][:3]])
    basis = np.asarray(jmor.gram_schmidt(jnp.asarray(snaps), jd.product_matrix("h1_semi")))
    jon, ton = jest.offline(jnp.asarray(basis)), test_.offline(_t(basis))
    for name in ("G_ff", "G_fa", "G_aa"):
        _close(getattr(ton, name), getattr(jon, name), 1e-10, name)
    # the device einsums against the reference's host formula on the same rows
    data = [test_._row_data(r) for r in _t(basis)]
    Ab = np.stack([d[0].numpy() for d in data], axis=1)
    rAb = np.stack([d[1].numpy() for d in data], axis=1)
    G_aa = np.einsum("qiN,pjN->qipj", Ab, rAb)
    _close(ton.G_fa, np.einsum("pN,qjN->pqj", test_._f.numpy(), rAb), 1e-12, "host G_fa")
    _close(ton.G_aa, 0.5 * (G_aa + G_aa.transpose(2, 3, 0, 1)), 1e-12, "host G_aa")
    assert test_.cache_hits == len(basis) and test_.cache_misses == len(basis)
    jrm = jmor.RBReductor(jd).reduce(jnp.asarray(basis))
    trm = tmor.RBReductor(td).reduce(_t(basis))
    # away from the three snapshot parameters, where eta is round-off
    for jmu, tmu in zip(training[0][3:], training[1][3:]):
        assert ton.estimate(tmu, trm.solve(tmu)) == pytest.approx(
            jon.estimate(jmu, jrm.solve(jmu)), rel=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_rb_matches_reference(mode, greedies, training):
    jres, tres = greedies[mode]
    jtr, ttr = training
    assert tres.extensions == jres.extensions == 4
    assert ([_mu_index(ttr, m) for m in tres.selected_mus]
            == [_mu_index(jtr, m) for m in jres.selected_mus])
    np.testing.assert_allclose(tres.max_errors, jres.max_errors, rtol=1e-8)
    _close(tres.basis, jres.basis, 1e-8, "basis")


def test_greedy_checkpoint_resume(discs, tmp_path):
    """An interrupted greedy resumes from its checkpoint and reproduces the
    uninterrupted run (basis, history, selections)."""
    _, td = discs
    mus = tmor.sample_uniformly(td.problem.parameter_type, 0.1, 1.0, 5)
    full = tmor.greedy_rb(td, mus, target_error=0.0, max_extensions=4)
    ckpt = str(tmp_path / "greedy_state")
    part = tmor.greedy_rb(td, mus, target_error=0.0, max_extensions=2, checkpoint_path=ckpt)
    assert part.extensions == 2
    resumed = tmor.greedy_rb(td, mus, target_error=0.0, max_extensions=4,
                             checkpoint_path=ckpt, verbose=True)
    assert resumed.extensions == full.extensions == 4
    np.testing.assert_allclose(resumed.basis.numpy(), full.basis.numpy(), atol=1e-12)
    assert ([m["diffusion_factor"].tolist() for m in resumed.selected_mus]
            == [m["diffusion_factor"].tolist() for m in full.selected_mus])
    np.testing.assert_allclose(resumed.max_errors, full.max_errors, rtol=1e-12)


@pytest.mark.parametrize("coercive", [False, True])
def test_batch_matches_loop_and_reference(coercive, discs, training, greedies):
    jd, td = discs
    jtr, ttr = training
    jres, tres = greedies["riesz"]
    mu_bar = np.ones(4)
    jc = tc = None
    if coercive:
        jc = jmor.min_theta_coercivity(jd.get_operator(), jd.problem.parse_parameter(mu_bar))
        tc = tmor.min_theta_coercivity(td.get_operator(), td.problem.parse_parameter(mu_bar))
    jon = jmor.RieszResidualEstimator(jd, coercivity=jc).offline(jres.basis)
    ton = tmor.RieszResidualEstimator(td, coercivity=tc).offline(tres.basis)
    jst, tst = jbatch.stack_parameters(jd.problem, jtr), tbatch.stack_parameters(td.problem, ttr)
    np.testing.assert_array_equal(tst["diffusion_factor"].numpy(),
                                  np.asarray(jst["diffusion_factor"]))
    coefs = tbatch.batched_reduced_solve(tres.reduced_model, tst)
    _close(coefs, np.stack([tres.reduced_model.solve(mu).numpy() for mu in ttr]), 1e-10, "loop")
    _close(coefs, jbatch.batched_reduced_solve(jres.reduced_model, jst), 1e-10, "reference")
    tco = jco = None
    if coercive:
        tco = np.asarray([float(tc(td.problem.parse_parameter(mu))) for mu in ttr])
        jco = np.asarray([float(jc(jd.problem.parse_parameter(mu))) for mu in jtr])
    etas = tbatch.batched_estimates(ton, tres.reduced_model, tst, tco)
    assert isinstance(etas, np.ndarray) and etas.shape == (len(ttr),)
    _close(etas, [ton.estimate(mu, tres.reduced_model.solve(mu)) for mu in ttr], 1e-10, "loop")
    _close(etas, jbatch.batched_estimates(jon, jres.reduced_model, jst, jco), 1e-10, "reference")


def test_io_roundtrip_and_cross_package(discs, training, greedies, tmp_path):
    jres, tres = greedies[False]
    jtr, ttr = training
    trm, jrm = tres.reduced_model, jres.reduced_model
    path = tio.save_reduced_model(trm, str(tmp_path / "port_model"))
    back = tio.load_reduced_model(path, device="cpu")
    for name in ("op_mats", "rhs_vecs", "basis"):
        assert torch.equal(getattr(back, name), getattr(trm, name)), name
    assert all(torch.equal(back.products[k], trm.products[k]) for k in trm.products)
    assert all(torch.equal(back.solve(mu), trm.solve(mu)) for mu in ttr)
    # the port's file in the reference, the reference's file in the port
    jback = jio.load_reduced_model(path)
    jpath = jio.save_reduced_model(jrm, str(tmp_path / "reference_model"))
    tback = tio.load_reduced_model(jpath, device="cpu")
    converted = reduced_model_from_numpy(
        np.asarray(jrm.op_mats), jrm.op_coeffs, np.asarray(jrm.rhs_vecs), jrm.rhs_coeffs,
        np.asarray(jrm.basis), {k: np.asarray(v) for k, v in jrm.products.items()},
        device="cpu")
    for jmu, tmu in zip(jtr, ttr):
        want = np.asarray(jrm.solve(jmu))
        _close(jback.solve(jmu), trm.solve(tmu), 1e-10, "port file in the reference")
        _close(tback.solve(tmu), want, 1e-10, "reference file in the port")
        _close(converted.solve(tmu), want, 1e-10, "reduced_model_from_numpy")
        _close(converted.reconstruct(converted.solve(tmu)), jrm.reconstruct(jrm.solve(jmu)),
               1e-10, "reconstruct")
    assert sorted(converted.products) == sorted(jrm.products)
