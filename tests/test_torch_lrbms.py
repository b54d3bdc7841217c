"""The LRBMS greedy and the pyMOR shim of the PyTorch port against the JAX
package's (x64, CPU), on the 2x2 thermalblock BlockSWIPDG at 2 bisections
(384 DoF) with [2 2] subdomains:

* greedy_lrbms with and without the Riesz estimator, with and without the
  initial basis from the local rhs: the same selections, max_errors,
  reduced solutions, basis and local_bases at 1e-8 (the rhs-initialized
  local bases as spans), every basis row supported on one subdomain;
  final_compression's POD basis (as a span);
* StationaryModelShim and StationaryMultiscaleModelShim: solve, affine
  structure and products against the reference's shim and the native port
  discretization (the checks of tests/pymor_contract.py, carried here
  without its jax import), and the LRBMS surface.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import mor as jmor  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.grid import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.problems import ThermalblockProblem as JTB  # noqa: E402
from dune_hdd_tpu_torch import mor as tmor  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.discretizations.block_swipdg import (  # noqa: E402
    BlockSWIPDGDiscretization as TB,
)
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.mor.pymor_shim import StationaryMultiscaleModelShim  # noqa: E402
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MU = (0.3, 1.0, 0.7, 0.2)  # the contract's parameter


@pytest.fixture(scope="module")
def discs():
    """(reference block discretization, port block discretization)."""
    return (JB(j_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, JTB((2, 2)),
               num_partitions=(2, 2)),
            TB(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)),
               num_partitions=(2, 2), device="cpu"))


@pytest.fixture(scope="module")
def training(discs):
    jd, td = discs
    return (jmor.sample_randomly(jd.parameter_type, 0.1, 1.0, 6, seed=3),
            tmor.sample_randomly(td.parameter_type, 0.1, 1.0, 6, seed=3))


CASES = {  # name -> (use_estimator, initial_basis_from_rhs, final_compression)
    "true_error_compressed": (False, False, True),
    "estimator": (True, False, False),
    "estimator_rhs_init": (True, True, False),
}


@pytest.fixture(scope="module")
def greedies(discs, training):
    """{case: (reference result, port result)}, 2 extensions each."""
    jd, td = discs
    out = {}
    for case, (est, rhs_init, compress) in CASES.items():
        kw = dict(target_error=1e-7, max_extensions=2, use_estimator=est,
                  initial_basis_from_rhs=rhs_init, final_compression=compress)
        out[case] = (jmor.greedy_lrbms(jd, training[0], **kw),
                     tmor.greedy_lrbms(td, training[1], **kw))
    return out


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _mu_index(training, mu):
    return next(i for i, m in enumerate(training)
                if all(np.array_equal(np.asarray(m[k]), np.asarray(mu[k])) for k in m))


def _span_projector(rows: np.ndarray) -> np.ndarray:
    q, _ = np.linalg.qr(rows.T)
    return q @ q.T


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_lrbms_matches_reference(case, discs, training, greedies):
    jd, td = discs
    jres, tres = greedies[case]
    assert tres.extensions == jres.extensions == 2
    assert ([_mu_index(training[1], m) for m in tres.selected_mus]
            == [_mu_index(training[0], m) for m in jres.selected_mus])
    np.testing.assert_allclose(tres.max_errors, jres.max_errors, rtol=1e-8)
    assert len(tres.local_bases) == len(jres.local_bases) == 4
    for ss, (t, j) in enumerate(zip(tres.local_bases, jres.local_bases, strict=True)):
        if CASES[case][1]:
            # the rhs of the 2x2 thermalblock (f = 1) is piecewise constant,
            # in the kernel of the local h1_semi product: gram_schmidt scales
            # it by 1 / (a round-off norm), 1.29e7 here against the
            # reference's 1.43e7, so these bases agree as spans
            _close(_span_projector(t.numpy()), _span_projector(np.asarray(j)), 1e-8,
                   f"local span {ss}")
        else:
            _close(t, j, 1e-8, f"local basis {ss}")
    if CASES[case][2]:
        # final_compression: the POD of the globalized basis; its singular
        # values come in near-equal groups (one per subdomain), whose modes
        # the eigensolvers may rotate, so the modes agree as a span
        assert tres.basis.shape == jres.basis.shape
        _close(_span_projector(tres.basis.numpy()), _span_projector(np.asarray(jres.basis)),
               1e-8, "compressed span")
    else:
        if not CASES[case][1]:
            _close(tres.basis, jres.basis, 1e-8, "basis")
        # block structure: each row supported on one subdomain
        for row in tres.basis.numpy():
            cells = np.nonzero(row)[0] // 3
            assert len({int(td.ms_grid.subdomain_of[c]) for c in cells}) == 1
    for jmu, tmu in zip(*training):
        jrm, trm = jres.reduced_model, tres.reduced_model
        _close(trm.reconstruct(trm.solve(tmu)), jrm.reconstruct(jrm.solve(jmu)), 1e-8, "u_rb")


def test_globalize_rows_are_the_local_bases(discs, greedies):
    _, td = discs
    tres = greedies["estimator_rhs_init"][1]
    rows = iter(tres.basis)
    for ss, lb in enumerate(tres.local_bases):
        dofs = torch.as_tensor(td._local_dof_map(ss))
        for v in lb:
            row = next(rows)
            assert torch.equal(row[dofs], v)
            assert float(row.abs().sum()) == pytest.approx(float(v.abs().sum()), rel=1e-15)


@pytest.fixture(scope="module")
def swipdg():
    return TD(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu")


def test_shim_contract_matches_reference_and_native(swipdg):
    """The contract of tests/pymor_contract.py on the port's shim: solve
    equals the native solve, sum theta_q A_q equals the frozen operator,
    the products act like the native product matrices; and each equals the
    reference shim's."""
    d = swipdg
    m = tmor.as_pymor_model(d)
    assert isinstance(m, tmor.StationaryModelShim) and "pymor_shim" in repr(m)
    assert m.parameters == {"diffusion_factor": 4}
    jd = JD(j_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, JTB((2, 2)))
    jm = jmor.as_pymor_model(jd)
    mu = {"diffusion_factor": np.asarray(MU)}
    u = m.solve(mu, solver_options={"type": "direct"})
    np.testing.assert_array_equal(u.numpy(), d.solve(d.problem.parse_parameter(mu),
                                                     options={"type": "direct"}).numpy())
    _close(u, jm.solve({"diffusion_factor": jnp.asarray(MU)},
                       solver_options={"type": "direct"}), 1e-10, "shim solve")
    # affine structure: one component per theta + the penalty part
    assert m.operator.num_components == jm.operator.num_components == 5
    x = np.random.default_rng(42).standard_normal(d.space.num_dofs)
    mu_p = d.problem.parse_parameter(mu)
    y = sum(float(c(mu_p)) * comp.matvec(torch.as_tensor(x))
            for comp, c in zip(m.operator.components, m.operator.coefficients))
    _close(y, d.freeze_operator(mu_p).matvec(torch.as_tensor(x)), 1e-13, "affine")
    assert sorted(m.products) == sorted(jm.products)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(d.space.num_dofs)
    for name in ("l2", "h1_semi"):
        y = m.products[name].freeze({}).matvec(torch.as_tensor(x))
        np.testing.assert_array_equal(y.numpy(), d.product_matrix(name).matvec(
            torch.as_tensor(x)).numpy())
        _close(y, jm.products[name].freeze({}).matvec(jnp.asarray(x)), 1e-12, name)
    with pytest.raises(NotImplementedError):
        m.output(mu)


def test_multiscale_shim_lrbms_surface(discs):
    jd, td = discs
    m, jm = tmor.as_pymor_model(td), jmor.as_pymor_model(jd)
    assert isinstance(m, StationaryMultiscaleModelShim) and "subdomains=4" in repr(m)
    assert m.num_subdomains() == 4
    assert set(np.asarray(m.neighbouring_subdomains(0)).tolist()) == {1, 2}
    mu = {"diffusion_factor": np.asarray(MU)}
    mu_p = td.problem.parse_parameter(mu)
    jmu_p = jd.problem.parse_parameter({"diffusion_factor": jnp.asarray(MU)})
    for ss in range(4):
        op, jop = m.local_operator(ss), jm.local_operator(ss)
        assert op.num_components == jop.num_components >= 1
        _close(op.freeze(mu_p).to_dense(), jop.freeze(jmu_p).to_dense(), 1e-12, "local op")
        _close(m.local_rhs(ss).freeze(mu_p), jm.local_rhs(ss).freeze(jmu_p), 1e-12, "local rhs")
        n = len(td._local_dof_map(ss))
        assert m.local_product(ss, "h1_semi").freeze({}).shape == (n, n)
    cpl = m.coupling_operator(0, 1)
    assert cpl.num_components >= 1 or cpl.affine_part is not None
    u = m.solve(mu, solver_options={"type": "direct"})
    locs = [m.localize_vector(u, ss) for ss in range(4)]
    np.testing.assert_array_equal(m.globalize_vectors(locs).numpy(), u.numpy())
    # the online enrichment needs oversampling, which this model lacks
    with pytest.raises(ValueError):
        m.solve_for_local_correction(locs, 0, mu)
