"""The SPE10 problems and test cases and the SPE10 parametric block case of
the PyTorch port against the JAX package's (x64, CPU), on the synthetic
permeability field:

* the problems' functions at quadrature points (1e-14), the file reader on
  the fixture file, and the four test cases' grids and parameters;
* the 25x5-macro parametric block case of tests/test_spe10_study.py:
  eta_OS2014 and eta_OS2014_* at mu_hat = mu, eta_OS2014 at mu_hat != mu,
  and the star variant's per-subdomain indicators, on the same u (1e-8).

The bench's block provenance check is in test_torch_block_provenance.py.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import bench_harness as jbench  # noqa: E402
from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.estimators.block_swipdg import BlockSWIPDGEstimators as JE  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.functions import spe10 as jspe10  # noqa: E402
from dune_hdd_tpu.functions.base import freeze_function as j_freeze  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.ops import cell_quadrature as j_cell_quadrature  # noqa: E402
from dune_hdd_tpu.problems import Spe10Model1Problem as JP  # noqa: E402
from dune_hdd_tpu.problems.default import DefaultProblem as JDefaultProblem  # noqa: E402
from dune_hdd_tpu.testcases import spe10 as jtc  # noqa: E402
from dune_hdd_tpu.testcases._spe10_channel import CHANNEL  # noqa: E402
from dune_hdd_tpu_torch import bench_harness as tbench  # noqa: E402
from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization as TB  # noqa: E402
from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators as TE  # noqa: E402
from dune_hdd_tpu_torch.functions import spe10 as tspe10  # noqa: E402
from dune_hdd_tpu_torch.functions.base import freeze_function as t_freeze  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.ops.assembly import cell_quadrature  # noqa: E402
from dune_hdd_tpu_torch.problems import Spe10Model1Problem as TP  # noqa: E402
from dune_hdd_tpu_torch.testcases import spe10 as ttc  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FIXTURE = Path(__file__).resolve().parent / "data" / "perm_case1_fixture.dat"
ENTRIES = ("diffusion_factor", "diffusion_tensor", "force", "dirichlet", "neumann")
MUS = {"mu": 0.1, "mu_bar": 0.1, "mu_hat": 0.1, "mu_minimizing": 0.1}
# mu_hat != mu: the plain eta_OS2014 and the star variant differ
MUS_HAT = {"mu": 0.1, "mu_bar": 0.1, "mu_hat": 1.0, "mu_minimizing": 0.1}


def _close(a, b, rel):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


def _points():
    """Cell quadrature points of a 25 x 5 grid at 1 bisection, both sides."""
    tg = t_grid((0, 0), (5, 1), (25, 5), refinements=1)
    jg = j_grid((0, 0), (5, 1), (25, 5), refinements=1)
    return cell_quadrature(tg, 4, "cpu")[0], j_cell_quadrature(jg, 4)[0]


PROBLEM_KW = {
    "model1": {},
    "parametric channel": dict(channel_values=CHANNEL, parametric_channel=True),
    "scaled channel": dict(channel_values=CHANNEL),
    "flat-top channel": dict(channel_values=CHANNEL[:7], channel_boundary_layer=(0.01, 0.02),
                             parametric_channel=True),
}


@pytest.mark.parametrize("kind", sorted(PROBLEM_KW))
def test_spe10_problem_functions_match_reference(kind):
    tp, jp = TP(**PROBLEM_KW[kind]), JP(**PROBLEM_KW[kind])
    assert tp.spe10_field.synthetic and jp.spe10_field.synthetic
    np.testing.assert_array_equal(tp.spe10_field.field, np.asarray(jp.spe10_field.field))
    assert tp.parametric() == jp.parametric()
    assert dict(tp.parameter_type.items()) == dict(jp.parameter_type.items())
    qp, jqp = _points()
    for name in ENTRIES:
        tdec, jdec = getattr(tp, name), getattr(jp, name)
        assert tdec.num_components == jdec.num_components
        for tf, jf in zip(tdec.components + [tdec.affine_part],
                          jdec.components + [jdec.affine_part]):
            _close(tf(qp), jf(jqp), 1e-14)
    if tp.parametric():
        for mu in (0.1, 0.7):
            _close(t_freeze(tp.with_mu(mu).diffusion_factor)(qp),
                   j_freeze(jp.with_mu(jp.parse_parameter(mu)).diffusion_factor)(jqp), 1e-14)


def test_model1_file_reader_matches_reference():
    f = tspe10.Spe10Model1Function(str(FIXTURE))
    assert not f.synthetic
    np.testing.assert_array_equal(f.field, tspe10._read_model1_file(str(FIXTURE)))
    np.testing.assert_array_equal(f.field, jspe10._read_model1_file(str(FIXTURE)))
    np.testing.assert_array_equal(tspe10._read_model1_file(str(FIXTURE), 0.5, 2.0),
                                  jspe10._read_model1_file(str(FIXTURE), 0.5, 2.0))
    qp, jqp = _points()
    _close(f(qp), jspe10.Spe10Model1Function(str(FIXTURE))(jqp), 1e-14)
    with pytest.raises(ValueError, match="max > min"):
        tspe10._read_model1_file(str(FIXTURE), 2.0, 1.0)
    np.testing.assert_array_equal(tspe10._synthetic_model1_field(),
                                  jspe10._synthetic_model1_field())


_CASES = {}


def _testcases(name, **args):
    """(port test case, reference test case), built once per arguments."""
    key = (name, repr(sorted(args.items())))
    if key not in _CASES:
        _CASES[key] = getattr(ttc, name)(**args), getattr(jtc, name)(**args)
    return _CASES[key]


@pytest.mark.parametrize("name,args", [
    ("Spe10Model1TestCase", dict(num_refinements=1, num_elements=(25, 5))),
    ("Spe10BlockModel1TestCase", dict(num_refinements=0)),
    ("Spe10ParametricModel1TestCase", dict(parameters=MUS, num_refinements=0)),
    ("Spe10ParametricBlockModel1TestCase", dict(parameters=MUS, num_refinements=0,
                                                num_partitions=(5, 1))),
])
def test_spe10_testcases_match_reference(name, args):
    t, j = _testcases(name, **args)
    assert (t.name, t.num_refinements, t.reference_level) == (j.name, j.num_refinements,
                                                             j.reference_level)
    assert t.boundary_info() == j.boundary_info() and not t.provides_exact_solution()
    for r in range(t.num_refinements + 1):
        np.testing.assert_array_equal(t.level_grid(r).cells, j.level_grid(r).cells)
        np.testing.assert_array_equal(t.level_grid(r).vertices, j.level_grid(r).vertices)
    if "Block" in name:
        tm, jm = t.ms_grid(0), j.ms_grid(0)
        assert tm.num_partitions == jm.num_partitions == args.get("num_partitions", (20, 4))
        np.testing.assert_array_equal(tm.subdomain_of, jm.subdomain_of)
    if "Parametric" in name:
        pars, jpars = t.estimator_parameters(), j.estimator_parameters()
        assert sorted(pars) == sorted(jpars)
        for key in pars:
            np.testing.assert_array_equal(pars[key]["mu"].numpy(), np.asarray(jpars[key]["mu"]))


def test_spe10_parametric_block_matches_reference():
    """The 25x5-macro parametric block case (5 subdomains, 1,500 DoF) at
    mu = 0.1 on the reference's direct solution, at mu_hat = mu and
    mu_hat != mu, and the port's own solve."""
    tc, jc = _testcases("Spe10ParametricBlockModel1TestCase", parameters=MUS,
                        num_refinements=0, num_partitions=(5, 1))
    td = TB(t_grid((0, 0), (5, 1), (25, 5), refinements=1), tc.boundary_info(), tc.problem,
            num_partitions=(5, 1), device="cpu")
    jd = JB(j_grid((0, 0), (5, 1), (25, 5), refinements=1), jc.boundary_info(), jc.problem,
            num_partitions=(5, 1))
    assert td._scheme == jd._scheme == "penalty_mu"  # the sign-indefinite guard
    assert td.num_subdomains() == 5
    u = np.array(jd.solve(jc.parameters["mu"], options={"type": "direct"}))
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    for mus, types in ((MUS, ("eta_OS2014", "eta_OS2014_*")), (MUS_HAT, ("eta_OS2014",))):
        tcm, jcm = _testcases("Spe10ParametricBlockModel1TestCase", parameters=mus,
                              num_refinements=0, num_partitions=(5, 1))
        pars, jpars = tcm.estimator_parameters(), jcm.estimator_parameters()
        for t in types:
            est = TE.estimate(td, tu, t, pars)
            assert est == pytest.approx(JE.estimate(jd, ju, t, jpars), rel=1e-8), (t, mus)
    pars, jpars = tc.estimator_parameters(), jc.estimator_parameters()
    loc = TE.estimate_local(td, tu, "eta_OS2014_*", pars)
    assert loc.shape == (5,) and (loc > 0).all()
    _close(loc, JE.estimate_local(jd, ju, "eta_OS2014_*", jpars), 1e-8)
    u_port = td.solve(tc.parameters["mu"], options={"type": "block_cg.jacobi",
                                                    "precision": 1e-12, "max_iter": 30000})
    _close(u_port, u, 1e-8)
