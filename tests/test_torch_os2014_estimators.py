"""The OS2014 estimators and the localization study of the PyTorch port
against the JAX package's (x64, CPU):

* ESV2007 level 0 (384 DoF) at [1 1], [2 2] and [8 8]: the same u (the
  reference's direct solve, as numpy) through both packages: every OS2014
  type to 1e-10 relative, ``estimate_local`` and the localization study's
  two distributions likewise;
* the port's own solve against the published level-0 rows (5e-3),
  test/linearelliptic-block-swipdg-expectations_esv2007_2daluconform.cxx;
* the OS2014 parametric [4 4 1] case at level 0: at the four (mu, mu_bar,
  mu_hat) triples, every type and ``estimate_local`` on the reference's
  solution through both packages (1e-10 relative); at (0.1, 0.1, 0.1) and
  (1, 1, 1), the port's own solve against the JAX-recorded values (2e-3) and
  the published ones (3.5e-3 at mu = 1);
* ``visualize`` writes a file that names the type;
* the OS2014 and thermalblock test cases (grids, partitions, estimator
  parameters) and the VTU writers (byte for byte) equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.estimators.block_swipdg import BlockSWIPDGEstimators as JE  # noqa: E402
from dune_hdd_tpu.functions import Testcase1ExactSolution as JExact  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.ops.spaces import cg_space as j_cg  # noqa: E402
from dune_hdd_tpu.ops.spaces import dg_space as j_dg  # noqa: E402
from dune_hdd_tpu.problems import ESV2007Problem as JESV  # noqa: E402
from dune_hdd_tpu.studies.localization import localization_study as j_study  # noqa: E402
from dune_hdd_tpu.testcases import os2014 as jos  # noqa: E402
from dune_hdd_tpu.testcases import thermalblock as jtb  # noqa: E402
from dune_hdd_tpu.utils import vtk as jvtk  # noqa: E402
from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization as TB  # noqa: E402
from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators as TE  # noqa: E402
from dune_hdd_tpu_torch.functions.esv2007 import Testcase1ExactSolution as TExact  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.ops.norms import error_norms  # noqa: E402
from dune_hdd_tpu_torch.ops.spaces import cg_space as t_cg  # noqa: E402
from dune_hdd_tpu_torch.ops.spaces import dg_space as t_dg  # noqa: E402
from dune_hdd_tpu_torch.problems import ESV2007Problem as TESV  # noqa: E402
from dune_hdd_tpu_torch.studies.localization import localization_study  # noqa: E402
from dune_hdd_tpu_torch.testcases import os2014 as tos  # noqa: E402
from dune_hdd_tpu_torch.testcases import thermalblock as ttb  # noqa: E402
from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase  # noqa: E402
from dune_hdd_tpu_torch.utils import vtk as tvtk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
TYPES = TE.available()
# partitioning -> (eta_R_OS2014, eta_OS2014, eff_OS2014) at level 0, published
TABLE = {(1, 1): (5.79e-1, 1.10, 3.35), (2, 2): (2.89e-1, 8.10e-1, 2.47),
         (8, 8): (7.23e-2, 5.93e-1, 1.81)}
COMMON = {"eta_NC_OS2014": 1.66e-01, "eta_DF_OS2014": 3.55e-01, "eta_DF_OS2014_*": 3.55e-01}
# (mu, mu_bar, mu_hat) -> {type: (JAX-recorded level 0, published level 0)},
# studies/expectations.py and test/linearelliptic-block-swipdg-expectations_
# os2014_2daluconform.cxx
PARAMETRIC = {
    (0.1, 0.1, 0.1): {"eta_DF_OS2014": (1.16913, 1.25), "eta_DF_OS2014_*": (1.16913, 1.25),
                      "eta_OS2014": (1.90907, 1.97)},
    (1.0, 1.0, 1.0): {"eta_DF_OS2014": (0.354808, 0.355), "eta_DF_OS2014_*": (0.354808, 0.355),
                      "eta_OS2014": (0.773342, 0.774), "eta_OS2014_*": (0.773342, 0.774)},
}


_BUILT = {}


def _esv(part):
    """(port block discretization, reference's, reference u as numpy)."""
    if part not in _BUILT:
        jd = JB(j_grid((-1, -1), (1, 1), (4, 4), refinements=2), BI, JESV(), num_partitions=part)
        td = TB(t_grid((-1, -1), (1, 1), (4, 4), refinements=2), BI, TESV(), num_partitions=part,
                device="cpu")
        _BUILT[part] = (td, jd, np.array(jd.solve(options={"type": "direct"})))
    return _BUILT[part]


def _close(a, b, rel):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("part", sorted(TABLE))
def test_estimates_match_reference(part):
    td, jd, u = _esv(part)
    for t in TYPES:
        est = TE.estimate(td, torch.as_tensor(u), t)
        assert isinstance(est, float)
        assert est == pytest.approx(JE.estimate(jd, jnp.asarray(u), t), rel=1e-10, abs=0), t


@pytest.mark.parametrize("part", sorted(TABLE))
def test_estimate_local_and_localization_match_reference(part):
    td, jd, u = _esv(part)
    for t in TYPES:
        loc = TE.estimate_local(td, torch.as_tensor(u), t)
        assert isinstance(loc, np.ndarray) and loc.shape == (td.num_subdomains(),)
        _close(loc, JE.estimate_local(jd, jnp.asarray(u), t), 1e-10)
    est, true, corr = localization_study(td, torch.as_tensor(u), TExact(), "eta_OS2014")
    j_est, j_true, j_corr = j_study(jd, jnp.asarray(u), JExact(), "eta_OS2014")
    _close(est, j_est, 1e-10)
    _close(true, j_true, 1e-10)
    assert corr == pytest.approx(j_corr, rel=1e-8, abs=1e-10)
    assert np.sum(true) == pytest.approx(1.0, rel=1e-12)


@pytest.mark.parametrize("part", sorted(TABLE))
def test_port_matches_published_level0(part):
    td, _, _ = _esv(part)
    u = td.solve(options={"type": "direct"})
    ref_r, ref_os, ref_eff = TABLE[part]
    eta_os = TE.estimate(td, u, "eta_OS2014")
    assert TE.estimate(td, u, "eta_R_OS2014") == pytest.approx(ref_r, rel=5e-3)
    assert eta_os == pytest.approx(ref_os, rel=5e-3)
    assert eta_os / error_norms(td.space, u, TExact())["H1_semi"] == pytest.approx(ref_eff,
                                                                                   rel=5e-3)
    for t, ref in COMMON.items():
        assert TE.estimate(td, u, t) == pytest.approx(ref, rel=5e-3), t
    # nonparametric: the star variants coincide with the plain ones
    assert TE.estimate(td, u, "eta_OS2014_*") == pytest.approx(eta_os, rel=1e-12)


_PARAMETRIC_BUILT = {}


def _os2014(mu):
    """(port [4 4 1] OS2014 discretization at level 0, reference's,
    reference u at mu as numpy); the discretizations do not depend on the
    parameters, the solution only on mu."""
    if "d" not in _PARAMETRIC_BUILT:
        mus = {"mu": 1.0, "mu_bar": 1.0, "mu_hat": 1.0, "mu_minimizing": 0.1}
        tc = OS2014MultiscaleTestCase(mus, num_partitions=(4, 4), num_refinements=0)
        jc = jos.OS2014MultiscaleTestCase(mus, num_partitions=(4, 4), num_refinements=0)
        _PARAMETRIC_BUILT["d"] = (
            TB(tc.level_grid(0), tc.boundary_info(), tc.problem, num_partitions=(4, 4),
               device="cpu"),
            JB(jc.level_grid(0), jc.boundary_info(), jc.problem, num_partitions=(4, 4)))
    td, jd = _PARAMETRIC_BUILT["d"]
    if mu not in _PARAMETRIC_BUILT:
        _PARAMETRIC_BUILT[mu] = np.array(jd.solve(jd.problem.parse_parameter(mu),
                                                  options={"type": "direct"}))
    return td, jd, _PARAMETRIC_BUILT[mu]


# (mu, mu_bar, mu_hat): the two with mu_hat == mu and the two where the plain
# and star estimates differ
TRIPLES = [(0.1, 0.1, 0.1), (1.0, 1.0, 1.0), (1.0, 1.0, 0.1), (0.1, 0.1, 1.0)]


@pytest.mark.parametrize("mus", TRIPLES)
def test_os2014_parametric_matches_reference(mus):
    """Every type and estimate_local of the parametric [4 4 1] case at level 0
    on the reference's solution, both packages, to 1e-10 relative: the
    parameter-range diffusion minimum of eta_R, the alpha/gamma factors and
    the plain/star weightings."""
    mu, mu_bar, mu_hat = mus
    td, jd, u = _os2014(mu)
    params = {"mu": mu, "mu_bar": mu_bar, "mu_hat": mu_hat, "mu_minimizing": 0.1}
    pars = tos.OS2014MultiscaleTestCase(params, (4, 4), 0).estimator_parameters()
    jpars = jos.OS2014MultiscaleTestCase(params, (4, 4), 0).estimator_parameters()
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    assert TE._factors(td.problem, pars) == pytest.approx(JE._factors(jd.problem, jpars),
                                                          rel=1e-12, abs=0)
    for t in TYPES:
        est = TE.estimate(td, tu, t, pars)
        assert est == pytest.approx(JE.estimate(jd, ju, t, jpars), rel=1e-10, abs=0), t
        _close(TE.estimate_local(td, tu, t, pars), JE.estimate_local(jd, ju, t, jpars), 1e-10)
    if mu_hat != mu:
        # the plain and star estimates do differ here
        assert TE.estimate(td, tu, "eta_OS2014", pars) != pytest.approx(
            TE.estimate(td, tu, "eta_OS2014_*", pars), rel=1e-2)


@pytest.mark.parametrize("mus", sorted(PARAMETRIC))
def test_os2014_parametric_level0(mus):
    mu, mu_bar, mu_hat = mus
    tc = OS2014MultiscaleTestCase({"mu": mu, "mu_bar": mu_bar, "mu_hat": mu_hat,
                                   "mu_minimizing": 0.1}, num_partitions=(4, 4),
                                  num_refinements=0)
    pars = tc.estimator_parameters()
    d = TB(tc.level_grid(0), tc.boundary_info(), tc.problem, num_partitions=(4, 4), device="cpu")
    assert d._scheme == "reference"
    u = d.solve(tc.parameters["mu"], options={"type": "direct"})
    for t, (recorded, published) in PARAMETRIC[mus].items():
        val = TE.estimate(d, u, t, pars)
        assert val == pytest.approx(recorded, rel=2e-3), t
        if mu == 1.0:
            assert val == pytest.approx(published, rel=3.5e-3), (t, "published")


def test_visualize_writes_the_type(tmp_path):
    td, _, u = _esv((2, 2))
    path = TE.visualize(td, torch.as_tensor(u), "eta_OS2014", str(tmp_path / "ind"))
    text = open(path).read()
    assert path.endswith(".vtu") and 'Name="eta_OS2014"' in text
    assert text.count("<Piece NumberOfPoints") == 1


def test_bad_input_rejected():
    td, _, u = _esv((2, 2))
    with pytest.raises(ValueError, match="unknown estimator"):
        TE.estimate(td, torch.as_tensor(u), "eta_bogus")
    tc = OS2014MultiscaleTestCase({"mu": 1, "mu_bar": 1, "mu_hat": 1, "mu_minimizing": 0.1},
                                  num_partitions=(2, 2), num_refinements=0)
    d = TB(tc.level_grid(0), tc.boundary_info(), tc.problem, num_partitions=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="'mu'"):
        TE.estimate(d, torch.as_tensor(u), "eta_NC_OS2014", {})
    with pytest.raises(ValueError, match="parameter_range"):
        TE.estimate(d, torch.as_tensor(u), "eta_R_OS2014", dict(tc.parameters))


def test_testcases_match_reference():
    mus = {"mu": 0.3, "mu_bar": 0.5, "mu_hat": 1.0, "mu_minimizing": 0.1}
    tmus = {k: [0.1, 1.0, 0.5, 0.3] for k in ("mu", "mu_bar", "mu_hat")}
    pairs = [
        (tos.OS2014TestCase(mus, num_refinements=1), jos.OS2014TestCase(mus, num_refinements=1)),
        (tos.OS2014MultiscaleTestCase(mus, (2, 2), 1, H_with_h=True),
         jos.OS2014MultiscaleTestCase(mus, (2, 2), 1, H_with_h=True)),
        (ttb.ThermalblockTestCase(tmus, num_refinements=1),
         jtb.ThermalblockTestCase(tmus, num_refinements=1)),
        (ttb.BlockThermalblockTestCase(tmus, (2, 2), (4, 1), num_refinements=1),
         jtb.BlockThermalblockTestCase(tmus, (2, 2), (4, 1), num_refinements=1)),
    ]
    for t, j in pairs:
        assert (t.name, t.num_refinements, t.reference_level) == (j.name, j.num_refinements,
                                                                 j.reference_level)
        for r in range(t.num_refinements + 1):
            np.testing.assert_array_equal(t.level_grid(r).cells, j.level_grid(r).cells)
            if hasattr(t, "ms_grid"):
                tm, jm = t.ms_grid(r), j.ms_grid(r)
                assert tm.num_partitions == jm.num_partitions
                np.testing.assert_array_equal(tm.subdomain_of, jm.subdomain_of)
        pars, jpars = t.estimator_parameters(), j.estimator_parameters()
        assert sorted(pars) == sorted(jpars)
        for key in pars:
            for comp in pars[key]:
                np.testing.assert_array_equal(pars[key][comp].numpy(),
                                              np.asarray(jpars[key][comp]))
    assert pairs[1][0].partitioning() == pairs[1][1].partitioning() == "[2 2 1]_H_with_h"
    assert pairs[1][0].ms_grid(1).num_partitions == (4, 4)
    with pytest.raises(ValueError, match="mu_hat"):
        tos.OS2014TestCase({"mu": 1, "mu_bar": 1, "mu_minimizing": 1})


def test_vtk_writers_match_reference(tmp_path):
    td, jd, u = _esv((2, 2))
    grid, jgrid = td.space.grid, jd.space.grid
    cases = [(t_dg(grid, device="cpu"), j_dg(jgrid), u),
             (t_cg(grid, device="cpu"), j_cg(jgrid), np.linspace(0.0, 1.0, grid.num_vertices))]
    for i, (ts, js, values) in enumerate(cases):
        a = tvtk.write_vtu(ts, torch.as_tensor(values), str(tmp_path / f"t{i}"), name="u")
        b = jvtk.write_vtu(js, values, str(tmp_path / f"j{i}"), name="u")
        assert open(a).read() == open(b).read()
    ind = {"eta": np.arange(grid.num_cells, dtype=float)}
    a = tvtk.write_cell_data_vtu(grid, ind, str(tmp_path / "tc.vtu"))
    b = jvtk.write_cell_data_vtu(jgrid, ind, str(tmp_path / "jc.vtu"))
    assert a.endswith("tc.vtu") and open(a).read() == open(b).read()
