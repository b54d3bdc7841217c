"""The ESV2007 estimators of the PyTorch port against the JAX package's
(x64, CPU):

* ESV2007 ALU-conforming levels 0-1, the same u (the reference's direct
  solve, as numpy) into both packages' building blocks and every estimator
  type, global and local: 1e-12 relative (the three-operand einsums may
  contract in another order);
* the port's own solve against the published table (rel 7e-3) and
  efficiencies (rel 1e-2), test/linearelliptic-swipdg-expectations_
  esv2007_2daluconform.cxx:38-57;
* the reference's own estimator tests, ported;
* the 2x2 thermalblock at 2 and 4 bisections under the "frozen" and
  "scheme" reconstructions and the scheme's fixed weights, with mu_hat, on
  eta_DF_star and eta_ESV2007; local conservation under the reconstruction
  that equals each scheme's assembled flux.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import estimators as je  # noqa: E402
from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.functions import freeze_function as j_freeze  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.ops import cell_quadrature as j_cell_quadrature  # noqa: E402
from dune_hdd_tpu.testcases import ESV2007TestCase as JTC  # noqa: E402
from dune_hdd_tpu_torch import estimators as te  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.functions.base import freeze_function as t_freeze  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.ops.assembly import cell_quadrature  # noqa: E402
from dune_hdd_tpu_torch.ops.norms import error_norms  # noqa: E402
from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase as TTC  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TYPES = ["eta_NC_ESV2007", "eta_R_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007", "eta_DF_star",
         "eta_ESV2007", "eta_ESV2007_alt"]
EXPECTED = {  # the published table, levels 0-1
    "eta_NC_ESV2007": [1.66e-1, 7.89e-2],
    "eta_R_ESV2007": [7.23e-2, 1.82e-2],
    "eta_DF_ESV2007": [3.55e-1, 1.76e-1],
    "eta_ESV2007": [4.49e-01, 2.07e-01],
    "eta_ESV2007_alt": [5.93e-01, 2.73e-01],
}
EFFICIENCY = [1.37, 1.28]


_BUILT = {}


def _esv(level):
    """(port discretization, reference discretization, reference u as numpy,
    port test case), built once per level."""
    if level not in _BUILT:
        jtc, ttc = JTC(num_refinements=1), TTC(num_refinements=1)
        jd = JD(jtc.level_grid(level), jtc.boundary_info(), jtc.problem)
        d = TD(ttc.level_grid(level), ttc.boundary_info(), ttc.problem, device="cpu")
        u = np.array(jd.solve(options={"type": "direct"}))
        _BUILT[level] = (d, jd, u, ttc)
    return _BUILT[level]


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


def _functions(problem, freeze):
    return tuple(freeze(getattr(problem, n)) for n in ("diffusion_factor", "diffusion_tensor",
                                                       "force", "dirichlet"))


@pytest.mark.parametrize("level", [0, 1])
def test_building_blocks_match_reference(level):
    d, jd, u, _ = _esv(level)
    ut = torch.as_tensor(u)
    grid, jgrid = d.space.grid, jd.space.grid
    dv = d.boundary_info.dirichlet_vertices
    _close(te.oswald_interpolation(d.space, ut, dv),
           je.oswald_interpolation(jd.space, jnp.asarray(u), dv))
    _close(te.oswald_interpolation_nodal(d.space, ut, d.boundary_info),
           je.oswald_interpolation_nodal(jd.space, jnp.asarray(u), jd.boundary_info))
    lam, kap, _, g_d = _functions(d.problem, t_freeze)
    jlam, jkap, _, jg_d = _functions(jd.problem, j_freeze)
    _close(te.min_diffusion_eigenvalue(lam, kap, grid, device="cpu"),
           je.min_diffusion_eigenvalue(jlam, jkap, jgrid))
    fb = np.nonzero(d.boundary_info.dirichlet_faces)[0]
    none = np.zeros(0, dtype=np.int64)
    flux = te.rt0_flux_reconstruction(d.space, ut, lam, kap, fb, none, g_d)
    jflux = je.rt0_flux_reconstruction(jd.space, jnp.asarray(u), jlam, jkap, fb, none, jg_d)
    _close(flux, jflux)
    _close(te.rt0_divergence(grid, flux), je.rt0_divergence(jgrid, jflux))
    qp, _ = cell_quadrature(grid, 4, "cpu")
    jqp, _ = j_cell_quadrature(jgrid, 4)
    _close(te.rt0_evaluate(grid, flux, qp), je.rt0_evaluate(jgrid, jflux, jqp))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("type_", TYPES)
def test_estimates_match_reference(level, type_):
    d, jd, u, _ = _esv(level)
    est = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, torch.as_tensor(u),
                                       type_)
    ref = je.SWIPDGEstimators.estimate(jd.space, jd.boundary_info, jd.problem, jnp.asarray(u),
                                       type_)
    assert isinstance(est, float)
    assert est == pytest.approx(ref, rel=1e-12, abs=0)


@pytest.mark.parametrize("type_", ["eta_NC_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007",
                                   "eta_ESV2007"])
def test_estimate_local_matches_reference(type_):
    d, jd, u, _ = _esv(1)
    loc = te.SWIPDGEstimators.estimate_local(d.space, d.boundary_info, d.problem,
                                             torch.as_tensor(u), type_)
    assert isinstance(loc, np.ndarray)
    _close(loc, je.SWIPDGEstimators.estimate_local(jd.space, jd.boundary_info, jd.problem,
                                                   jnp.asarray(u), type_))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("type_", list(EXPECTED) + ["eff_ESV2007"])
def test_port_matches_published_table(level, type_):
    """The port's own solve, against the published estimates and efficiency."""
    d, _, _, tc = _esv(level)
    u = d.solve(options={"type": "direct"})
    if type_ == "eff_ESV2007":
        eta = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, u, "eta_ESV2007")
        eff = eta / error_norms(d.space, u, tc.exact_solution)["H1_semi"]
        assert eff == pytest.approx(EFFICIENCY[level], rel=1e-2)
    else:
        est = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, u, type_)
        assert est == pytest.approx(EXPECTED[type_][level], rel=7e-3)


def test_rt0_locally_conservative():
    """div t_h == P0 f (local conservation of the SWIPDG flux)."""
    d, _, _, _ = _esv(0)
    u = d.solve(options={"type": "direct"})
    lam, kap, force, _ = _functions(d.problem, t_freeze)
    grid = d.space.grid
    fb = np.nonzero(d.boundary_info.dirichlet_faces)[0]
    mean_flux = te.rt0_flux_reconstruction(d.space, u, lam, kap, fb, np.zeros(0, dtype=int))
    div = te.rt0_divergence(grid, mean_flux)
    qp, qw = cell_quadrature(grid, 6, "cpu")
    p0f = torch.sum(qw * force(qp), dim=1) / torch.as_tensor(grid.cell_volumes)
    np.testing.assert_allclose(div.numpy(), p0f.numpy(), rtol=1e-5)


def test_oswald_preserves_continuous():
    """The Oswald average of an interior-continuous DG function is its
    vertex values."""
    d, _, _, _ = _esv(0)
    grid = d.space.grid
    lin = 2.0 * grid.vertices[:, 0] + 0.5 * grid.vertices[:, 1]
    u_dg = torch.as_tensor(lin)[torch.as_tensor(grid.cells.astype(np.int64))].reshape(-1)
    osw = te.oswald_interpolation(d.space, u_dg, np.zeros(grid.num_vertices, dtype=bool))
    np.testing.assert_allclose(osw.numpy(), lin, atol=1e-12)


def test_estimate_local_normalised():
    d, _, u, _ = _esv(0)
    loc = te.SWIPDGEstimators.estimate_local(d.space, d.boundary_info, d.problem,
                                             torch.as_tensor(u), "eta_ESV2007")
    assert loc.shape == (d.space.grid.num_cells,)
    assert np.sum(loc) == pytest.approx(1.0, rel=1e-12)
    assert (loc >= 0).all()


def test_unknown_estimator_rejected():
    d, jd, u, _ = _esv(0)
    with pytest.raises(ValueError):
        te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, torch.as_tensor(u),
                                     "eta_bogus")
    # the RT1 reconstruction (the P2 estimators' flux) equals the reference's
    lam, kap, force, g_d = _functions(d.problem, t_freeze)
    jlam, jkap, jforce, jg_d = _functions(jd.problem, j_freeze)
    fb = np.nonzero(d.boundary_info.dirichlet_faces)[0]
    none = np.zeros(0, dtype=np.int64)
    _close(te.rt1_flux_reconstruction(d.space, torch.as_tensor(u), lam, kap, fb, none, g_d,
                                      force_fn=force),
           je.rt1_flux_reconstruction(jd.space, jnp.asarray(u), jlam, jkap, fb, none, jg_d,
                                      force_fn=jforce), rel=1e-10)


MU = np.array([0.1, 1.0, 0.5, 0.3])
MU_HAT = np.array([1.0, 1.0, 1.0, 1.0])
_THERMALBLOCK = {}


def _thermalblock(bisections):
    """(port space, boundary info, problem; reference's; reference u)."""
    if bisections not in _THERMALBLOCK:
        config = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
        jd = JD(j_grid((0, 0), (1, 1), (4, 4), refinements=bisections), config,
                jp.ThermalblockProblem((2, 2)))
        d = TD(t_grid((0, 0), (1, 1), (4, 4), refinements=bisections), config,
               tp.ThermalblockProblem((2, 2)), device="cpu")
        u = np.array(jd.solve({"diffusion_factor": jnp.asarray(MU)},
                                options={"type": "direct"}))
        _THERMALBLOCK[bisections] = (d, jd, u)
    return _THERMALBLOCK[bisections]


@pytest.mark.parametrize("bisections", [2, 4])
@pytest.mark.parametrize("reconstruction", ["frozen", "scheme", "scheme weights"])
@pytest.mark.parametrize("type_", ["eta_DF_star", "eta_ESV2007"])
def test_thermalblock_matches_reference(bisections, reconstruction, type_):
    """"scheme weights": the frozen reconstruction with the penalty_mu
    scheme's fixed weighting diffusion (``weight_diffusion``)."""
    d, jd, u = _thermalblock(bisections)
    assert d.scheme == jd.scheme == "penalty_mu"  # no affine part: the guard substitutes
    weights = reconstruction == "scheme weights"
    kw = dict(mu={"diffusion_factor": MU}, mu_hat={"diffusion_factor": MU_HAT},
              reconstruction="frozen" if weights else reconstruction,
              weight_diffusion=d._weight_diffusion if weights else None)
    est = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, torch.as_tensor(u),
                                       type_, **kw)
    jkw = dict(kw, mu={"diffusion_factor": jnp.asarray(MU)},
               mu_hat={"diffusion_factor": jnp.asarray(MU_HAT)},
               weight_diffusion=jd._weight_diffusion if weights else None)
    ref = je.SWIPDGEstimators.estimate(jd.space, jd.boundary_info, jd.problem, jnp.asarray(u),
                                       type_, **jkw)
    assert est == pytest.approx(ref, rel=1e-12, abs=0)


@pytest.mark.parametrize("scheme", ["penalty_mu", "reference"])
def test_thermalblock_reconstruction_is_conservative(scheme):
    """div t_h == P0 f at mu when the reconstruction is the assembled
    scheme's flux: the fixed weights for penalty_mu (the 2x2 thermalblock,
    which has no affine part), the per-component parts (reconstruction
    "scheme") for the reference scheme (an affine part of 0.1 added)."""
    problem = tp.ThermalblockProblem((2, 2))
    if scheme == "reference":
        problem.diffusion_factor.register_affine_part(tf.ConstantFunction(0.1))
    d = TD(t_grid((0, 0), (1, 1), (4, 4), refinements=4),
           {"type": "stuff.grid.boundaryinfo.alldirichlet"}, problem, device="cpu")
    assert d.scheme == scheme
    mu = {"diffusion_factor": MU}
    u = d.solve(mu, options={"type": "direct"})
    lam, kap, force, g_d = _functions(problem.with_mu(mu), t_freeze)
    grid = d.space.grid
    fb = np.nonzero(d.boundary_info.dirichlet_faces)[0]
    if scheme == "reference":
        kw = dict(flux_parts=te.scheme_flux_parts(problem, mu))
    else:
        kw = dict(weight_lam_fn=d._weight_diffusion[0], weight_kap_fn=d._weight_diffusion[1])
    flux = te.rt0_flux_reconstruction(d.space, u, lam, kap, fb, np.zeros(0, dtype=int), g_d, **kw)
    qp, qw = cell_quadrature(grid, 6, "cpu")
    p0f = torch.sum(qw * force(qp), dim=1) / torch.as_tensor(grid.cell_volumes)
    np.testing.assert_allclose(te.rt0_divergence(grid, flux).numpy(), p0f.numpy(), rtol=1e-5)
