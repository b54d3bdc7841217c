"""The ESV2007 estimators of the PyTorch port on quads and on P2 against the
JAX package's (x64, CPU), on the reference's direct solution (as numpy) fed
to both packages:

* the Q1 Oswald vertex average and the RT0 reconstruction on rectangles
  (mean fluxes, divergence, the evaluated field) on the level-0 ESV2007
  cube grid (64 quads), and RT0's local conservation div t = P0 f;
* the order-2 Oswald average and the RT1 coefficients, divergence and field
  on the level-0 ESV2007 ALU grid (128 triangles, P2), and RT1's
  div t = Pi_P1 f (its mean and centred first moments, 1e-8);
* every estimator type, global and local, on Q1 quads and P2 triangles;
* Q2 on quads: eta_NC_ESV2007 equals the reference's, and the RT types
  raise NotImplementedError there, as in the reference.

All at 1e-10 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import estimators as je  # noqa: E402
from dune_hdd_tpu.discretizations import SWIPDGDiscretization as JD  # noqa: E402
from dune_hdd_tpu.functions import freeze_function as j_freeze  # noqa: E402
from dune_hdd_tpu.ops import cell_quadrature as j_cell_quadrature  # noqa: E402
from dune_hdd_tpu.testcases import ESV2007TestCase as JTC  # noqa: E402
from dune_hdd_tpu_torch import estimators as te  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.functions.base import freeze_function as t_freeze  # noqa: E402
from dune_hdd_tpu_torch.ops.assembly import cell_quadrature  # noqa: E402
from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase as TTC  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TYPES = ["eta_NC_ESV2007", "eta_R_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007", "eta_DF_star",
         "eta_ESV2007", "eta_ESV2007_alt"]
REL = 1e-10


_BUILT = {}


def _case(variant, order):
    """(port discretization, reference discretization, reference u as numpy)
    on ESV2007 level 0 of ``variant``."""
    key = (variant, order)
    if key not in _BUILT:
        ttc, jtc = TTC(0, grid_variant=variant), JTC(0, grid_variant=variant)
        d = TD(ttc.level_grid(0), ttc.boundary_info(), ttc.problem, order=order,
               only_these_products=(), device="cpu")
        jd = JD(jtc.level_grid(0), jtc.boundary_info(), jtc.problem, order=order,
                only_these_products=())
        _BUILT[key] = (d, jd, np.array(jd.solve(options={"type": "direct"})))
    return _BUILT[key]


def _close(a, b, rel=REL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


def _functions(problem, freeze):
    return tuple(freeze(getattr(problem, n)) for n in ("diffusion_factor", "diffusion_tensor",
                                                       "force", "dirichlet"))


def _both(d, jd, u):
    """(port functions, reference functions, Dirichlet faces, no faces, u tensor)."""
    return (_functions(d.problem, t_freeze), _functions(jd.problem, j_freeze),
            np.nonzero(d.boundary_info.dirichlet_faces)[0], np.zeros(0, dtype=np.int64),
            torch.as_tensor(u))


def test_quad_oswald_and_rt0():
    d, jd, u = _case("cube", 1)
    grid, jgrid = d.space.grid, jd.space.grid
    assert grid.cell_type == "quad"
    (lam, kap, force, g_d), (jlam, jkap, _, jg_d), fb, none, ut = _both(d, jd, u)
    dv = d.boundary_info.dirichlet_vertices
    _close(te.oswald_interpolation(d.space, ut, dv),
           je.oswald_interpolation(jd.space, jnp.asarray(u), dv))
    _close(te.oswald_interpolation_nodal(d.space, ut, d.boundary_info),
           je.oswald_interpolation_nodal(jd.space, jnp.asarray(u), jd.boundary_info))
    flux = te.rt0_flux_reconstruction(d.space, ut, lam, kap, fb, none, g_d)
    jflux = je.rt0_flux_reconstruction(jd.space, jnp.asarray(u), jlam, jkap, fb, none, jg_d)
    _close(flux, jflux)
    div = te.rt0_divergence(grid, flux)
    _close(div, je.rt0_divergence(jgrid, jflux))
    qp, qw = cell_quadrature(grid, 4, "cpu")
    _close(te.rt0_evaluate(grid, flux, qp),
           je.rt0_evaluate(jgrid, jflux, j_cell_quadrature(jgrid, 4)[0]))
    # local conservation on rectangles: div t = P0 f
    qp6, qw6 = cell_quadrature(grid, 6, "cpu")
    p0f = torch.sum(qw6 * force(qp6), dim=1) / torch.as_tensor(grid.cell_volumes)
    np.testing.assert_allclose(div.numpy(), p0f.numpy(), rtol=1e-5)


def test_order2_oswald_and_rt1():
    d, jd, u = _case("alu_conforming", 2)
    grid, jgrid = d.space.grid, jd.space.grid
    (lam, kap, force, g_d), (jlam, jkap, jforce, jg_d), fb, none, ut = _both(d, jd, u)
    _close(te.oswald_interpolation_nodal(d.space, ut, d.boundary_info),
           je.oswald_interpolation_nodal(jd.space, jnp.asarray(u), jd.boundary_info))
    coeffs = te.rt1_flux_reconstruction(d.space, ut, lam, kap, fb, none, g_d, force_fn=force)
    jcoeffs = je.rt1_flux_reconstruction(jd.space, jnp.asarray(u), jlam, jkap, fb, none, jg_d,
                                         force_fn=jforce)
    _close(coeffs, jcoeffs)
    qp, qw = cell_quadrature(grid, 5, "cpu")
    jqp, _ = j_cell_quadrature(jgrid, 5)
    _close(te.rt1_evaluate(grid, coeffs, qp), je.rt1_evaluate(jgrid, jcoeffs, jqp))
    div = te.rt1_divergence_at(grid, coeffs, qp)
    _close(div, je.rt1_divergence_at(jgrid, jcoeffs, jqp))
    # div t_h = Pi_P1 f on the direct solution: the residual f - div t is
    # L2-orthogonal to 1 (the scheme's local conservation) and to the centred
    # x - c_T, y - c_T (the construction's interior moments) on every cell
    qp, qw = cell_quadrature(grid, 6, "cpu")
    f = force(qp)
    div = te.rt1_divergence_at(grid, coeffs, qp)
    centred = qp - torch.as_tensor(grid.cell_centroids)[:, None, :]
    for w in (torch.ones_like(f), centred[..., 0], centred[..., 1]):
        defect = torch.sum(qw * (f - div) * w, dim=1).abs() / torch.sum(
            qw * (f.abs() + div.abs()) * w.abs(), dim=1)
        assert float(defect.max()) < 1e-8


@pytest.mark.parametrize("variant,order", [("cube", 1), ("alu_conforming", 2)])
@pytest.mark.parametrize("type_", TYPES)
def test_every_type_matches_reference(variant, order, type_):
    d, jd, u = _case(variant, order)
    est = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, torch.as_tensor(u),
                                       type_)
    ref = je.SWIPDGEstimators.estimate(jd.space, jd.boundary_info, jd.problem,
                                       jnp.asarray(u), type_)
    assert est == pytest.approx(ref, rel=REL)
    if type_ == "eta_ESV2007_alt":  # a sum of global norms has no local form, as in the reference
        with pytest.raises(ValueError):
            te.SWIPDGEstimators.estimate_local(d.space, d.boundary_info, d.problem,
                                               torch.as_tensor(u), type_)
    else:
        _close(te.SWIPDGEstimators.estimate_local(d.space, d.boundary_info, d.problem,
                                                  torch.as_tensor(u), type_),
               je.SWIPDGEstimators.estimate_local(jd.space, jd.boundary_info, jd.problem,
                                                  jnp.asarray(u), type_))


def test_q2_quad_eta_nc_works_rt_types_raise():
    d, jd, u = _case("cube", 2)
    est = te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, torch.as_tensor(u),
                                       "eta_NC_ESV2007")
    ref = je.SWIPDGEstimators.estimate(jd.space, jd.boundary_info, jd.problem,
                                       jnp.asarray(u), "eta_NC_ESV2007")
    assert np.isfinite(est) and est > 0
    assert est == pytest.approx(ref, rel=REL)
    for type_ in ("eta_R_ESV2007_*", "eta_DF_ESV2007", "eta_ESV2007"):
        with pytest.raises(NotImplementedError):
            te.SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem,
                                         torch.as_tensor(u), type_)
