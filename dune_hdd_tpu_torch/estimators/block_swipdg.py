"""OS2014 localized a-posteriori estimators for BlockSWIPDG.

Counterpart of ``dune_hdd_tpu/estimators/block_swipdg.py``, on the block
discretization's device:

* eta_NC_OS2014: the ESV2007 nonconformity at mu_bar;
* eta_R_OS2014: the subdomain residual ||f - P0 f||^2 weighted by
  C_P diam(Omega_j)^2 / (the subdomain's least diffusion over
  {mu_min, mu_max});
* eta_R_OS2014_*: the same weighting of ||f - div t_h||^2, t_h the RT0 flux
  reconstruction at mu;
* eta_DF_OS2014 / eta_DF_OS2014_*: the ESV2007 diffusive flux with
  (mu, mu_hat), the star variant weighting the gradient with lambda(mu);
* eta_OS2014 / eta_OS2014_*: (1/sqrt(alpha_bar)) (sqrt(gamma_bar) eta_NC +
  eta_R + gamma_tilde eta_DF) with gamma_tilde = max(sqrt(gamma_hat),
  1/sqrt(alpha_hat)) (plain) or 1/sqrt(alpha_hat) (star); alpha/gamma are
  ``coefficient_bounds`` of the diffusion factor.

Per-cell values reduce by subdomain through the multiscale grid's padded
gather table and a row sum (or min): deterministic on every device.  One
estimate computes the RT0 reconstruction once for eta_R_* and eta_DF.
``estimate_local`` gives the per-subdomain indicators: 3/sqrt(alpha_bar)
(sqrt(gamma_bar) NC_j^2 + R_j^2 + gamma_tilde DF_j^2) / eta^2 for
eta_OS2014, sqrt(3/sqrt(alpha_bar) (sqrt(gamma_bar) NC_j^2 + R*_j^2 +
sqrt(alpha_hat) DF*_j^2)) (not normalized) for eta_OS2014_*, and the
normalized squares of the other types.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..affine import coefficient_bounds
from ..functions.base import freeze_function
from ..grid.multiscale import MultiscaleGrid
from ..ops.assembly import cell_quadrature
from .swipdg import (
    POINCARE,
    SWIPDGEstimators,
    _on,
    rt0_divergence,
    rt0_flux_reconstruction,
    scheme_flux_parts,
)

__all__ = ["BlockSWIPDGEstimators", "by_subdomain"]


def by_subdomain(values: torch.Tensor, ms_grid: MultiscaleGrid, reduce: str = "sum"
                 ) -> torch.Tensor:
    """Per-cell values [NC] -> per-subdomain sums (or minima) [S]: one
    gather through the padded cell table and one row reduction."""
    table = _on(ms_grid, "subdomain_table", lambda: ms_grid.subdomain_table, values.device)
    pad = 0.0 if reduce == "sum" else math.inf
    rows = torch.cat([values, values.new_full((1,), pad)])[table]
    return rows.sum(dim=1) if reduce == "sum" else rows.amin(dim=1)


class BlockSWIPDGEstimators:
    @staticmethod
    def available() -> List[str]:
        return ["eta_NC_OS2014", "eta_R_OS2014", "eta_R_OS2014_*", "eta_DF_OS2014",
                "eta_DF_OS2014_*", "eta_OS2014", "eta_OS2014_*"]

    available_local = available

    # ------------------------------------------------------------------
    @classmethod
    def _component_subdomain_squares(cls, block_disc, u, type_, parameters,
                                     cache: Optional[dict] = None) -> torch.Tensor:
        """Per-subdomain squared contributions [S] of one component;
        ``cache`` (a dict shared by the calls of one estimate) keeps the RT0
        mean flux at mu after its first use."""
        space = block_disc.space
        bi = block_disc.boundary_info
        problem = block_disc.problem
        ms = block_disc.ms_grid
        cache = {} if cache is None else cache
        p = dict(parameters or {})
        mu = p.get("mu")
        mu_bar = p.get("mu_bar", mu)
        mu_hat = p.get("mu_hat", mu)
        mu_min = p.get("parameter_range_min")
        mu_max = p.get("parameter_range_max")
        # "frozen" (the reference estimator's mu-frozen diffusion, default)
        # or "scheme" (the theta-combined per-component flux)
        recon = p.get("reconstruction", "frozen")
        # a penalty_mu-scheme discretization assembles with fixed weights:
        # the consistent reconstruction uses the same pair
        wdiff = block_disc._global._weight_diffusion if block_disc._scheme == "penalty_mu" \
            else None
        if problem.parametric() and mu is None:
            raise ValueError("parameters are missing 'mu'")

        if type_ == "eta_NC_OS2014":
            return by_subdomain(SWIPDGEstimators._local_squared(
                space, bi, problem, u, "eta_NC_ESV2007", mu=mu_bar), ms)
        if type_ in ("eta_DF_OS2014", "eta_DF_OS2014_*"):
            local = "eta_DF_star" if type_.endswith("_*") else "eta_DF_ESV2007"
            return by_subdomain(SWIPDGEstimators._local_squared(
                space, bi, problem, u, local, mu=mu, mu_hat=mu_hat, reconstruction=recon,
                weight_diffusion=wdiff, cache=cache), ms)
        if type_ not in ("eta_R_OS2014", "eta_R_OS2014_*"):
            raise ValueError(f"unknown estimator {type_!r}; available: {cls.available()}")

        if problem.parametric() and (mu_min is None or mu_max is None):
            raise ValueError("parameters are missing 'parameter_range_min'/'parameter_range_max'")
        grid, dev, dt = space.grid, space.device, space.dtype
        frozen_mu = problem.with_mu(mu) if problem.parametric() else problem
        force = freeze_function(frozen_mu.force)
        qp, qw = cell_quadrature(grid, max(force.order + 1, 4), dev, dt)
        f_q = force(qp)
        if type_ == "eta_R_OS2014":
            vol = _on(grid, "cell_volumes", lambda: grid.cell_volumes, dev, dt)
            proj = torch.sum(qw * f_q, dim=1) / vol  # per-cell P0 projection
        else:
            if "mean_flux" not in cache:
                lam = freeze_function(frozen_mu.diffusion_factor)
                kap = freeze_function(frozen_mu.diffusion_tensor)
                wlam, wkap = wdiff if wdiff is not None else (lam, kap)
                parts = (scheme_flux_parts(problem, mu)
                         if recon == "scheme" and problem.parametric() else None)
                cache["mean_flux"] = rt0_flux_reconstruction(
                    space, u, lam, kap, np.nonzero(bi.dirichlet_faces)[0],
                    np.nonzero(bi.neumann_faces)[0], freeze_function(frozen_mu.dirichlet),
                    freeze_function(frozen_mu.neumann), weight_lam_fn=wlam, weight_kap_fn=wkap,
                    flux_parts=parts)
            proj = rt0_divergence(grid, cache["mean_flux"])
        resid_sub = by_subdomain(torch.sum(qw * (f_q - proj[:, None]) ** 2, dim=1), ms)
        # least diffusion per cell over {mu_min, mu_max}: min lambda times the
        # least eigenvalue of kappa (closed form for the symmetric 2x2)
        min_diff = None
        for m in ([mu_min, mu_max] if problem.parametric() else [None]):
            fr = problem.with_mu(m) if problem.parametric() else problem
            lam_vals = freeze_function(fr.diffusion_factor)(qp)
            kq = freeze_function(fr.diffusion_tensor)(qp)
            a, b = kq[..., 0, 0], kq[..., 0, 1]
            c, d = kq[..., 1, 0], kq[..., 1, 1]
            disc = torch.sqrt(torch.clamp((a - d) ** 2 + 4 * b * c, min=0.0))
            kmin = torch.amin(0.5 * (a + d - disc), dim=1)
            cand = torch.amin(lam_vals, dim=1) * kmin
            min_diff = cand if min_diff is None else torch.minimum(min_diff, cand)
        diam = _on(ms, "diameters", lambda: [ms.subdomain_diameter(s) for s in range(ms.size())],
                   dev, dt)
        return (POINCARE * diam**2 / by_subdomain(min_diff, ms, "min")) * resid_sub

    # ------------------------------------------------------------------
    @classmethod
    def _factors(cls, problem, parameters):
        """(alpha_bar, gamma_bar, alpha_hat, gamma_hat) of the diffusion
        factor at (mu, mu_bar) and (mu, mu_hat); all 1 if nonparametric."""
        if not problem.parametric():
            return 1.0, 1.0, 1.0, 1.0
        p = dict(parameters)
        mu = problem.parse_parameter(p["mu"])
        mu_bar = problem.parse_parameter(p["mu_bar"])
        mu_hat = problem.parse_parameter(p["mu_hat"])
        a_bar, g_bar = coefficient_bounds(problem.diffusion_factor, mu, mu_bar)
        a_hat, g_hat = coefficient_bounds(problem.diffusion_factor, mu, mu_hat)
        return float(a_bar), float(g_bar), float(a_hat), float(g_hat)

    @classmethod
    def _combined_parts(cls, block_disc, u, star: bool, parameters):
        """The (NC, R, DF) per-subdomain squares of eta_OS2014 (or its star
        variant), sharing one RT0 reconstruction."""
        cache: dict = {}
        suffix = "_*" if star else ""
        return [cls._component_subdomain_squares(block_disc, u, t, parameters, cache)
                for t in ("eta_NC_OS2014", "eta_R_OS2014" + suffix, "eta_DF_OS2014" + suffix)]

    @classmethod
    def estimate(cls, block_disc, u, type_, parameters: Optional[Dict] = None) -> float:
        parameters = dict(parameters or {})
        if type_ in ("eta_OS2014", "eta_OS2014_*"):
            star = type_.endswith("_*")
            a_bar, g_bar, a_hat, g_hat = cls._factors(block_disc.problem, parameters)
            df_factor = (1.0 / math.sqrt(a_hat) if star
                         else max(math.sqrt(g_hat), 1.0 / math.sqrt(a_hat)))
            nc, r, df = cls._combined_parts(block_disc, u, star, parameters)
            return (1.0 / math.sqrt(a_bar)) * (
                math.sqrt(g_bar) * float(torch.sqrt(torch.sum(nc)))
                + float(torch.sqrt(torch.sum(r)))
                + df_factor * float(torch.sqrt(torch.sum(df))))
        vals = cls._component_subdomain_squares(block_disc, u, type_, parameters)
        return float(torch.sqrt(torch.sum(vals)))

    @classmethod
    def visualize(cls, block_disc, u, type_, filename: str,
                  parameters: Optional[Dict] = None) -> str:
        """Write the per-subdomain indicators as a subdomain-constant cell
        field named after the type; returns the written path."""
        from ..utils.vtk import write_cell_data_vtu

        ind = cls.estimate_local(block_disc, u, type_, parameters)
        return write_cell_data_vtu(block_disc.ms_grid.grid,
                                   {type_: ind[block_disc.ms_grid.subdomain_of]}, filename)

    @classmethod
    def estimate_local(cls, block_disc, u, type_, parameters: Optional[Dict] = None
                       ) -> np.ndarray:
        """Per-subdomain indicators [S] (see the module docstring)."""
        parameters = dict(parameters or {})
        if type_ in ("eta_OS2014", "eta_OS2014_*"):
            star = type_.endswith("_*")
            a_bar, g_bar, a_hat, g_hat = cls._factors(block_disc.problem, parameters)
            nc, r, df = cls._combined_parts(block_disc, u, star, parameters)
            if star:
                indicators = torch.sqrt((3.0 / math.sqrt(a_bar))
                                        * (math.sqrt(g_bar) * nc + r + math.sqrt(a_hat) * df))
                return indicators.cpu().numpy()
            gamma_tilde = max(math.sqrt(g_hat), 1.0 / math.sqrt(a_hat))
            indicators = (3.0 / math.sqrt(a_bar)) * (math.sqrt(g_bar) * nc + r + gamma_tilde * df)
            eta_sq = ((1.0 / math.sqrt(a_bar)) * (
                math.sqrt(g_bar) * float(torch.sqrt(torch.sum(nc)))
                + float(torch.sqrt(torch.sum(r)))
                + gamma_tilde * float(torch.sqrt(torch.sum(df))))) ** 2
            return (indicators / eta_sq).cpu().numpy()
        vals = cls._component_subdomain_squares(block_disc, u, type_, parameters)
        return (vals / torch.sum(vals)).cpu().numpy()
