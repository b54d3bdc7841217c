"""ESV2007 a-posteriori error estimators for SWIPDG, P1 on triangles, RT0.

Counterpart of ``dune_hdd_tpu/estimators/swipdg.py`` (the reference's
``estimators/swipdg.hh``), on the space's device in its dtype:

* eta_NC_ESV2007: energy norm of u_h - Oswald(u_h), the conforming vertex
  average with zero Dirichlet values;
* eta_R_ESV2007: cutoff_T ||f - P0 f||_T^2, cutoff_T = h_T^2 / (pi^2
  min_eig(lambda kappa)|_T);
* eta_R_ESV2007_*: cutoff_T ||f - div t_h||_T^2 with t_h the RT0 flux
  reconstructed from the SWIPDG numerical flux;
* eta_DF_ESV2007: ||lambda(mu) kappa grad u_h + t_h|| in the
  (lambda(mu_hat) kappa)^{-1} metric (eta_DF_star weights the gradient with
  lambda(mu));
* eta_ESV2007 = sqrt(sum_T [NC_T^2 + (R*_T + DF_T)^2]) and eta_ESV2007_alt =
  sqrt(sum NC^2) + sqrt(sum R*^2) + sqrt(sum DF^2).

``estimate`` returns the global value (a float); ``estimate_local`` the
per-element squared indicators scaled by 1/eta^2 (a numpy array).

The grid tables (cell vertices, face lists, the RT0 sign and length factors)
are copied to the device once per grid and kept on it.  Vertex sums of the
Oswald average go through a host-built padded table of each vertex's
(cell, corner) entries and a row sum: deterministic on every device.  The
quad RT0 and the RT1 branches of the reference (Q1 and P2 spaces) wait for
those spaces (ROADMAP queue 1, slice 2 b and c).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..functions.base import Function, freeze_function
from ..grid.boundaryinfo import BoundaryInfo
from ..grid.structured import TRIANGLE, Grid
from ..ops.assembly import cell_quadrature, cell_shape_gradients, diffusion_pairs, face_quadrature
from ..ops.quadrature import edge_rule
from ..ops.spaces import NOT_PORTED, Space
from ..ops.swipdg import boundary_sigma, default_beta, inner_sigma

__all__ = ["SWIPDGEstimators", "oswald_interpolation", "oswald_interpolation_nodal",
           "rt0_flux_reconstruction", "rt0_evaluate", "rt0_divergence",
           "rt1_flux_reconstruction", "rt1_evaluate", "rt1_divergence_at",
           "min_diffusion_eigenvalue", "scheme_flux_parts"]

POINCARE = 1.0 / (math.pi**2)
_SIDE_EPS = 1e-7  # relative shift of face points towards the cell centroid


def _on(owner, name, build: Callable, device, dtype=torch.float64) -> torch.Tensor:
    """The host table ``build()`` as a tensor on ``device`` (floats in
    ``dtype``), built and copied once per owner (the grid, or the space for
    its DoF maps), name, device and dtype."""
    key = ("_estimator_table", name, str(device), dtype)
    cached = owner.__dict__.get(key)
    if cached is None:
        a = np.asarray(build())
        cached = torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else torch.long).to(device)
        owner.__dict__[key] = cached
    return cached


def _faces_key(face_ids: np.ndarray):
    return (len(face_ids), hash(np.asarray(face_ids, dtype=np.int64).tobytes()))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _vertex_star(grid: Grid):
    """[NV, D] flat (cell, corner) entries of each vertex in ascending order,
    padded with NC * nvc (an appended zero), and the counts [NV]."""
    ids = grid.cells.reshape(-1).astype(np.int64)
    counts = np.bincount(ids, minlength=grid.num_vertices)
    order = np.argsort(ids, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(ids)) - start[ids[order]]
    table = np.full((grid.num_vertices, max(int(counts.max()), 1)), len(ids), dtype=np.int64)
    table[ids[order], pos] = order
    return table, counts.astype(np.float64)


def oswald_interpolation(space: Space, u: torch.Tensor,
                         dirichlet_vertices: np.ndarray) -> torch.Tensor:
    """DG-P1 -> conforming-P1 vertex averaging; zero on Dirichlet vertices.
    Returns vertex values [NV]."""
    assert space.basis == "nodal" and not space.continuous
    grid, dev, dt = space.grid, u.device, u.dtype
    nvc = grid.vertices_per_cell
    table = _on(grid, "vertex_star", lambda: _vertex_star(grid)[0], dev)
    counts = _on(grid, "vertex_counts", lambda: _vertex_star(grid)[1], dev, dt)
    vals = u[_on(space, "cell_dofs", lambda: space.cell_dofs, dev)][:, :nvc].reshape(-1)
    sums = torch.cat([vals, vals.new_zeros(1)])[table].sum(dim=1)
    mask = torch.as_tensor(np.asarray(dirichlet_vertices, dtype=bool)).to(dev)
    return torch.where(mask, vals.new_zeros(()), sums / counts)


def oswald_interpolation_nodal(space: Space, u: torch.Tensor,
                               boundary_info: BoundaryInfo) -> torch.Tensor:
    """DG -> conforming nodal averaging, returned cell-wise [NC, nd]: for P1
    the vertex averages (GDT::Operators::OswaldInterpolation)."""
    grid = space.grid
    vtx = oswald_interpolation(space, u, boundary_info.dirichlet_vertices)
    return vtx[_on(grid, "cells", lambda: grid.cells, u.device)]


def min_diffusion_eigenvalue(lam_fn: Function, kap_fn: Function, grid: Grid, qorder: int = 2,
                             device="cuda", dtype=torch.float64) -> torch.Tensor:
    """Per-cell min eigenvalue of lambda*kappa sampled at quadrature points
    (the closed-form symmetric 2x2 for the reference's Eigen solve)."""
    qp, _ = cell_quadrature(grid, qorder, device, dtype)
    lam = lam_fn(qp)
    kap = kap_fn(qp)
    mat = lam[..., None, None] * kap
    a, b = mat[..., 0, 0], mat[..., 0, 1]
    c, d = mat[..., 1, 0], mat[..., 1, 1]
    disc = torch.sqrt(torch.clamp((a - d) ** 2 + 4.0 * b * c, min=0.0))
    ev_min = 0.5 * (a + d - disc)
    return torch.amin(ev_min, dim=1)


def _side_data(space: Space, cells_key, cells: np.ndarray, qp: torch.Tensor, u: torch.Tensor,
               lam_fn: Function, kap_fn: Function, n: torch.Tensor,
               wlam_fn: Optional[Function] = None, wkap_fn: Optional[Function] = None):
    """(u_h at qp [F,k], normal diffusive flux of u_h [F,k], delta [F,k]) on
    the side ``cells`` (the grid tables of which are cached under
    ``cells_key``); delta uses the weighting diffusion when given."""
    grid, dev = space.grid, u.device
    verts = _on(grid, ("side_vertices", cells_key), lambda: grid.cell_vertices[cells], dev,
                u.dtype)
    cent = _on(grid, ("side_centroids", cells_key), lambda: grid.cell_centroids[cells], dev,
               u.dtype)
    dofs = _on(space, ("side_dofs", cells_key), lambda: space.cell_dofs[cells], dev)
    eps = _SIDE_EPS if qp.dtype == torch.float64 else 1e-3  # 1e-7 is below a float32 ulp
    shifted = qp + eps * (cent[:, None, :] - qp)
    vals = space.shape_values(verts, qp)
    grads = space.shape_gradients(verts, qp)
    u_loc = u[dofs]
    uh = torch.einsum("fki,fi->fk", vals, u_loc)
    grad_uh = torch.einsum("fkia,fi->fka", grads, u_loc)
    lam = lam_fn(shifted)
    kap = kap_fn(shifted)
    tau = lam[..., None, None] * kap
    flux = torch.einsum("fkab,fkb,fa->fk", tau, grad_uh, n)
    if wlam_fn is not None and wlam_fn is not lam_fn:
        wtau = wlam_fn(shifted)[..., None, None] * (wkap_fn or kap_fn)(shifted)
    else:
        wtau = tau
    delta = torch.einsum("fa,fkab,fb->fk", n, wtau, n)
    return uh, flux, delta


def _numerical_flux_moments(
    space: Space,
    u: torch.Tensor,
    lam_fn: Function,
    kap_fn: Function,
    dirichlet_faces: np.ndarray,
    neumann_faces: np.ndarray,
    g_d: Optional[Function] = None,
    g_n: Optional[Function] = None,
    qorder: int = 4,
    weight_lam_fn: Optional[Function] = None,
    weight_kap_fn: Optional[Function] = None,
    flux_parts: Optional[List] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m0 [NF], m1 [NF]) moments of the SWIPDG numerical normal flux along
    the global inside->outside face normal:

      m0 = int_e t.n ds,  m1 = int_e t.n s_hat ds,   s_hat = t - 1/2,

      interior:  t.n = -{lam kap grad u_h . n}_w + pen_e [u_h]
      dirichlet: t.n = -lam kap grad u_h . n + pen_b (u_h - g_d)
      neumann:   t.n = -g_n

    ``flux_parts`` = [(lam_q_fn, kap_q_fn, theta_q, with_penalty), ...]
    reconstructs the theta-combination of per-component self-weighted
    fluxes that the reference scheme assembles (``scheme_flux_parts``).
    """
    grid, dev, dt = space.grid, u.device, u.dtype
    sigma_i, sigma_b = inner_sigma(space.order), boundary_sigma(space.order)
    beta = default_beta(2)
    m0 = torch.zeros(grid.num_faces, dtype=dt, device=dev)
    m1 = torch.zeros(grid.num_faces, dtype=dt, device=dev)
    tq, _wq = edge_rule(qorder)
    s_hat = torch.as_tensor(tq, dtype=dt).to(dev) - 0.5  # [k]

    if flux_parts is None:
        flux_parts = [(lam_fn, kap_fn, 1.0, True)]
        wl, wk = weight_lam_fn, weight_kap_fn
    else:
        wl = wk = None  # each part self-weighted

    def put(ids, tn, qw):
        idx = _on(grid, ("face_ids", _faces_key(ids)), lambda: ids, dev)
        m0[idx] = torch.sum(qw * tn, dim=1)
        m1[idx] = torch.sum(qw * tn * s_hat[None, :], dim=1)

    def geometry(ids):
        key = _faces_key(ids)
        n = _on(grid, ("face_normals", key), lambda: grid.face_normals[ids], dev, dt)
        h = _on(grid, ("face_volumes", key), lambda: grid.face_volumes[ids], dev, dt)
        return key, n, h

    interior = np.nonzero(grid.interior_faces)[0]
    if len(interior):
        qp, qw = face_quadrature(grid, qorder, dev, dt, interior)
        key, n, h = geometry(interior)
        tn = 0.0
        for part_lam, part_kap, theta, with_pen in flux_parts:
            u_m, f_m, d_m = _side_data(space, (key, 0), grid.face_cells[interior, 0], qp, u,
                                       part_lam, part_kap, n, wl, wk)
            u_p, f_p, d_p = _side_data(space, (key, 1), grid.face_cells[interior, 1], qp, u,
                                       part_lam, part_kap, n, wl, wk)
            denom = d_m + d_p
            zero = denom == 0
            safe = torch.where(zero, denom.new_ones(()), denom)
            w_m = torch.where(zero, denom.new_full((), 0.5), d_p / safe)
            w_p = torch.where(zero, denom.new_full((), 0.5), d_m / safe)
            part = -(w_m * f_m + w_p * f_p)
            if with_pen:
                gamma = torch.where(zero, denom.new_zeros(()), d_m * d_p / safe)
                pen = sigma_i * gamma / (h[:, None] ** beta)
                part = part + pen * (u_m - u_p)
            tn = tn + theta * part
        put(interior, tn, qw)

    fb = np.asarray(dirichlet_faces)
    if len(fb):
        qp, qw = face_quadrature(grid, qorder, dev, dt, fb)
        key, n, h = geometry(fb)
        gd = g_d(qp) if g_d is not None else 0.0
        tn = 0.0
        for part_lam, part_kap, theta, with_pen in flux_parts:
            uh, flux, delta = _side_data(space, (key, 0), grid.face_cells[fb, 0], qp, u,
                                         part_lam, part_kap, n, wl, wk)
            part = -flux
            if with_pen:
                pen = sigma_b * delta / (h[:, None] ** beta)
                part = part + pen * (uh - gd)
            tn = tn + theta * part
        put(fb, tn, qw)

    fn_ = np.asarray(neumann_faces)
    if len(fn_) and g_n is not None:
        qp, qw = face_quadrature(grid, qorder, dev, dt, fn_)
        put(fn_, -g_n(qp), qw)
    return m0, m1


def scheme_flux_parts(problem, mu) -> Optional[List]:
    """(lam_fn, kap_fn, theta, with_penalty) per part of the reference
    scheme's numerical flux at mu: one self-weighted SWIPDG form per affine
    diffusion component.  With these parts the reconstruction is exactly
    locally conservative for the assembled scheme (div t = P0 f), which the
    frozen-diffusion reconstruction is not where component weights differ."""
    if not problem.parametric():
        return None
    mu = problem.parse_parameter(mu)
    pairs = diffusion_pairs(problem)
    parts = []
    for q in range(pairs.num_components):
        lam_fn, kap_fn = pairs.components[q]
        theta = float(pairs.coefficients[q](mu))
        parts.append((lam_fn, kap_fn, theta, True))
    if pairs.affine_part is not None:
        lam_fn, kap_fn = pairs.affine_part
        parts.append((lam_fn, kap_fn, 1.0, True))
    return parts


def rt0_flux_reconstruction(
    space: Space,
    u: torch.Tensor,
    lam_fn: Function,
    kap_fn: Function,
    dirichlet_faces: np.ndarray,
    neumann_faces: np.ndarray,
    g_d: Optional[Function] = None,
    g_n: Optional[Function] = None,
    qorder: int = 4,
    weight_lam_fn: Optional[Function] = None,
    weight_kap_fn: Optional[Function] = None,
    flux_parts: Optional[List] = None,
) -> torch.Tensor:
    """Mean normal flux per face [NF] (along the global inside->outside
    normal) of the RT0 diffusive-flux reconstruction t_h of -lam kap grad u.
    Testing the SWIPDG form with 1_T gives div t_h = P0 f elementwise
    (for parametric problems with ``flux_parts`` = scheme_flux_parts)."""
    m0, _m1 = _numerical_flux_moments(
        space, u, lam_fn, kap_fn, dirichlet_faces, neumann_faces, g_d, g_n,
        qorder, weight_lam_fn, weight_kap_fn, flux_parts=flux_parts,
    )
    grid = space.grid
    return m0 / _on(grid, "face_volumes", lambda: grid.face_volumes, u.device, u.dtype)


def _rt0_outward_sign(grid: Grid) -> np.ndarray:
    """+1 where the cell is the face's inside cell (face normal points out
    of it), -1 otherwise; [NC, nfc]."""
    cf = grid.cell_faces
    return np.where(
        grid.face_cells[cf, 0] == np.arange(grid.num_cells)[:, None], 1.0, -1.0
    )


def _rt0_dofs(grid: Grid, mean_flux: torch.Tensor) -> torch.Tensor:
    """Outward flux integrals D_e [NC, nfc] of each cell's faces."""
    dev, dt = mean_flux.device, mean_flux.dtype
    cf = _on(grid, "cell_faces", lambda: grid.cell_faces, dev)
    scale = _on(grid, "rt0_outward_length",
                lambda: _rt0_outward_sign(grid) * grid.face_volumes[grid.cell_faces], dev, dt)
    return mean_flux[cf] * scale


def _rt0_cell_data(grid: Grid, mean_flux: torch.Tensor):
    """Outward integral dofs D_e [NC, 3] and opposite vertices P_e [NC, 3, 2]."""
    dofs = _rt0_dofs(grid, mean_flux)  # local faces (v0v1, v1v2, v2v0)
    P = _on(grid, "rt0_opposite_vertices", lambda: grid.vertices[grid.cells[:, [2, 0, 1]]],
            mean_flux.device, mean_flux.dtype)
    return dofs, P


def rt0_evaluate(grid: Grid, mean_flux: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """RT0 field at per-cell points qp [NC, k, 2] -> [NC, k, 2]:
    t|_T(x) = sum_e D_e (x - P_e) / (2|T|) on triangles."""
    if grid.cell_type != TRIANGLE:
        raise NotImplementedError(NOT_PORTED.format(what="RT0 on quads"))
    dofs, P = _rt0_cell_data(grid, mean_flux)
    inv2a = _on(grid, "rt0_inv_2area", lambda: 1.0 / (2.0 * grid.cell_volumes),
                mean_flux.device, mean_flux.dtype)
    diff = qp[:, :, None, :] - P[:, None, :, :]  # [NC, k, 3, 2]
    return torch.einsum("ce,ckea->cka", dofs, diff) * inv2a[:, None, None]


def rt0_divergence(grid: Grid, mean_flux: torch.Tensor) -> torch.Tensor:
    """div t per cell [NC] = sum_e D_e / |T|."""
    vol = _on(grid, "cell_volumes", lambda: grid.cell_volumes, mean_flux.device, mean_flux.dtype)
    return torch.sum(_rt0_dofs(grid, mean_flux), dim=1) / vol


def rt1_flux_reconstruction(*args, **kwargs):
    """The RT1 reconstruction of the order-2 estimators needs P2 spaces."""
    raise NotImplementedError(NOT_PORTED.format(what="the RT1 flux reconstruction"))


rt1_evaluate = rt1_divergence_at = rt1_flux_reconstruction


# ---------------------------------------------------------------------------
# the estimator front-end (string dispatch like estimators/swipdg.hh:824-985)
# ---------------------------------------------------------------------------


class SWIPDGEstimators:
    @staticmethod
    def available() -> List[str]:
        return [
            "eta_NC_ESV2007",
            "eta_R_ESV2007",
            "eta_R_ESV2007_*",
            "eta_DF_ESV2007",
            "eta_ESV2007",
            "eta_ESV2007_alt",
        ]

    available_local = available

    # -- local (per-element squared) contributions --------------------------
    @classmethod
    def _local_squared(cls, space, boundary_info, problem, u, type_, mu=None,
                       mu_hat=None, reconstruction: str = "frozen",
                       weight_diffusion=None, cache: Optional[dict] = None) -> torch.Tensor:
        """``cache``: a dict shared by the calls of one estimate, which keeps
        the RT0 mean flux (the same for R_* and DF) after its first use."""
        grid, dev, dt = space.grid, space.device, space.dtype
        frozen = problem.with_mu(mu) if problem.parametric() else problem
        lam = freeze_function(frozen.diffusion_factor)
        kap = freeze_function(frozen.diffusion_tensor)
        frozen_hat = (
            problem.with_mu(mu_hat) if (problem.parametric() and mu_hat is not None)
            else frozen
        )
        lam_hat = freeze_function(frozen_hat.diffusion_factor)
        kap_hat = freeze_function(frozen_hat.diffusion_tensor)
        # the reconstruction's weighting diffusion: the mu-frozen diffusion
        # itself unless a penalty_mu scheme's fixed weights are passed
        wlam, wkap = weight_diffusion if weight_diffusion is not None else (lam, kap)
        force = freeze_function(frozen.force)
        g_d = freeze_function(frozen.dirichlet)
        g_n = freeze_function(frozen.neumann)
        dirichlet_faces = np.nonzero(boundary_info.dirichlet_faces)[0]
        neumann_faces = np.nonzero(boundary_info.neumann_faces)[0]
        # reconstruction="scheme": the theta-combined per-component flux;
        # "frozen" (default): the reference estimator's mu-frozen diffusion
        flux_parts = (
            scheme_flux_parts(problem, mu)
            if (reconstruction == "scheme" and problem.parametric())
            else None
        )

        def mean_flux():
            store = cache if cache is not None else {}
            if "mean_flux" not in store:
                store["mean_flux"] = rt0_flux_reconstruction(
                    space, u, lam, kap, dirichlet_faces, neumann_faces, g_d, g_n,
                    weight_lam_fn=wlam, weight_kap_fn=wkap, flux_parts=flux_parts)
            return store["mean_flux"]

        if type_ == "eta_NC_ESV2007":
            qorder = lam.order + kap.order + 2 * space.order
            qp, qw = cell_quadrature(grid, qorder, dev, dt)
            grads = cell_shape_gradients(space, qorder)
            u_loc = u[_on(space, "cell_dofs", lambda: space.cell_dofs, dev)]
            # conforming interpolant: cell-wise averaged nodal values
            v_loc = oswald_interpolation_nodal(space, u, boundary_info)
            e_grad = torch.einsum("ckia,ci->cka", grads, u_loc - v_loc)
            lam_q = lam(qp)
            kap_q = kap(qp)
            flux = torch.einsum("ckab,ckb->cka", kap_q, e_grad)
            return torch.sum(qw * lam_q * torch.sum(e_grad * flux, dim=-1), dim=1)

        if type_ in ("eta_R_ESV2007", "eta_R_ESV2007_*"):
            qorder = max(force.order + 1, 4)
            qp, qw = cell_quadrature(grid, qorder, dev, dt)
            f_q = force(qp)
            if type_ == "eta_R_ESV2007":
                vol = _on(grid, "cell_volumes", lambda: grid.cell_volumes, dev, dt)
                proj = torch.sum(qw * f_q, dim=1) / vol  # P0 projection
            else:
                proj = rt0_divergence(grid, mean_flux())
            resid = torch.sum(qw * (f_q - proj[:, None]) ** 2, dim=1)
            h2 = _on(grid, "cell_diameters", lambda: grid.cell_diameters, dev, dt) ** 2
            min_ev = min_diffusion_eigenvalue(lam, kap, grid, device=dev, dtype=dt)
            cutoff = POINCARE * h2 / min_ev
            return cutoff * resid

        if type_ in ("eta_DF_ESV2007", "eta_DF_star"):
            # the reconstruction uses the diffusion at mu; the residual's
            # gradient weight is lambda(mu_hat), or lambda(mu) for the star
            # variant
            qorder = lam.order + lam_hat.order + 2 + 2 * space.order
            qp, qw = cell_quadrature(grid, qorder, dev, dt)
            u_loc = u[_on(space, "cell_dofs", lambda: space.cell_dofs, dev)]
            grad_uh = torch.einsum("ckia,ci->cka", cell_shape_gradients(space, qorder), u_loc)
            t = rt0_evaluate(grid, mean_flux(), qp)
            lam_q = lam(qp) if type_ == "eta_DF_star" else lam_hat(qp)
            kap_q = kap(qp)
            resid = lam_q[..., None] * torch.einsum("ckab,ckb->cka", kap_q, grad_uh) + t
            # metric (lambda_hat kappa_hat)^{-1}
            tau_hat = lam_hat(qp)[..., None, None] * kap_hat(qp)
            det = (tau_hat[..., 0, 0] * tau_hat[..., 1, 1]
                   - tau_hat[..., 0, 1] * tau_hat[..., 1, 0])
            inv = torch.stack(
                [torch.stack([tau_hat[..., 1, 1], -tau_hat[..., 0, 1]], dim=-1),
                 torch.stack([-tau_hat[..., 1, 0], tau_hat[..., 0, 0]], dim=-1)],
                dim=-2,
            ) / det[..., None, None]
            quad = torch.einsum("cka,ckab,ckb->ck", resid, inv, resid)
            return torch.sum(qw * quad, dim=1)

        raise ValueError(f"unknown estimator {type_!r}; available: {cls.available()}")

    @classmethod
    def _parts(cls, space, boundary_info, problem, u, mu, mu_hat, reconstruction,
               weight_diffusion):
        """The (NC, R_*, DF) local squares of one estimate, sharing one RT0
        reconstruction."""
        cache: dict = {}
        return [cls._local_squared(space, boundary_info, problem, u, t, mu, mu_hat,
                                   reconstruction, weight_diffusion, cache=cache)
                for t in ("eta_NC_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007")]

    # -- public surface ------------------------------------------------------
    @classmethod
    def estimate(cls, space, boundary_info, problem, u, type_, mu=None,
                 mu_hat=None, reconstruction: str = "frozen",
                 weight_diffusion=None) -> float:
        args = (space, boundary_info, problem, u, mu, mu_hat, reconstruction, weight_diffusion)
        if type_ == "eta_ESV2007":
            nc, r, df = cls._parts(*args)
            return float(torch.sqrt(torch.sum(nc + (torch.sqrt(r) + torch.sqrt(df)) ** 2)))
        if type_ == "eta_ESV2007_alt":
            nc, r, df = cls._parts(*args)
            return float(torch.sqrt(torch.sum(nc)) + torch.sqrt(torch.sum(r))
                         + torch.sqrt(torch.sum(df)))
        vals = cls._local_squared(space, boundary_info, problem, u, type_, mu, mu_hat,
                                  reconstruction, weight_diffusion)
        return float(torch.sqrt(torch.sum(vals)))

    @classmethod
    def estimate_local(cls, space, boundary_info, problem, u, type_, mu=None,
                       mu_hat=None, reconstruction: str = "frozen",
                       weight_diffusion=None) -> np.ndarray:
        """Per-element squared indicators scaled by the squared total
        (swipdg.hh:700-719)."""
        if type_ == "eta_ESV2007":
            nc, r, df = cls._parts(space, boundary_info, problem, u, mu, mu_hat,
                                   reconstruction, weight_diffusion)
            local = nc + (torch.sqrt(r) + torch.sqrt(df)) ** 2
        else:
            local = cls._local_squared(space, boundary_info, problem, u, type_, mu, mu_hat,
                                       reconstruction, weight_diffusion)
        total = torch.sum(local)
        return (local / total).cpu().numpy()
