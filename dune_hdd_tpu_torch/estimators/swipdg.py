"""ESV2007 a-posteriori error estimators for SWIPDG.

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

Beyond the reference's P1 / RT0 on triangles, as the JAX package: P2 with
the conforming-P2 Oswald average (vertex and edge-midpoint nodes) and an RT1
equilibrated flux (edge dofs the P1(e) moments of the SWIPDG numerical
flux, interior dofs enforcing div t = Pi_P1 f); axis-aligned quads with the
Q1 Oswald vertex average and RT0 on rectangles (t = (a + bx, c + dy) from
the four outward face fluxes).  RT1 is triangle-only, so the order-2 R_* and
DF types raise on quads.

The grid tables (cell vertices, face lists, the RT0 sign and length factors)
are copied to the device once per grid and kept on it.  Vertex sums of the
Oswald average go through a host-built padded table of each vertex's
(cell, corner) entries and a row sum: deterministic on every device.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..functions.base import Function, freeze_function
from ..grid.boundaryinfo import BoundaryInfo
from ..grid.structured import QUAD, TRIANGLE, Grid
from ..ops.assembly import cell_quadrature, cell_shape_gradients, diffusion_pairs, face_quadrature
from ..ops.quadrature import edge_rule
from ..ops.spaces import Space
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


def _face_sides(grid: Grid):
    """[NF, 2] flat (cell, local face) entries of each face's inside and
    outside cell, the outside padded with NC * nfc (an appended zero), and
    the counts [NF]."""
    nfc = grid.faces_per_cell
    fc, fl = grid.face_cells.astype(np.int64), grid.face_local.astype(np.int64)
    table = np.where(fc >= 0, fc * nfc + fl, grid.num_cells * nfc)
    return table, (fc >= 0).sum(axis=1).astype(np.float64)


def oswald_interpolation_nodal(space: Space, u: torch.Tensor,
                               boundary_info: BoundaryInfo) -> torch.Tensor:
    """DG -> conforming nodal averaging, returned cell-wise [NC, nd].

    P1/Q1: vertex averages (GDT::Operators::OswaldInterpolation).  P2/Q2:
    the conforming node set is vertices + edge midpoints (+ the cell-local
    Q2 centre, kept as u's own value); edge nodes average over their (<= 2)
    cells, and every node on a Dirichlet face is 0."""
    grid, dev = space.grid, u.device
    vtx = oswald_interpolation(space, u, boundary_info.dirichlet_vertices)
    v_cells = vtx[_on(grid, "cells", lambda: grid.cells, dev)]
    if space.order == 1:
        return v_cells
    # edge-midpoint nodes live on the local faces (dofs nvc:2*nvc)
    nvc = grid.vertices_per_cell
    u_cells = u[_on(space, "cell_dofs", lambda: space.cell_dofs, dev)]
    mid_vals = u_cells[:, nvc:2 * nvc].reshape(-1)
    table = _on(grid, "face_sides", lambda: _face_sides(grid)[0], dev)
    counts = _on(grid, "face_counts", lambda: _face_sides(grid)[1], dev, u.dtype)
    mid = torch.cat([mid_vals, mid_vals.new_zeros(1)])[table].sum(dim=1) / counts
    mask = torch.as_tensor(np.asarray(boundary_info.dirichlet_faces, dtype=bool)).to(dev)
    mid = torch.where(mask, mid.new_zeros(()), mid)
    parts = [v_cells, mid[_on(grid, "cell_faces", lambda: grid.cell_faces, dev)]]
    if grid.cell_type == QUAD:
        parts.append(u_cells[:, 2 * nvc:])  # Q2 centre node: cell-local
    return torch.cat(parts, dim=-1)


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


def _rt0_quad_face_values(grid: Grid, mean_flux: torch.Tensor):
    """Per-cell RT0 component endpoint values on an axis-aligned rectangle:
    ((tx0, tx1), (ty0, ty1), lo [NC,2], ext [NC,2]).  t = (tx(x), ty(y)),
    each linear in its own coordinate, from the 4 outward face-flux
    integrals: tx(x0) = -D_west/hy, tx(x1) = D_east/hy, and in y alike."""
    dev, dt = mean_flux.device, mean_flux.dtype
    dofs = _rt0_dofs(grid, mean_flux)  # [NC, 4]

    def sides():
        # classify each local face by its outward normal (exactly axis-aligned)
        n_out = grid.face_normals[grid.cell_faces] * _rt0_outward_sign(grid)[..., None]
        return np.stack([n_out[..., 0] < -0.5, n_out[..., 0] > 0.5,
                         n_out[..., 1] < -0.5, n_out[..., 1] > 0.5]).astype(np.float64)

    west, east, south, north = _on(grid, "rt0_quad_sides", sides, dev, dt)
    verts = grid.cell_vertices
    lo = _on(grid, "rt0_quad_lo", lambda: verts.min(axis=1), dev, dt)
    ext = _on(grid, "rt0_quad_ext", lambda: verts.max(axis=1) - verts.min(axis=1), dev, dt)
    hx, hy = ext[:, 0], ext[:, 1]
    tx0 = -torch.sum(dofs * west, dim=1) / hy
    tx1 = torch.sum(dofs * east, dim=1) / hy
    ty0 = -torch.sum(dofs * south, dim=1) / hx
    ty1 = torch.sum(dofs * north, dim=1) / hx
    return (tx0, tx1), (ty0, ty1), lo, ext


def rt0_evaluate(grid: Grid, mean_flux: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """RT0 field at per-cell points qp [NC, k, 2] -> [NC, k, 2]:
    t|_T(x) = sum_e D_e (x - P_e) / (2|T|) on triangles; on axis-aligned
    rectangles t = (tx(x), ty(y)), each component linear in its own
    coordinate."""
    if grid.cell_type == QUAD:
        (tx0, tx1), (ty0, ty1), lo, ext = _rt0_quad_face_values(grid, mean_flux)
        xi = (qp - lo[:, None, :]) / ext[:, None, :]  # [NC, k, 2]
        tx = tx0[:, None] + xi[..., 0] * (tx1 - tx0)[:, None]
        ty = ty0[:, None] + xi[..., 1] * (ty1 - ty0)[:, None]
        return torch.stack([tx, ty], dim=-1)
    dofs, P = _rt0_cell_data(grid, mean_flux)
    inv2a = _on(grid, "rt0_inv_2area", lambda: 1.0 / (2.0 * grid.cell_volumes),
                mean_flux.device, mean_flux.dtype)
    diff = qp[:, :, None, :] - P[:, None, :, :]  # [NC, k, 3, 2]
    return torch.einsum("ce,ckea->cka", dofs, diff) * inv2a[:, None, None]


def rt0_divergence(grid: Grid, mean_flux: torch.Tensor) -> torch.Tensor:
    """div t per cell [NC] = sum_e D_e / |T| (on triangles and on
    axis-aligned rectangles alike)."""
    vol = _on(grid, "cell_volumes", lambda: grid.cell_volumes, mean_flux.device, mean_flux.dtype)
    return torch.sum(_rt0_dofs(grid, mean_flux), dim=1) / vol


# ---------------------------------------------------------------------------
# RT1 reconstruction (the optimal-rate estimators of the P2 spaces)
# ---------------------------------------------------------------------------

# monomial model fields on the scaled cell frame xi = (x - c_T)/h_T:
#   Phi = [(1,0), (0,1), (xi,0), (eta,0), (0,xi), (0,eta),
#          xi*(xi,eta), eta*(xi,eta)]
# div Phi * h_T = [0, 0, 1, 0, 0, 1, 3 xi, 3 eta]


def _rt1_fields(xi: torch.Tensor) -> torch.Tensor:
    """Phi at scaled points xi [..., 2] -> [..., 8, 2]."""
    one = torch.ones_like(xi[..., 0])
    zero = torch.zeros_like(one)
    x, y = xi[..., 0], xi[..., 1]
    fields = [(one, zero), (zero, one), (x, zero), (y, zero), (zero, x), (zero, y),
              (x * x, x * y), (x * y, y * y)]
    return torch.stack([torch.stack(f, dim=-1) for f in fields], dim=-2)


def _rt1_divs(xi: torch.Tensor) -> torch.Tensor:
    """h_T * div Phi at scaled points -> [..., 8]."""
    one = torch.ones_like(xi[..., 0])
    zero = torch.zeros_like(one)
    x, y = xi[..., 0], xi[..., 1]
    return torch.stack([zero, zero, one, zero, zero, one, 3 * x, 3 * y], dim=-1)


def _rt1_frame(grid: Grid, device, dtype):
    """(centroids [NC, 2], diameters [NC]) of the scaled cell frame."""
    return (_on(grid, "cell_centroids", lambda: grid.cell_centroids, device, dtype),
            _on(grid, "cell_diameters", lambda: grid.cell_diameters, device, dtype))


def rt1_flux_reconstruction(
    space: Space,
    u: torch.Tensor,
    lam_fn: Function,
    kap_fn: Function,
    dirichlet_faces: np.ndarray,
    neumann_faces: np.ndarray,
    g_d: Optional[Function] = None,
    g_n: Optional[Function] = None,
    force_fn: Optional[Function] = None,
    qorder: int = 6,
    weight_lam_fn: Optional[Function] = None,
    weight_kap_fn: Optional[Function] = None,
    flux_parts: Optional[List] = None,
) -> torch.Tensor:
    """RT1 diffusive-flux reconstruction; coefficients [NC, 8] in the scaled
    monomial frame (``_rt1_fields``).  Edge dofs: the P1(e) moments (m0,
    m1) of the SWIPDG numerical flux along the global face normal (both
    neighbours see the same t.n, so t is H(div)-conforming); interior dofs
    int_T t dx from the divergence moments int_T div t (x_i - c_i) dx =
    int_T f (x_i - c_i) dx, which with the edge dofs gives div t_h =
    Pi_P1 f.  One 8x8 solve per cell."""
    grid, dev, dt = space.grid, u.device, u.dtype
    if grid.cell_type != TRIANGLE:
        raise NotImplementedError(
            "RT1 flux reconstruction (order-2 eta_R_*/eta_DF) is "
            "triangle-only; on quads use order-1 spaces (RT0)")
    m0, m1 = _numerical_flux_moments(
        space, u, lam_fn, kap_fn, dirichlet_faces, neumann_faces, g_d, g_n,
        qorder, weight_lam_fn, weight_kap_fn, flux_parts=flux_parts,
    )
    cf = _on(grid, "cell_faces", lambda: grid.cell_faces, dev)  # [NC, 3]
    c, hT = _rt1_frame(grid, dev, dt)
    fverts = lambda: grid.vertices[grid.faces][grid.cell_faces]  # noqa: E731
    a = _on(grid, "rt1_face_a", lambda: fverts()[:, :, 0], dev, dt)  # [NC, 3, 2]
    b = _on(grid, "rt1_face_b", lambda: fverts()[:, :, 1], dev, dt)
    ng = _on(grid, "rt1_face_normals", lambda: grid.face_normals[grid.cell_faces], dev, dt)
    L = _on(grid, "rt1_face_volumes", lambda: grid.face_volumes[grid.cell_faces], dev, dt)
    mid = 0.5 * (a + b)
    d_vec = b - a  # [NC, 3, 2]

    # 2-pt Gauss on [0,1] integrates degree 3 exactly (Phi.n quadratic x s)
    tq = torch.as_tensor([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)],
                         dtype=dt).to(dev)
    gw = torch.as_tensor([0.5, 0.5], dtype=dt).to(dev)
    s_hat = tq - 0.5
    qp_e = a[:, :, None, :] + tq[None, None, :, None] * d_vec[:, :, None, :]
    xi_e = (qp_e - c[:, None, None, :]) / hT[:, None, None, None]
    Phin = torch.einsum("cfkja,cfa->cfkj", _rt1_fields(xi_e), ng)  # [NC, 3, 2, 8]
    w = gw[None, None, :] * L[:, :, None]  # [NC, 3, 2]
    row_m0 = torch.einsum("cfk,cfkj->cfj", w, Phin)
    row_m1 = torch.einsum("cfk,k,cfkj->cfj", w, s_hat, Phin)

    # interior functional rows: int_T Phi dx (2 components)
    qp_c, qw_c = cell_quadrature(grid, 3, dev, dt)
    xi_c = (qp_c - c[:, None, :]) / hT[:, None, None]
    rows_int = torch.einsum("ck,ckja->caj", qw_c, _rt1_fields(xi_c))  # [NC, 2, 8]
    M = torch.cat([row_m0, row_m1, rows_int], dim=1)  # [NC, 8, 8]

    rhs_m0, rhs_m1 = m0[cf], m1[cf]  # [NC, 3] edge moments, global orientation
    # int_T t_i = int_dT (t.n_out)(x_i - c_i) ds - int_T f (x_i - c_i),
    # int_e (t.n_glob)(x_i - c_i) ds = m0 (mid_i - c_i) + m1 d_i
    sgn = _on(grid, "rt0_outward_sign", lambda: _rt0_outward_sign(grid), dev, dt)
    bd = (torch.einsum("cf,cfa->ca", sgn * rhs_m0, mid - c[:, None, :])
          + torch.einsum("cf,cfa->ca", sgn * rhs_m1, d_vec))
    if force_fn is not None:
        qp_f, qw_f = cell_quadrature(grid, qorder, dev, dt)
        fmom = torch.einsum("ck,ck,cka->ca", qw_f, force_fn(qp_f), qp_f - c[:, None, :])
    else:
        fmom = torch.zeros_like(bd)
    rhs = torch.cat([rhs_m0, rhs_m1, bd - fmom], dim=1)  # [NC, 8]
    return torch.linalg.solve(M, rhs[..., None])[..., 0]


def rt1_evaluate(grid: Grid, coeffs: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """RT1 field at per-cell points qp [NC, k, 2] -> [NC, k, 2]."""
    c, hT = _rt1_frame(grid, coeffs.device, coeffs.dtype)
    xi = (qp - c[:, None, :]) / hT[:, None, None]
    return torch.einsum("cj,ckja->cka", coeffs, _rt1_fields(xi))


def rt1_divergence_at(grid: Grid, coeffs: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """div t at per-cell points [NC, k] (linear per cell)."""
    c, hT = _rt1_frame(grid, coeffs.device, coeffs.dtype)
    xi = (qp - c[:, None, :]) / hT[:, None, None]
    return torch.einsum("cj,ckj->ck", coeffs, _rt1_divs(xi)) / hT[:, None]


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
        the RT0 mean flux or the RT1 coefficients (the same for R_* and DF)
        after their first use."""
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

        def rt1_coeffs():
            store = cache if cache is not None else {}
            if "rt1" not in store:
                store["rt1"] = rt1_flux_reconstruction(
                    space, u, lam, kap, dirichlet_faces, neumann_faces, g_d, g_n,
                    force_fn=force, weight_lam_fn=wlam, weight_kap_fn=wkap,
                    flux_parts=flux_parts)
            return store["rt1"]

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
                proj = (torch.sum(qw * f_q, dim=1) / vol)[:, None]  # P0 projection
            elif space.order >= 2:
                proj = rt1_divergence_at(grid, rt1_coeffs(), qp)
            else:
                proj = rt0_divergence(grid, mean_flux())[:, None]
            resid = torch.sum(qw * (f_q - proj) ** 2, dim=1)
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
            if space.order >= 2:
                t = rt1_evaluate(grid, rt1_coeffs(), qp)
            else:
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
        """The (NC, R_*, DF) local squares of one estimate, sharing one flux
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
