"""SWIPDG (symmetric weighted interior penalty DG) face kernels.

Counterpart of ``dune_hdd_tpu/ops/swipdg.py``.  All faces are processed as
static batches on the space's device; each interior face produces a 2x2 grid
of nd x nd coupling blocks, assembled with the volume blocks through one
shared SparsityPattern.

Bilinear form on a face e with sides (-,+) = (inside, outside), jump
[u] = u^- - u^+ (n points - -> +), tau = lambda kappa:

  a_e(u,v) = -int_e {tau grad u . n}_w [v]  -  int_e {tau grad v . n}_w [u]
             + int_e pen_e [u][v]

with weighted average {q}_w = w^- q^- + w^+ q^+,
  delta^{+/-} = n . (tau^{+/-} n),   w^- = delta^+/(delta^- + delta^+),
  w^+ = delta^-/(delta^- + delta^+),
  pen_e = sigma_inner(p) * gamma / |e|^beta,  gamma = delta^+ delta^- / (delta^+ + delta^-).

Dirichlet boundary faces use the one-sided form with
pen_b = sigma_boundary(p) * delta^- / |e|^beta; beta = 1/(d-1),
sigma_inner(1) = 8, sigma_boundary(1) = 14 (dune-gdt's SIPDG internals).
Weighting/penalty diffusion may differ from the flux diffusion (the
penalty_mu scheme of ``discretizations/swipdg.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..functions.base import Function
from ..la.sparse import SparseMatrix, SparsityPattern, build_pattern
from .assembly import face_quadrature, scatter_cell_vectors
from .spaces import Space

__all__ = [
    "inner_sigma",
    "boundary_sigma",
    "default_beta",
    "swipdg_pattern",
    "swipdg_face_blocks",
    "assemble_swipdg_matrix",
    "swipdg_dirichlet_rhs",
    "dg_face_jump_blocks",
]

_SIDE_EPS = 1e-7  # relative shift towards the cell centroid for side evaluation


def inner_sigma(pol_order: int) -> float:
    """dune-gdt LocalEvaluation::SIPDG::internal::inner_sigma."""
    return {0: 4.0, 1: 8.0, 2: 50.0, 3: 450.0}.get(int(pol_order), 450.0)


def boundary_sigma(pol_order: int) -> float:
    """dune-gdt LocalEvaluation::SIPDG::internal::boundary_sigma."""
    return {0: 14.0, 1: 14.0, 2: 38.0, 3: 74.0}.get(int(pol_order), 74.0)


def default_beta(dim: int = 2) -> float:
    return 1.0 / (dim - 1.0)


def _side_eval(fn, qp, centroids):
    """fn at quadrature points shifted slightly towards a cell centroid: the
    one-sided value of a coefficient that jumps exactly at the face.  In
    float32 a 1e-7 relative shift is below ulp(qp), so 1e-3 is used there."""
    eps = _SIDE_EPS if qp.dtype == torch.float64 else 1e-3
    return fn(qp + eps * (centroids[:, None, :] - qp))


def _face_geometry(space: Space, face_ids: np.ndarray, qorder: int):
    grid = space.grid
    qp, qw = face_quadrature(grid, qorder, space.device, space.dtype, face_ids)
    n = space.tensor(grid.face_normals[face_ids])  # [F, 2] inside -> outside
    h = space.tensor(grid.face_volumes[face_ids])  # [F]
    return qp, qw, n, h


def _side_shapes(space: Space, cells: np.ndarray, qp: torch.Tensor):
    """(vals [F,k,nd], grads [F,k,nd,2], centroids [F,2]) for one face side,
    cached per (space, face side, #points)."""
    key = ("_side_shapes", hash(cells.tobytes()), len(cells), int(qp.shape[1]))
    if key not in space.__dict__:
        verts = space.tensor(space.grid.cell_vertices[cells])
        cent = space.tensor(space.grid.cell_centroids[cells])
        space.__dict__[key] = (space.shape_values(verts, qp),
                               space.shape_gradients(verts, qp), cent)
    return space.__dict__[key]


def _side_quantities(space: Space, cells: np.ndarray, qp: torch.Tensor,
                     lam_fn: Function, kap_fn: Function,
                     wlam_fn: Function, wkap_fn: Function, n: torch.Tensor):
    """Per-side arrays: shape values [F,k,nd], normal flux of the basis
    (tau grad phi).n [F,k,nd], delta = n.(tau_w n) [F,k]."""
    vals, grads, cent = _side_shapes(space, cells, qp)
    lam = _side_eval(lam_fn, qp, cent)
    kap = _side_eval(kap_fn, qp, cent)
    tau_grad = lam[..., None, None] * torch.einsum("fkab,fkib->fkia", kap, grads)
    flux = torch.einsum("fkia,fa->fki", tau_grad, n)
    wlam = lam if wlam_fn is lam_fn else _side_eval(wlam_fn, qp, cent)
    wkap = kap if wkap_fn is kap_fn else _side_eval(wkap_fn, qp, cent)
    tau_w = wlam[..., None, None] * wkap
    delta = torch.einsum("fa,fkab,fb->fk", n, tau_w, n)
    return vals, flux, delta


def swipdg_face_blocks(
    space: Space,
    lam_fn: Function,
    kap_fn: Function,
    interior_faces: np.ndarray,
    dirichlet_faces: np.ndarray,
    weight_lam_fn: Optional[Function] = None,
    weight_kap_fn: Optional[Function] = None,
    sigma_i: Optional[float] = None,
    sigma_b: Optional[float] = None,
    beta: Optional[float] = None,
    qorder: Optional[int] = None,
    penalty_only: bool = False,
    flux_only: bool = False,
    flux_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(interior blocks [Fi, 2, 2, nd, nd], boundary blocks [Fb, nd, nd]),
    index order [face, test side, ansatz side, i, j].  ``penalty_only``
    drops the consistency flux terms; ``flux_only`` drops the penalty."""
    if penalty_only and flux_only:
        raise ValueError("penalty_only and flux_only are mutually exclusive")
    grid = space.grid
    wlam = weight_lam_fn or lam_fn
    wkap = weight_kap_fn or kap_fn
    sigma_i = inner_sigma(space.order) if sigma_i is None else sigma_i
    sigma_b = boundary_sigma(space.order) if sigma_b is None else sigma_b
    beta = default_beta(2) if beta is None else beta
    qorder = qorder if qorder is not None else 2 * space.order + max(lam_fn.order, wlam.order) + 1
    nd = space.shape_count
    kw = dict(penalty_only=penalty_only, flux_only=flux_only, flux_scale=flux_scale)

    fi = np.asarray(interior_faces)
    if len(fi):
        qp, qw, n, h = _face_geometry(space, fi, qorder)
        cin, cout = grid.face_cells[fi, 0], grid.face_cells[fi, 1]
        side_m = _side_quantities(space, cin, qp, lam_fn, kap_fn, wlam, wkap, n)
        side_p = _side_quantities(space, cout, qp, lam_fn, kap_fn, wlam, wkap, n)
        int_blocks = interior_blocks_core(qw, h, side_m, side_p, sigma_i, beta, nd, **kw)
    else:
        int_blocks = torch.zeros((0, 2, 2, nd, nd), dtype=space.dtype, device=space.device)

    fb = np.asarray(dirichlet_faces)
    if len(fb):
        qp, qw, n, h = _face_geometry(space, fb, qorder)
        side_m = _side_quantities(space, grid.face_cells[fb, 0], qp, lam_fn, kap_fn,
                                  wlam, wkap, n)
        bnd_blocks = boundary_blocks_core(qw, h, side_m, sigma_b, beta, nd, **kw)
    else:
        bnd_blocks = torch.zeros((0, nd, nd), dtype=space.dtype, device=space.device)
    return int_blocks, bnd_blocks


def interior_blocks_core(qw, h, side_m, side_p, sigma_i, beta, nd, penalty_only=False,
                         flux_only=False, flux_scale=1.0) -> torch.Tensor:
    """[F,2,2,nd,nd] interior SWIPDG blocks from precomputed side quantities."""
    vals_m, flux_m, delta_m = side_m
    vals_p, flux_p, delta_p = side_p
    F = qw.shape[0]
    # delta_m + delta_p == 0 where a component diffusion vanishes on both
    # sides (per-component self-weighted scheme): the limit contribution is 0
    denom = delta_m + delta_p
    zero = denom == 0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    half = torch.full_like(denom, 0.5)
    w_m = torch.where(zero, half, delta_p / safe)  # weight of the inside flux
    w_p = torch.where(zero, half, delta_m / safe)
    gamma = torch.where(zero, torch.zeros_like(denom), delta_m * delta_p / safe)
    pen = sigma_i * gamma / (h[:, None] ** beta)  # [F, k]

    vals = (vals_m, vals_p)
    wflux = (w_m[..., None] * flux_m, w_p[..., None] * flux_p)
    sign = (1.0, -1.0)
    blocks = []
    for s in range(2):  # test side
        row = []
        for t in range(2):  # ansatz side
            if flux_only:
                b = qw.new_zeros((F, nd, nd))
            else:
                b = torch.einsum("fk,fki,fkj->fij", qw * sign[s] * sign[t] * pen,
                                 vals[s], vals[t])
            if not penalty_only:
                b = b - flux_scale * torch.einsum("fk,fki,fkj->fij", qw * sign[s],
                                                  vals[s], wflux[t])
                b = b - flux_scale * torch.einsum("fk,fki,fkj->fij", qw * sign[t],
                                                  wflux[s], vals[t])
            row.append(b)
        blocks.append(torch.stack(row, dim=1))
    return torch.stack(blocks, dim=1)  # [F, s, t, nd, nd]


def boundary_blocks_core(qw, h, side_m, sigma_b, beta, nd, penalty_only=False,
                         flux_only=False, flux_scale=1.0) -> torch.Tensor:
    """[F,nd,nd] Dirichlet boundary SWIPDG blocks from side quantities."""
    vals_m, flux_m, delta_m = side_m
    pen = sigma_b * delta_m / (h[:, None] ** beta)
    if flux_only:
        b = qw.new_zeros((qw.shape[0], nd, nd))
    else:
        b = torch.einsum("fk,fki,fkj->fij", qw * pen, vals_m, vals_m)
    if not penalty_only:
        b = b - flux_scale * torch.einsum("fk,fki,fkj->fij", qw, vals_m, flux_m)
        b = b - flux_scale * torch.einsum("fk,fki,fkj->fij", qw, flux_m, vals_m)
    return b


def swipdg_dirichlet_rhs(
    space: Space,
    g_fn: Function,
    dirichlet_faces: np.ndarray,
    lam_fn: Optional[Function] = None,
    kap_fn: Optional[Function] = None,
    weight_lam_fn: Optional[Function] = None,
    weight_kap_fn: Optional[Function] = None,
    sigma_b: Optional[float] = None,
    beta: Optional[float] = None,
    qorder: Optional[int] = None,
    part: str = "both",  # "flux" | "penalty" | "both"
) -> torch.Tensor:
    """Global rhs vector of the SWIPDG Dirichlet boundary functional
    L_g(v) = int_e g (pen_b v - tau grad v . n); ``part`` selects the flux
    piece, the penalty piece or both."""
    fb = np.asarray(dirichlet_faces)
    if len(fb) == 0:
        return torch.zeros(space.num_dofs, dtype=space.dtype, device=space.device)
    sigma_b = boundary_sigma(space.order) if sigma_b is None else sigma_b
    beta = default_beta(2) if beta is None else beta
    base_order = max(f.order for f in [x for x in (lam_fn, weight_lam_fn) if x is not None]
                     or [g_fn])
    qorder = qorder if qorder is not None else space.order + g_fn.order + base_order + 1
    qp, qw, n, h = _face_geometry(space, fb, qorder)
    cin = space.grid.face_cells[fb, 0]
    wlam = weight_lam_fn or lam_fn
    wkap = weight_kap_fn or kap_fn
    vals_m, flux_m, delta_m = _side_quantities(space, cin, qp, lam_fn or wlam, kap_fn or wkap,
                                               wlam, wkap, n)
    g = g_fn(qp)  # [F, k]
    local = qw.new_zeros(vals_m.shape[:1] + (space.shape_count,))
    if part in ("both", "penalty"):
        pen = sigma_b * delta_m / (h[:, None] ** beta)
        local = local + torch.einsum("fk,fki->fi", qw * pen * g, vals_m)
    if part in ("both", "flux"):
        local = local - torch.einsum("fk,fki->fi", qw * g, flux_m)
    return scatter_cell_vectors(local, space.cell_dofs[cin], space.num_dofs)


def dg_face_jump_blocks(space: Space, interior_faces: np.ndarray,
                        qorder: Optional[int] = None) -> torch.Tensor:
    """[Fi, 2, 2, nd, nd] plain L2 jump blocks int_e [u][v] (no weights)."""
    grid = space.grid
    fi = np.asarray(interior_faces)
    nd = space.shape_count
    if len(fi) == 0:
        return torch.zeros((0, 2, 2, nd, nd), dtype=space.dtype, device=space.device)
    qorder = qorder if qorder is not None else 2 * space.order
    qp, qw, n, h = _face_geometry(space, fi, qorder)
    sides = [space.shape_values(space.tensor(grid.cell_vertices[cells]), qp)
             for cells in (grid.face_cells[fi, 0], grid.face_cells[fi, 1])]
    sign = (1.0, -1.0)
    return torch.stack([
        torch.stack([torch.einsum("fk,fki,fkj->fij", qw * sign[s] * sign[t], sides[s], sides[t])
                     for t in range(2)], dim=1)
        for s in range(2)], dim=1)


# -- pattern + assembly -----------------------------------------------------


def swipdg_pattern(space: Space, interior_faces: np.ndarray,
                   dirichlet_faces: np.ndarray) -> SparsityPattern:
    """Pattern over [volume blocks, interior 4-blocks, dirichlet blocks] in
    that fixed entry order (must match assemble_swipdg_matrix)."""
    fi = np.asarray(interior_faces)
    fb = np.asarray(dirichlet_faces)
    key = ("_swipdg_pattern", hash(fi.tobytes()), len(fi), hash(fb.tobytes()), len(fb))
    cached = space.__dict__.get(key)
    if cached is not None:
        return cached
    grid = space.grid
    dofs = space.cell_dofs
    nd = dofs.shape[1]
    rows = [np.repeat(dofs, nd, axis=1).ravel()]
    cols = [np.tile(dofs, (1, nd)).ravel()]
    if len(fi):
        cin, cout = grid.face_cells[fi, 0], grid.face_cells[fi, 1]
        sd = np.stack([dofs[cin], dofs[cout]], axis=1)  # [F, 2, nd]
        # entry order must match int_blocks [F, s, t, i, j].reshape(-1)
        shape = (len(fi), 2, 2, nd, nd)
        rows.append(np.broadcast_to(sd[:, :, None, :, None], shape).ravel())
        cols.append(np.broadcast_to(sd[:, None, :, None, :], shape).ravel())
    if len(fb):
        din = dofs[grid.face_cells[fb, 0]]
        rows.append(np.repeat(din, nd, axis=1).ravel())
        cols.append(np.tile(din, (1, nd)).ravel())
    pattern = build_pattern(np.concatenate(rows), np.concatenate(cols),
                            (space.num_dofs, space.num_dofs))
    space.__dict__[key] = pattern
    return pattern


def assemble_swipdg_matrix(space: Space, vol_local: torch.Tensor, int_blocks: torch.Tensor,
                           bnd_blocks: torch.Tensor, pattern: SparsityPattern) -> SparseMatrix:
    raw = torch.cat([vol_local.reshape(-1), int_blocks.reshape(-1), bnd_blocks.reshape(-1)])
    return SparseMatrix(pattern, pattern.assemble(raw))
