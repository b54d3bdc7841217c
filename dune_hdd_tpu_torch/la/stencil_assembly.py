"""Direct-to-planes SWIPDG assembly for structured bisected grids.

Counterpart of ``dune_hdd_tpu/la/stencil_assembly.py``.  On a structured grid
every cell is congruent within its subclass and every face within its
(subclass, geometric slot) family, so the SWIPDG integrals factor into
per-family constant nd x nd tensors times scalar lattice fields, written
straight into the StencilBlockEll planes W[slot, i, j, subclass, KY, KX].

Two halves:

* host (numpy, once per lattice): ``build_structured_assembly`` derives the
  geometry plan, ``precompute_coefficient`` evaluates the static diffusion
  factor at every quadrature point, ``geometric_soa_maps`` gives the index
  maps to the flat cell-major layout;
* device (torch, per call): ``assembly_tensors`` moves the plan's constants
  to the device once, then ``assemble_structured_spe10``,
  ``structured_rhs`` and ``scale_planes`` run as tensor ops there.

The diffusion tensor is a cell-constant scalar field (the SPE10
permeability); the scalar diffusion factor may vary within cells.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..grid.structured import Grid
from ..ops.quadrature import edge_rule, tri_rule
from ..ops.spaces import tri_shape_grads, tri_shape_values
from ..ops.swipdg import boundary_sigma, default_beta, inner_sigma
from .stencil import StencilBlockEll, stencil_plan

__all__ = ["StructuredAssemblyPlan", "PrecomputedCoefficient", "AssemblyTensors",
           "build_structured_assembly", "geometric_soa_maps",
           "precompute_coefficient", "assembly_tensors",
           "assemble_structured_spe10", "structured_rhs", "scale_planes"]

_SIDE_EPS32 = 1e-3  # side-evaluation shift that survives f32 rounding
_ND = 3             # P1 triangle: 3 DoF per cell
_QORDER_VOL = 2     # = lam.order + kap.order + 2(p-1) + 2 for p = 1
_QORDER_FACE = 3    # = 2p + coefficient order + 1 for p = 1


class _FaceFamily(NamedTuple):
    k_src: int          # subclass of the slot-s neighbour
    dy: int
    dx: int
    qp: np.ndarray      # [kq, KY, KX, 2] face quadrature points
    qp_m: np.ndarray    # [kq, KY, KX, 2] shifted toward own centroid
    qp_p: np.ndarray    # [kq, KY, KX, 2] shifted toward neighbour centroid
    qw: np.ndarray      # [kq] weights incl. face length
    h: float            # face length
    vals_m: np.ndarray  # [kq, nd] own basis at qp
    vals_p: np.ndarray  # [kq, nd] neighbour basis at qp
    nflux_m: np.ndarray  # [nd] (grad phi_m . n_out)
    nflux_p: np.ndarray  # [nd] (grad phi_p . n_out)
    interior: np.ndarray  # [KY, KX] bool: face has a neighbour
    dirichlet: np.ndarray  # [KY, KX] bool: face is a Dirichlet boundary face


class StructuredAssemblyPlan(NamedTuple):
    families: Tuple[Tuple[_FaceFamily, ...], ...]  # [8][3]
    vol_qp: np.ndarray    # [kq_v, 8, KY, KX, 2]
    vol_G: np.ndarray     # [8, kq_v, nd, nd] qw x (grad_i . grad_j)
    vol_wvals: np.ndarray  # [8, kq_v, nd] qw x basis values
    dof_perm: np.ndarray  # [8, KY, KX, nd] storage dof index of geometric
    # role r (cells within a subclass are translates, but their vertex
    # storage order varies with refinement history; the planes are
    # assembled in the representative's role enumeration and this map
    # absorbs the per-cell permutation into the SoA <-> flat index maps)
    plan: tuple           # stencil plan (8 x 3 (k_src, dy, dx))
    lattice: Tuple[int, int]
    nd: int
    sigma_i: float
    sigma_b: float
    beta: float


def _geo_slots(grid: Grid, order) -> np.ndarray:
    """geo[new_cell, s] = face id of geo slot s (via order.slot_source)."""
    inv = np.asarray(order.inv)
    src = np.asarray(order.slot_source, dtype=np.int64)  # [NC(new), 3]
    return grid.cell_faces[inv[:, None], src]


def build_structured_assembly(grid: Grid, order, binfo,
                              side_eps: float = _SIDE_EPS32) -> StructuredAssemblyPlan:
    """Host-side (one-off) geometry plan for P1 SWIPDG.  ``side_eps`` is the
    relative shift of face quadrature points toward each side's centroid, so
    coefficients that jump exactly at faces are evaluated one-sided."""
    nd = _ND
    KY, KX = order.lattice
    L = KY * KX
    plan = stencil_plan(order)
    inv = np.asarray(order.inv)
    faces_of = _geo_slots(grid, order)  # [NC(new), 3]
    interior_f = np.asarray(grid.interior_faces)
    dirichlet_f = np.zeros(grid.num_faces, dtype=bool)
    dirichlet_f[np.nonzero(binfo.dirichlet_faces)[0]] = True
    verts_all = grid.cell_vertices

    # per-cell dof permutation: geometric role r (= the representative's
    # storage order) -> this cell's storage index, by matching vertex
    # offsets relative to the bounding-box corner (v0 is not a
    # translation-invariant anchor)
    dof_perm = np.empty((8, KY, KX, nd), dtype=np.int64)
    for k in range(8):
        v = verts_all[inv[k * L: (k + 1) * L]]  # [L, nvc, 2]
        rel = v - v.min(axis=1)[:, None]
        rep_rel = rel[0]
        dist = np.linalg.norm(rel[:, None, :, :] - rep_rel[None, :, None, :],
                              axis=-1)  # [L, r, j]
        perm = dist.argmin(axis=-1)
        if not (np.take_along_axis(dist, perm[..., None], -1) < 1e-9).all():
            raise ValueError(f"subclass {k} cells are not translates of each other")
        dof_perm[k] = perm.reshape(KY, KX, nd)

    # volume: per-subclass constant gradients + translated quadrature
    ref, w = tri_rule(_QORDER_VOL)
    kq_v = len(w)
    vol_qp = np.empty((kq_v, 8, KY, KX, 2))
    vol_G = np.empty((8, kq_v, nd, nd))
    vol_wvals = np.empty((8, kq_v, nd))
    for k in range(8):
        v = verts_all[inv[k * L]]  # representative [3, 2]
        e1, e2 = v[1] - v[0], v[2] - v[0]
        detj = abs(e1[0] * e2[1] - e1[1] * e2[0])
        qw_v = 2.0 * w * detj * 0.5
        g = tri_shape_grads(v)  # [3, 2], constant P1 gradients
        vol_G[k] = qw_v[:, None, None] * np.einsum("ia,ja->ij", g, g)[None]
        qp_rep = v[0] + ref[:, 0:1] * e1[None] + ref[:, 1:2] * e2[None]
        vol_wvals[k] = qw_v[:, None] * tri_shape_values(v, qp_rep)
        # translation offsets anchored on the bbox corner
        anchors = verts_all[inv[k * L: (k + 1) * L]].min(axis=1)  # [L, 2]
        vol_qp[:, k] = (qp_rep[:, None] + (anchors - v.min(axis=0))[None]
                        ).reshape(kq_v, KY, KX, 2)

    # face families
    t_e, w_e = edge_rule(_QORDER_FACE)
    kq_f = len(w_e)
    families = []
    for k in range(8):
        row = []
        cells_new = np.arange(k * L, (k + 1) * L)
        cells_old = inv[cells_new]
        cents = grid.cell_centroids[cells_old]  # [L, 2]
        for s in range(3):
            ks, dy, dx = plan[k][s]
            f_ids = faces_of[cells_new, s]  # [L]
            fv = grid.face_vertices[f_ids]  # [L, 2, 2]
            # the stored endpoint order may flip within a family, so anchor
            # on the elementwise-min corner, which is order-invariant
            a0, b0 = fv[0, 0], fv[0, 1]
            h = float(np.linalg.norm(b0 - a0))
            anchors_c = np.minimum(fv[:, 0], fv[:, 1])  # [L, 2]
            a0c = anchors_c[0]
            dvec = np.abs(fv[:, 1] - fv[:, 0])
            if not np.allclose(dvec - np.abs(b0 - a0), 0.0, atol=1e-9):
                raise ValueError(f"face family ({k}, {s}) is not translation-congruent")
            qp_rep = a0[None] + t_e[:, None] * (b0 - a0)[None]  # [kq, 2]
            qw = w_e * h
            # outward normal of the representative cell
            n_raw = grid.face_normals[f_ids[0]]
            cvec = qp_rep.mean(0) - cents[0]
            n_out = n_raw if np.dot(n_raw, cvec) > 0 else -n_raw
            v_m = verts_all[cells_old[0]]
            vals_m = tri_shape_values(v_m, qp_rep)
            nflux_m = tri_shape_grads(v_m) @ n_out
            int_mask = interior_f[f_ids]
            if int_mask.any():
                # neighbour representative: an interior face of the family
                j0 = int(np.argmax(int_mask))
                f0 = f_ids[j0]
                c_m_old = cells_old[j0]
                both = grid.face_cells[f0]
                c_p_old = both[1] if both[0] == c_m_old else both[0]
                v_p_rep = verts_all[c_p_old]
                # neighbour basis at the representative's qp translated to
                # face j0 (canonical-anchor offset)
                qp_j = qp_rep + (anchors_c[j0] - a0c)[None]
                vals_p = tri_shape_values(v_p_rep, qp_j)
                nflux_p = tri_shape_grads(v_p_rep) @ n_out
                # re-express in the neighbour subclass's role enumeration
                p_new = int(np.asarray(order.perm)[c_p_old])
                if p_new // L != ks:
                    raise ValueError(f"slot ({k}, {s}) neighbour is in subclass "
                                     f"{p_new // L}, plan says {ks}")
                piy, pix = divmod(p_new % L, KX)
                pperm = dof_perm[ks, piy, pix]
                vals_p = vals_p[:, pperm]
                nflux_p = nflux_p[pperm]
                p_cent_off = grid.cell_centroids[c_p_old] - anchors_c[j0]
            else:
                vals_p = np.zeros_like(vals_m)
                nflux_p = np.zeros(nd)
                p_cent_off = np.zeros(2)
            # per-cell translated quadrature + side-shifted variants
            qp_all = qp_rep[:, None] + (anchors_c - a0c)[None]  # [kq, L, 2]
            cent_m = cents[None]
            cent_p = (anchors_c + p_cent_off[None])[None]
            qp_m = qp_all + side_eps * (cent_m - qp_all)
            qp_p = qp_all + side_eps * (cent_p - qp_all)
            row.append(_FaceFamily(
                k_src=ks, dy=dy, dx=dx,
                qp=qp_all.reshape(kq_f, KY, KX, 2),
                qp_m=qp_m.reshape(kq_f, KY, KX, 2),
                qp_p=qp_p.reshape(kq_f, KY, KX, 2),
                qw=qw, h=h,
                vals_m=vals_m, vals_p=vals_p,
                nflux_m=np.asarray(nflux_m), nflux_p=np.asarray(nflux_p),
                interior=int_mask.reshape(KY, KX),
                dirichlet=dirichlet_f[f_ids].reshape(KY, KX),
            ))
        families.append(tuple(row))

    return StructuredAssemblyPlan(
        families=tuple(families), vol_qp=vol_qp, vol_G=vol_G,
        vol_wvals=vol_wvals, dof_perm=dof_perm, plan=plan,
        lattice=(KY, KX), nd=nd,
        sigma_i=inner_sigma(1), sigma_b=boundary_sigma(1), beta=default_beta(2),
    )


def geometric_soa_maps(order, plan: StructuredAssemblyPlan):
    """(to_soa, from_soa) flat index maps between the standard cell-major
    vector (original cell order, storage dof enumeration) and the
    role-enumerated SoA [nd, 8, KY, KX] layout of the structured assembly."""
    nd = plan.nd
    NC = order.num_cells
    inv = np.asarray(order.inv)  # new -> old
    # soa position (r, new) <- old flat index inv[new]*nd + perm[new, r]
    perm_flat = plan.dof_perm.reshape(NC, nd)
    to_soa = (inv[None, :] * nd + perm_flat.T).reshape(-1)
    from_soa = np.empty(NC * nd, dtype=np.int64)
    from_soa[to_soa] = np.arange(NC * nd)
    return to_soa.astype(np.int32), from_soa.astype(np.int32)


class PrecomputedCoefficient(NamedTuple):
    """Host-evaluated static scalar coefficient at all assembly quadrature
    points (the runtime permeability field still multiplies in)."""

    a_vol: np.ndarray   # [kq_v, 8, KY, KX]
    lam_m: np.ndarray   # [F, kq, KY, KX]
    lam_p: np.ndarray   # [F, kq, KY, KX]


def _families(plan: StructuredAssemblyPlan):
    return [plan.families[k][s] for k in range(8) for s in range(3)]


def precompute_coefficient(plan: StructuredAssemblyPlan, lam_fn,
                           dtype=np.float32) -> PrecomputedCoefficient:
    """Evaluate ``lam_fn`` in float64 on the host CPU, then cast to ``dtype``."""
    fams = _families(plan)

    def ev(points: np.ndarray) -> np.ndarray:
        return lam_fn(torch.from_numpy(points)).numpy().astype(dtype)

    return PrecomputedCoefficient(
        ev(plan.vol_qp),
        ev(np.stack([f.qp_m for f in fams])),
        ev(np.stack([f.qp_p for f in fams])))


class AssemblyTensors(NamedTuple):
    """The plan's constants and the precomputed coefficient on the device,
    in the working dtype; F = 24 face families f = k*3 + s."""

    a_vol: torch.Tensor      # [kq_v, 8, KY, KX]
    vol_G: torch.Tensor      # [8, kq_v, nd, nd]
    lam_m: torch.Tensor      # [F, kq, KY, KX]
    lam_p: torch.Tensor      # [F, kq, KY, KX]
    own_k: torch.Tensor      # [F] subclass of each family (long)
    qw: torch.Tensor         # [F, kq]
    inv_hb: torch.Tensor     # [F] 1 / h^beta
    interior: torch.Tensor   # [F, KY, KX] 0/1
    dirichlet: torch.Tensor  # [F, KY, KX] 0/1
    pen_mm: torch.Tensor     # [F, kq, nd, nd] v_m v_m
    pen_mp: torch.Tensor     # [F, kq, nd, nd] v_m v_p
    flux_mm: torch.Tensor    # [F, kq, nd, nd] v_m nf_m + nf_m v_m
    vn_p: torch.Tensor       # [F, kq, nd, nd] v_m nf_p
    nv_p: torch.Tensor       # [F, kq, nd, nd] nf_m v_p
    qp_x: torch.Tensor       # [kq_v, 8, KY, KX] volume quadrature x
    qp_y: torch.Tensor       # [kq_v, 8, KY, KX] volume quadrature y
    vol_wvals: torch.Tensor  # [8, kq_v, nd]
    neighbours: tuple        # [F] (k_src, dy, dx)
    plan: tuple
    lattice: Tuple[int, int]
    sigma_i: float
    sigma_b: float


def assembly_tensors(plan: StructuredAssemblyPlan, pre: PrecomputedCoefficient,
                     device, dtype=torch.float32) -> AssemblyTensors:
    """Move everything the per-call assembly reads to ``device`` (set-up)."""
    fams = _families(plan)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    vals_m = np.stack([f.vals_m for f in fams])   # [F, kq, nd]
    vals_p = np.stack([f.vals_p for f in fams])
    nfm = np.stack([f.nflux_m for f in fams])     # [F, nd]
    nfp = np.stack([f.nflux_p for f in fams])
    return AssemblyTensors(
        a_vol=t(pre.a_vol), vol_G=t(plan.vol_G),
        lam_m=t(pre.lam_m), lam_p=t(pre.lam_p),
        own_k=torch.as_tensor([f // 3 for f in range(len(fams))], device=device),
        qw=t(np.stack([f.qw for f in fams])),
        inv_hb=t(1.0 / np.array([f.h ** plan.beta for f in fams])),
        interior=t(np.stack([f.interior for f in fams])),
        dirichlet=t(np.stack([f.dirichlet for f in fams])),
        pen_mm=t(np.einsum("fqi,fqj->fqij", vals_m, vals_m)),
        pen_mp=t(np.einsum("fqi,fqj->fqij", vals_m, vals_p)),
        flux_mm=(t(np.einsum("fqi,fj->fqij", vals_m, nfm))
                 + t(np.einsum("fi,fqj->fqij", nfm, vals_m))),
        vn_p=t(np.einsum("fqi,fj->fqij", vals_m, nfp)),
        nv_p=t(np.einsum("fi,fqj->fqij", nfm, vals_p)),
        qp_x=t(plan.vol_qp[..., 0]), qp_y=t(plan.vol_qp[..., 1]),
        vol_wvals=t(plan.vol_wvals),
        neighbours=tuple((f.k_src, f.dy, f.dx) for f in fams),
        plan=plan.plan, lattice=plan.lattice,
        sigma_i=plan.sigma_i, sigma_b=plan.sigma_b,
    )


def assemble_structured_spe10(T: AssemblyTensors,
                              cell_field: torch.Tensor) -> StencilBlockEll:
    """Assemble the SWIPDG operator into planes [4, nd, nd, 8, KY, KX].

    ``cell_field`` [8, KY, KX]: the cell-constant permeability in SoA order;
    the total diffusion is a(x) = lam(x) * cell_field[cell].  All 24 face
    families are processed as one stacked batch."""
    KY, KX = T.lattice
    nd = _ND
    F = T.lam_m.shape[0]

    # --- volume ---
    a_vol = T.a_vol * cell_field[None]
    w0 = torch.einsum("qkyx,kqij->ijkyx", a_vol, T.vol_G)

    # --- faces ---
    a_m = T.lam_m * cell_field[T.own_k][:, None]
    nb = torch.stack([torch.roll(cell_field[ks], shifts=(-dy, -dx), dims=(0, 1))
                      for ks, dy, dx in T.neighbours])
    a_p = T.lam_p * nb[:, None]
    # side quantities (kappa = a*I): delta = a, flux_i = a * nflux_i
    denom = a_m + a_p
    zero = denom == 0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    w_m = torch.where(zero, torch.full_like(denom, 0.5), a_p / safe)
    gamma = torch.where(zero, torch.zeros_like(denom), a_m * a_p / safe)
    inv_hb = T.inv_hb[:, None, None, None]
    qw = T.qw[..., None, None]
    pen_q = qw * (T.sigma_i * gamma * inv_hb)
    wam_q = qw * (w_m * a_m)
    wap_q = qw * ((1.0 - w_m) * a_p)
    penb_q = qw * (T.sigma_b * a_m * inv_hb)
    am_q = qw * a_m

    def fam(weights, consts):
        return torch.einsum("fqyx,fqij->fijyx", weights, consts)

    # b[m,m] = sum_q qw ( pen v_m v_m - v_m wam nfm - wam nfm v_m )
    # b[m,p] = sum_q qw ( -pen v_m v_p - v_m wap nfp + wam nfm v_p )
    # (jump sign: [u] = u_m - u_p with n = n_out of m)
    b_mm_int = fam(pen_q, T.pen_mm) - fam(wam_q, T.flux_mm)
    b_mp_int = -fam(pen_q, T.pen_mp) - fam(wap_q, T.vn_p) + fam(wam_q, T.nv_p)
    b_mm_dir = fam(penb_q, T.pen_mm) - fam(am_q, T.flux_mm)

    interior = T.interior[:, None, None]
    self_add = interior * b_mm_int + T.dirichlet[:, None, None] * b_mm_dir
    nb_set = interior * b_mp_int
    # family f = k*3 + s: self contribution -> W0[:, :, k];
    # neighbour contribution -> plane s+1 at subclass k
    self_k = self_add.reshape(8, 3, nd, nd, KY, KX).sum(dim=1)
    w0 = w0 + torch.movedim(self_k, 0, 2)
    nb_planes = torch.movedim(nb_set.reshape(8, F // 8, nd, nd, KY, KX), (0, 1), (3, 0))
    planes = torch.cat([w0[None], nb_planes], dim=0)
    return StencilBlockEll(planes, T.plan)


def structured_rhs(T: AssemblyTensors, force_fn) -> torch.Tensor:
    """SoA rhs [nd, 8, KY, KX]: B[i] = sum_q f(qp_q) qw_q phi_i(qp_q).
    Valid when the force quadrature order <= the plan's volume order."""
    f = force_fn((T.qp_x, T.qp_y))  # [kq, 8, KY, KX]
    return torch.einsum("qkyx,kqi->ikyx", f, T.vol_wvals).contiguous()


def scale_planes(S: StencilBlockEll, B: torch.Tensor):
    """(S, B) -> (D^-1/2 A D^-1/2, D^-1/2 B, s = diag^-1/2): symmetric
    diagonal scaling in the plane layout."""
    nd = S.nd
    diag = torch.stack([S.planes[0, i, i] for i in range(nd)])  # [nd, 8, KY, KX]
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-30))
    fields = S.neighbor_fields(s)
    # planes[sl, i, j] *= s[i] * s_neighbor[j]
    scaled = torch.stack([S.planes[sl] * s[:, None] * fields[sl][None, :]
                          for sl in range(4)])
    return S.with_planes(scaled), B * s, s
