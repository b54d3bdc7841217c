"""SoA stencil form of the structured block operator, its two-level deflation
preconditioner and the mixed-precision refined PCG.

Counterpart of ``dune_hdd_tpu/la/stencil.py`` for the bench's path at up to
6 bisections.  The operator lives as planes W[slot, i, j, subclass, KY, KX]
(slot 0 = self) and vectors as X[nd, 8, KY, KX]; for a subclass-k cell at
lattice position (iy, ix) its geometric slot-s neighbour is the
subclass-``k_src`` cell at (iy+dy, ix+dx).  Reads that wrap around a lattice
axis meet zero blocks (domain boundary), so the per-axis wrap is harmless.

The SpMV is the hand-written kernel ``kernels/plane_spmv``; everything else
is plain torch on the planes' device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.plane_spmv import plane_spmv
from .block_ell import inv3x3

__all__ = [
    "StencilBlockEll",
    "stencil_plan",
    "jacobi_smoother",
    "stencil_deflation_preconditioner",
    "stencil_pcg",
    "stencil_refined_solve",
]


def stencil_plan(order) -> Tuple[Tuple[Tuple[int, int, int], ...], ...]:
    """Per (subclass k, slot s): (k_src, dy, dx) with the slot-s neighbour
    field of subclass k equal to roll2d(X[k_src], (-dy, -dx))."""
    KY, KX = order.lattice
    L = KY * KX
    NC = order.num_cells
    plan = []
    for k in range(8):
        row = []
        for s in range(3):
            o = int(order.offsets[k][s]) % NC
            oc = ((o + NC // 2) % NC) - NC // 2
            dk = int(np.round(oc / L))
            r = oc - dk * L
            dy = int(np.round(r / KX))
            dx = r - dy * KX
            if abs(dy) > 2 or abs(dx) > 2:
                raise ValueError(
                    f"offset {oc} for subclass {k} slot {s} is not a small "
                    f"lattice shift (dy={dy}, dx={dx})")
            row.append(((k + dk) % 8, dy, dx))
        plan.append(tuple(row))
    return tuple(plan)


class StencilBlockEll:
    """planes [4, nd, nd, 8, KY, KX] (slot 0 = self); plan: 8x3 static
    (k_src, dy, dx) lattice shifts.  ``spmv(planes, X, plan)`` applies the
    operator; it is the hand-written kernel unless a caller substitutes its
    plain version."""

    def __init__(self, planes: torch.Tensor, plan, spmv: Callable = plane_spmv):
        self.planes = planes
        self.plan = tuple(tuple(tuple(int(v) for v in e) for e in row)
                          for row in plan)
        self.spmv = spmv

    @property
    def nd(self) -> int:
        return self.planes.shape[1]

    @property
    def lattice(self) -> Tuple[int, int]:
        return self.planes.shape[-2], self.planes.shape[-1]

    def with_planes(self, planes: torch.Tensor) -> "StencilBlockEll":
        return StencilBlockEll(planes, self.plan, self.spmv)

    def astype(self, dtype: torch.dtype) -> "StencilBlockEll":
        return self.with_planes(self.planes.to(dtype))

    def neighbor_fields(self, X: torch.Tensor):
        """[4][nd, 8, KY, KX] neighbour fields (self + 3 slots) of X."""
        fields = [X]
        for s in range(3):
            per_k = []
            for k in range(8):
                ks, dy, dx = self.plan[k][s]
                per_k.append(torch.roll(X[:, ks], shifts=(-dy, -dx), dims=(1, 2)))
            fields.append(torch.stack(per_k, dim=1))
        return fields

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """X [nd, 8, KY, KX] -> A X in the same layout."""
        return self.spmv(self.planes, X.contiguous(), self.plan)

    def diagonal_blocks(self) -> torch.Tensor:
        """[nd, nd, 8, KY, KX]."""
        return self.planes[0]

    def row_sums(self) -> torch.Tensor:
        """[4, nd, 8, KY, KX] with AZ[s,i,c] = sum_j W[s,i,j,c]."""
        return self.planes.sum(dim=2)


# -- smoother ----------------------------------------------------------------


def jacobi_smoother(A: StencilBlockEll) -> Callable:
    """Blockwise inverse of the diagonal 3x3 blocks, SoA layout."""
    D = A.diagonal_blocks()  # [3, 3, 8, KY, KX]
    Dinv = torch.movedim(inv3x3(torch.movedim(D, (0, 1), (-2, -1))), (-2, -1), (0, 1))

    def apply(R: torch.Tensor) -> torch.Tensor:
        # fused multiply-adds in j order: the rounding of the reference's
        # XLA contraction
        return torch.stack([
            torch.addcmul(torch.addcmul(Dinv[i, 0] * R[0], Dinv[i, 1], R[1]), Dinv[i, 2], R[2])
            for i in range(3)])

    return apply


# -- two-level deflation in plane layout -------------------------------------


class _Aggregation(NamedTuple):
    aggsum: Callable      # [.., 8, KY, KX] -> [n_agg] (sums leading dims too)
    broadcast: Callable   # [n_agg] -> [8, KY, KX] scalar field
    mx: int
    my: int
    fy: int
    fx: int


def _aggregation(A: StencilBlockEll, macro_shape) -> Optional[_Aggregation]:
    """Piecewise-constant aggregation onto the (mx, my) macro lattice, with
    aggregate id = ix_macro * my + iy_macro (x-major: the block cyclic
    reduction of the coarse solve depends on this order)."""
    KY, KX = A.lattice
    mx, my = int(macro_shape[0]), int(macro_shape[1])
    if KX % mx or KY % my:
        return None
    fy, fx = KY // my, KX // mx

    def aggsum(R):
        lead = R.shape[:-3]
        nl = len(lead)
        rc = R.reshape(lead + (8, my, fy, mx, fx))
        dims = tuple(range(nl)) + (nl, nl + 2, nl + 4)
        return rc.sum(dim=dims).t().reshape(-1)  # [my,mx] -> [mx,my] flat

    def broadcast(yc):
        g = yc.reshape(mx, my).t()  # [my, mx]
        g = g[None, :, None, :, None].expand(8, my, fy, mx, fx)
        return g.reshape(8, my * fy, mx * fx).contiguous()

    return _Aggregation(aggsum, broadcast, mx, my, fy, fx)


def _crossings(f: int, d: int, n: int, device) -> dict:
    """{v: 0/1 float mask over lattice positions i} partitioning i by the
    aggregate offset v = (i+d)//f - i//f that the shift d produces.  The set
    of v is host arithmetic; the masks are built on the device."""
    i_host = np.arange(n)
    values = np.unique((i_host + d) // f - i_host // f)
    i = torch.arange(n, device=device)
    dA = torch.div(i + d, f, rounding_mode="floor") - torch.div(i, f, rounding_mode="floor")
    return {int(v): (dA == int(v)).to(torch.float32) for v in values}


def _coarse_bands(A: StencilBlockEll, agg: _Aggregation, P: torch.Tensor) -> dict:
    """Bands of E = Z_w^T A Z_w keyed by aggregate offset (vy, vx), each a
    [n_agg] vector in x-major order: each (subclass, slot) family
    contributes to at most 4 aggregate offsets (crossing 0/1 macro
    boundaries per axis).  ``P`` [4, 8, KY, KX]: the (weighted) pairing
    sums of the planes."""
    KY, KX = A.lattice
    my, fy, mx, fx = agg.my, agg.fy, agg.mx, agg.fx

    def ordered_sum(terms):
        """Sum over the leading axis, one term after the other: the order of
        the reference's XLA reductions.  E is ill-conditioned, so its
        rounding shows in the coarse solves."""
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc

    def x_major(v):  # [..., my, mx] -> [..., mx * my]
        return v.transpose(-1, -2).reshape(v.shape[:-2] + (mx * my,))

    # self slot: sum over (subclass, fy, fx) in row-major order
    self_terms = P[0].reshape(8, my, fy, mx, fx).permute(0, 2, 4, 1, 3).reshape(-1, my, mx)
    bands: dict = {(0, 0): x_major(ordered_sum(self_terms))}
    # every (subclass, slot) family's masked pairing field, then all their
    # aggregate sums at once
    keys, fields = [], []
    for s in range(3):
        for k in range(8):
            _, dy, dx = A.plan[k][s]
            masks_y = _crossings(fy, dy, KY, P.device)
            masks_x = _crossings(fx, dx, KX, P.device)
            for vy, m_y in masks_y.items():
                for vx, m_x in masks_x.items():
                    keys.append((vy, vx))
                    fields.append(P[s + 1, k] * (m_y[:, None] * m_x[None, :]).to(P.dtype))
    stacked = torch.stack(fields).reshape(len(fields), my, fy, mx, fx)
    stacked = stacked.permute(2, 4, 0, 1, 3).reshape(fy * fx, len(fields), my, mx)
    vecs = x_major(ordered_sum(stacked))  # [n_fields, n_agg]
    for key, vec in zip(keys, vecs):
        bands[key] = bands[key] + vec if key in bands else vec
    return bands


def _coarse_E_banded(A: StencilBlockEll, agg: _Aggregation, P: torch.Tensor) -> torch.Tensor:
    """Dense E = Z_w^T A Z_w from `_coarse_bands` (small coarse spaces only)."""
    mx, my = agg.mx, agg.my
    n = mx * my
    bands = _coarse_bands(A, agg, P)
    E = torch.zeros((n, n), dtype=A.planes.dtype, device=A.planes.device)
    a = torch.arange(n, device=A.planes.device)
    amx, amy = a // my, a % my
    for (vy, vx), vec in bands.items():
        off = vx * my + vy
        valid = ((amx + vx >= 0) & (amx + vx < mx)
                 & (amy + vy >= 0) & (amy + vy < my))
        # E[a, a + off] += vec[a] on valid rows; valid rows keep a + off in
        # range, so the band is exactly one diagonal of E
        vals = torch.where(valid, vec, torch.zeros_like(vec))
        E = E + torch.diag(vals[max(0, -off): n - max(0, off)], off)
    return E


def _block_tridiag_solve(B: torch.Tensor, C: torch.Tensor,
                         R: torch.Tensor) -> torch.Tensor:
    """Solve the symmetric block-tridiagonal system

        C_{i-1}^T y_{i-1} + B_i y_i + C_i y_{i+1} = r_i,  i = 0..n-1

    for a batch of right-hand sides by block cyclic reduction: log2(n)
    levels of batched [m,m] x [m,N] products.  B [n,m,m], C [n,m,m] with
    C[n-1] == 0, R [n,m,N]; n must be a power of two."""
    n = B.shape[0]
    if n == 1:
        return torch.linalg.solve(B[0], R[0])[None]
    Binv_odd = torch.linalg.inv(B[1::2])   # [n/2, m, m]
    CL = C[0::2]   # C[2e]   : even 2e   -> odd 2e+1
    CRo = C[1::2]  # C[2e+1] : odd 2e+1  -> even 2e+2  (last is C[n-1] = 0)
    G = CL @ Binv_odd
    H = CRo.transpose(-1, -2) @ Binv_odd
    T = H @ CRo
    B_new = B[0::2] - G @ CL.transpose(-1, -2)
    B_new = B_new - torch.cat([torch.zeros_like(T[:1]), T[:-1]], dim=0)
    C_new = -(G @ CRo)
    R_odd = R[1::2]
    R_new = R[0::2] - G @ R_odd
    HR = H @ R_odd
    R_new = R_new - torch.cat([torch.zeros_like(HR[:1]), HR[:-1]], dim=0)
    y_even = _block_tridiag_solve(B_new, C_new, R_new)
    # back-substitute odds: y[2e+1] = Binv (r - CL^T y[2e] - CRo y[2e+2])
    y_next = torch.cat([y_even[1:], torch.zeros_like(y_even[:1])], dim=0)
    y_odd = Binv_odd @ (R_odd - CL.transpose(-1, -2) @ y_even - CRo @ y_next)
    out = torch.empty((n,) + tuple(y_even.shape[1:]), dtype=y_even.dtype,
                      device=y_even.device)
    out[0::2] = y_even
    out[1::2] = y_odd
    return out


def _newton_schulz(Es: torch.Tensor, Einv: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` Newton-Schulz polish passes, then exact symmetrization."""
    two_eye = 2.0 * torch.eye(Es.shape[0], dtype=Es.dtype, device=Es.device)
    for _ in range(steps):
        Einv = Einv @ (two_eye - Es @ Einv)
    return 0.5 * (Einv + Einv.t())


def _coarse_inverse_bcr(E: torch.Tensor, mx: int, my: int,
                        newton_schulz: int = 2) -> Callable:
    """Dense symmetrized inverse of the diagonally-scaled coarse operator via
    block cyclic reduction (the x-major coarse lattice is block-tridiagonal
    with mx blocks of size my) + Newton-Schulz polish, in float32."""
    n_agg = mx * my
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30))
    Es = ((E / d[:, None]) / d[None, :]).to(torch.float32)
    E4 = Es.reshape(mx, my, mx, my)
    ix = torch.arange(mx, device=E.device)
    B = E4[ix, :, ix, :]                     # [mx, my, my]
    C = torch.cat([E4[ix[:-1], :, ix[:-1] + 1, :],
                   torch.zeros((1, my, my), dtype=Es.dtype, device=Es.device)])
    # pad mx to a power of two with decoupled identity blocks
    n2 = 1 << (mx - 1).bit_length()
    R = torch.eye(n_agg, dtype=Es.dtype, device=Es.device).reshape(mx, my, n_agg)
    if n2 != mx:
        eye = torch.eye(my, dtype=Es.dtype, device=Es.device).expand(n2 - mx, my, my)
        B = torch.cat([B, eye])
        C = torch.cat([C, torch.zeros((n2 - mx, my, my), dtype=Es.dtype, device=Es.device)])
        R = torch.cat([R, torch.zeros((n2 - mx, my, n_agg), dtype=Es.dtype,
                                      device=Es.device)])
    Einv = _block_tridiag_solve(B, C, R)[:mx].reshape(n_agg, n_agg)
    Einv = _newton_schulz(Es, Einv, newton_schulz)

    def solve(rc):
        y = Einv @ (rc / d).to(torch.float32)
        return (y / d).to(rc.dtype)

    return solve


def _coarse_inverse(E: torch.Tensor, newton_schulz: int = 3) -> Callable:
    """Dense symmetrized inverse of the diagonally-scaled coarse operator
    (float32 LU + Newton-Schulz polish)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(E).abs(), min=1e-30))
    Es = ((E / d[:, None]) / d[None, :]).to(torch.float32)
    Einv = _newton_schulz(Es, torch.linalg.inv(Es), newton_schulz)

    def solve(rc):
        y = Einv @ (rc / d).to(torch.float32)
        return (y / d).to(rc.dtype)

    return solve


def stencil_deflation_preconditioner(A: StencilBlockEll, macro_shape,
                                     weight: torch.Tensor,
                                     newton_schulz: int = 3) -> Callable:
    """Balanced two-level preconditioner in the plane layout,

        M^-1 r = Q r + (I - Q A) S (I - A Q) r,   Q = Z_w E^-1 Z_w^T,

    with S the block-Jacobi smoother and Z_w = diag(w) Z the weighted
    piecewise-constant aggregation onto ``macro_shape``.  ``weight``
    [nd, 8, KY, KX] is sqrt(diag A) = 1/s for a diagonally scaled system, so
    the coarse space contains the scaled near-kernel D^{1/2} 1.  The
    A-projections ride precomputed weighted AZ planes
    (AZ[s,i] = sum_j W[s,i,j] w_j(neighbour)) instead of full matvecs."""
    # weighted pairing sums P_w[s,k] = sum_ij w_i W[s,i,j] w_j(neighbour)
    wnbr = A.neighbor_fields(weight)  # [4][nd, 8, KY, KX]
    Pw = torch.stack([(weight[:, None] * A.planes[s] * wnbr[s][None, :]).sum(dim=(0, 1))
                      for s in range(4)])  # [4, 8, KY, KX]
    agg = _aggregation(A, macro_shape)
    if agg is None:
        raise ValueError(f"macro lattice {tuple(macro_shape)} does not tile "
                         f"the stencil lattice {A.lattice}")
    smoother = jacobi_smoother(A)
    if agg.fx >= 2 and agg.mx * agg.my > 4096:
        raise NotImplementedError("factored BCR coarse solve: later PR")
    E = _coarse_E_banded(A, agg, Pw)
    if agg.fx >= 2:
        # with >= 2 fine cells per aggregate in x the |dx| <= 2 shifts cross
        # at most one macro boundary: the coarse lattice is block-tridiagonal
        coarse = _coarse_inverse_bcr(E, agg.mx, agg.my, newton_schulz)
    else:
        # fx == 1: |dx| = 2 shifts couple macro columns two apart, which BCR
        # would drop
        coarse = _coarse_inverse(E, newton_schulz)

    AZ = torch.stack([(A.planes[s] * wnbr[s][None, :]).sum(dim=1)
                      for s in range(4)])  # [4, nd, 8, KY, KX]
    plan = A.plan

    def wsum(R):
        """Z_w^T R: weighted aggregate sums."""
        return agg.aggsum(R * weight)

    def wbcast(yc):
        """Z_w yc in the full [nd, 8, KY, KX] layout."""
        return agg.broadcast(yc)[None] * weight

    def a_broadcast(yc):
        """A (Z_w yc) via AZ planes + rolled broadcast."""
        B0 = agg.broadcast(yc)  # [8, KY, KX]
        out = AZ[0] * B0[None]
        for s in range(3):
            Bs = torch.stack([torch.roll(B0[ks], shifts=(-dy, -dx), dims=(0, 1))
                              for ks, dy, dx in (plan[k][s] for k in range(8))])
            out = out + AZ[s + 1] * Bs[None]
        return out

    def zt_a(Svec):
        """Z_w^T A s via AZ planes: scatter each slot's pairing back to the
        neighbour's lattice position with the inverse roll, then aggsum."""
        total = (AZ[0] * Svec).sum(dim=0)  # [8, KY, KX]
        for s in range(3):
            Ps = (AZ[s + 1] * Svec).sum(dim=0)
            out_k = [None] * 8
            for k in range(8):
                ks, dy, dx = plan[k][s]
                contrib = torch.roll(Ps[k], shifts=(dy, dx), dims=(0, 1))
                out_k[ks] = contrib if out_k[ks] is None else out_k[ks] + contrib
            # every slot's k -> k_src map is a bijection for the NVB subclasses
            if any(o is None for o in out_k):
                raise ValueError("stencil plan slot map is not bijective")
            total = total + torch.stack(out_k)
        return agg.aggsum(total)

    def apply(R):
        yc = coarse(wsum(R))
        s = smoother(R - a_broadcast(yc))
        return wbcast(yc) + s - wbcast(coarse(zt_a(s)))

    return apply


# -- mixed-precision refined PCG ---------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def stencil_pcg(A: StencilBlockEll, B: torch.Tensor, M: Callable,
                rtol: float = 1e-5, maxiter: int = 150, unroll: int = 4):
    """PCG in SoA layout, in B's dtype; returns (X, iterations).  The rhs is
    assumed pre-scaled to ||B|| = 1 so the recurrence residual is relative.

    Convergence is checked (one host sync) before every block of ``unroll``
    iterations, so the count is a multiple of ``unroll`` and may pass
    ``maxiter`` by less than ``unroll``."""
    X = torch.zeros_like(B)
    Z = M(B)
    P = Z
    rz = _dot(B, Z)
    R = B
    stop2 = torch.tensor(rtol * rtol, dtype=B.dtype).item()  # rounded like the dots
    k = 0
    while k < maxiter and _dot(R, R).item() > stop2:
        for _ in range(max(1, int(unroll))):
            AP = A.matvec(P)
            pap = _dot(P, AP)
            ok = pap > 0
            alpha = torch.where(ok, rz / torch.where(ok, pap, torch.ones_like(pap)),
                                torch.zeros_like(pap))
            X = X + alpha * P
            R = R - alpha * AP
            Z = M(R)
            rz_new = _dot(R, Z)
            ok = rz > 0
            beta = torch.where(ok, rz_new / torch.where(ok, rz, torch.ones_like(rz)),
                               torch.zeros_like(rz))
            P = Z + beta * P
            rz = rz_new
            k += 1
    return X, k


def stencil_refined_solve(A: StencilBlockEll, B: torch.Tensor, M: Callable,
                          tol: float = 1e-6, inner_iters: int = 150,
                          inner_rtol: float = 1e-5, outer_max: int = 6,
                          unroll: int = 4):
    """float32 deflated PCG inside float64 iterative refinement.  Returns
    (X float64, true relative residual, total inner iterations, outer
    sweeps).  Each sweep solves for the correction of the exact float64
    residual, which is recomputed with the float64 SpMV."""
    A64 = A.astype(torch.float64)
    B64 = B.to(torch.float64)
    bnorm = torch.linalg.norm(B64).item()
    target = tol * max(bnorm, 1e-300)
    X = torch.zeros_like(B64)
    R64 = B64
    rnorm = bnorm
    sweeps = iters = 0
    while rnorm > target and sweeps < outer_max:
        scale = rnorm
        dX, ki = stencil_pcg(A, (R64 / scale).to(torch.float32), M,
                             rtol=inner_rtol, maxiter=inner_iters, unroll=unroll)
        X = X + dX.to(torch.float64) * scale
        R64 = B64 - A64.matvec(X)
        rnorm = torch.linalg.norm(R64).item()
        sweeps += 1
        iters += ki
    return X, rnorm / max(bnorm, 1e-300), iters, sweeps
