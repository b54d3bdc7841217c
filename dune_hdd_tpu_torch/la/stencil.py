"""SoA stencil form of the structured block operator, its symmetric form,
its two- and multi-level deflation preconditioners and the mixed-precision
refined PCG.

Counterpart of ``dune_hdd_tpu/la/stencil.py`` for the bench's path and the
``stencil_cg`` solver option of the SWIPDG discretization (the factored BCR
coarse solve for more than 4096 aggregates is not ported).  The
operator lives as planes W[slot, i, j, subclass, KY, KX]
(slot 0 = self) and vectors as X[nd, 8, KY, KX]; for a subclass-k cell at
lattice position (iy, ix) its geometric slot-s neighbour is the
subclass-``k_src`` cell at (iy+dy, ix+dx).  Reads that wrap around a lattice
axis meet zero blocks (domain boundary), so the per-axis wrap is harmless.

The SpMV is the hand-written kernel ``kernels/plane_spmv``; everything else
is plain torch on the planes' device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.plane_spmv import plane_spmv
from .block_ell import BlockEllMatrix, _structured_gather, inv3x3

__all__ = [
    "StencilBlockEll",
    "stencil_plan",
    "soa_index_maps",
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


class _SoAMaps(NamedTuple):
    to_soa: np.ndarray    # [nd*NC] flat gather: soa_flat = x[to_soa]
    from_soa: np.ndarray  # [NC*nd] flat gather: x = soa_flat[from_soa]


def soa_index_maps(order, nd: int) -> _SoAMaps:
    """Index maps between the flat cell-major vector in the ORIGINAL cell
    order and the SoA [nd, 8, KY, KX] layout (flattened)."""
    NC = order.num_cells
    inv = np.asarray(order.inv)   # new -> old
    perm = np.asarray(order.perm)  # old -> new
    # soa position (j, new) <- old flat index inv[new]*nd + j
    to_soa = (inv[None, :] * nd + np.arange(nd)[:, None]).reshape(-1)
    # old flat (old, j) <- soa flat j*NC + perm[old]
    from_soa = (np.arange(nd)[None, :] * NC + perm[:, None]).reshape(-1)
    return _SoAMaps(to_soa.astype(np.int32), from_soa.astype(np.int32))


class StencilBlockEll:
    """planes [4, nd, nd, 8, KY, KX] (slot 0 = self); plan: 8x3 static
    (k_src, dy, dx) lattice shifts.  ``spmv(planes, X, plan)`` applies the
    operator; it is the hand-written kernel unless a caller substitutes its
    plain version.

    A symmetric operator (:meth:`symmetrized`) keeps the assembled
    ``planes``, from which the preconditioner is built, and applies
    ``sym_planes``: the exactly symmetric operator that the reference's
    half-storage ``_matvec_sym`` applies, materialized once."""

    def __init__(self, planes: torch.Tensor, plan, spmv: Callable = plane_spmv,
                 sym_planes: Optional[torch.Tensor] = None):
        self.planes = planes
        self.plan = tuple(tuple(tuple(int(v) for v in e) for e in row)
                          for row in plan)
        self.spmv = spmv
        self.sym_planes = sym_planes

    @property
    def sym(self) -> bool:
        return self.sym_planes is not None

    @classmethod
    def from_block_ell(cls, A: BlockEllMatrix, order) -> "StencilBlockEll":
        """The plane layout of a BlockEllMatrix on a structured grid: one
        gather of the block array (set-up, ~1 pass over the operator)."""
        cell_idx, slot_idx = _structured_gather(A, order)
        dev = A.blocks.device
        blocks = A.blocks[torch.as_tensor(cell_idx).to(dev), torch.as_tensor(slot_idx).to(dev)]
        KY, KX = order.lattice
        nd = A.nd
        planes = blocks.reshape(8, KY, KX, 4, nd, nd).permute(3, 4, 5, 0, 1, 2).contiguous()
        return cls(planes, stencil_plan(order))

    @property
    def nd(self) -> int:
        return self.planes.shape[1]

    @property
    def lattice(self) -> Tuple[int, int]:
        return self.planes.shape[-2], self.planes.shape[-1]

    @property
    def num_cells(self) -> int:
        return 8 * self.planes.shape[-2] * self.planes.shape[-1]

    @property
    def matvec_planes(self) -> torch.Tensor:
        """The planes that :meth:`matvec` applies."""
        return self.planes if self.sym_planes is None else self.sym_planes

    def with_planes(self, planes: torch.Tensor) -> "StencilBlockEll":
        return StencilBlockEll(planes, self.plan, self.spmv)

    def astype(self, dtype: torch.dtype) -> "StencilBlockEll":
        """The operator in ``dtype``; a symmetric one stays symmetric (the
        symmetrization only moves values, so it commutes with the cast)."""
        sym_planes = None if self.sym_planes is None else self.sym_planes.to(dtype)
        return StencilBlockEll(self.planes.to(dtype), self.plan, self.spmv, sym_planes)

    def _sym_forward_edges(self):
        """12 forward (k, s) edges covering each undirected coupling once,
        with the reverse (k_src, s') partner.  Raises if the plan is not
        symmetric (it is for the NVB subclass structure)."""
        pairs = {}
        for k in range(8):
            for s in range(3):
                ks, dy, dx = self.plan[k][s]
                rev = None
                for sp in range(3):
                    if self.plan[ks][sp] == (k, -dy, -dx):
                        rev = sp
                if rev is None:
                    raise ValueError(f"stencil plan has no reverse edge for (k={k}, s={s})")
                pairs[(k, s)] = (ks, rev)
        return [(e, pairs[e]) for e in pairs if e < pairs[e]]

    def symmetrized(self) -> "StencilBlockEll":
        """The same operator with the exactly symmetric planes beside the
        assembled ones: the self block's upper triangle used both ways, and
        for each forward edge (k, s) ~ (ks, sp) with shift (dy, dx) the
        reverse slot Wsym[sp+1, j, i, ks] = roll(W[s+1, i, j, k], (dy, dx)).
        It differs from the assembled operator within assembly roundoff."""
        W = self.planes
        nd = self.nd
        Ws = torch.empty_like(W)
        for i in range(nd):
            for j in range(nd):
                Ws[0, i, j] = W[0, min(i, j), max(i, j)]
        written = set()
        for (k, s), (ks, sp) in self._sym_forward_edges():
            _, dy, dx = self.plan[k][s]
            Ws[s + 1, :, :, k] = W[s + 1, :, :, k]
            Ws[sp + 1, :, :, ks] = torch.roll(W[s + 1, :, :, k], shifts=(dy, dx),
                                              dims=(-2, -1)).transpose(0, 1)
            written |= {(k, s), (ks, sp)}
        if len(written) != 24:
            raise ValueError("stencil plan's forward edges do not cover all 24 slots")
        return StencilBlockEll(W, self.plan, self.spmv, Ws)

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
        """X [nd, 8, KY, KX] -> A X in the same layout (the symmetric
        operator when ``sym``)."""
        return self.spmv(self.matvec_planes, X.contiguous(), self.plan)

    def diagonal_blocks(self) -> torch.Tensor:
        """[nd, nd, 8, KY, KX]."""
        return self.planes[0]

    def row_sums(self) -> torch.Tensor:
        """[4, nd, 8, KY, KX] with AZ[s,i,c] = sum_j W[s,i,j,c]."""
        return self.planes.sum(dim=2)


# -- smoother ----------------------------------------------------------------


def jacobi_smoother(A: StencilBlockEll) -> Callable:
    """Blockwise inverse of the diagonal nd x nd blocks, SoA layout (the
    closed-form 3x3 inverse for P1, ``torch.linalg.inv`` above)."""
    D = torch.movedim(A.diagonal_blocks(), (0, 1), (-2, -1))  # [8, KY, KX, nd, nd]
    nd = A.nd
    Dinv = torch.movedim(inv3x3(D) if nd == 3 else torch.linalg.inv(D), (-2, -1), (0, 1))

    def apply(R: torch.Tensor) -> torch.Tensor:
        # fused multiply-adds in j order: the rounding of the reference's
        # XLA contraction
        out = []
        for i in range(nd):
            t = Dinv[i, 0] * R[0]
            for j in range(1, nd):
                t = torch.addcmul(t, Dinv[i, j], R[j])
            out.append(t)
        return torch.stack(out)

    return apply


# -- aggregation, coarse bands and coarse solves in plane layout -------------


class _Aggregation2D(NamedTuple):
    """Fine plane layout -> 2D coarse lattice field [my, mx] (rows = y)."""

    aggsum: Callable      # [.., 8, KY, KX] -> [my, mx] (sums leading dims too)
    broadcast: Callable   # [my, mx] -> [8, KY, KX]
    mx: int
    my: int
    fy: int
    fx: int


def _aggregation2d(A: StencilBlockEll, macro_shape) -> Optional[_Aggregation2D]:
    """Piecewise-constant aggregation onto the (mx, my) lattice, kept as a
    2D [my, mx] field (the middle levels' layout)."""
    KY, KX = A.lattice
    mx, my = int(macro_shape[0]), int(macro_shape[1])
    if KX % mx or KY % my:
        return None
    fy, fx = KY // my, KX // mx

    def aggsum(R):
        lead = R.shape[:-3]
        nl = len(lead)
        rc = R.reshape(lead + (8, my, fy, mx, fx))
        return rc.sum(dim=tuple(range(nl)) + (nl, nl + 2, nl + 4))

    def broadcast(yc):
        return yc[None, :, None, :, None].expand(8, my, fy, mx, fx).reshape(8, my * fy, mx * fx)

    return _Aggregation2D(aggsum, broadcast, mx, my, fy, fx)


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
    agg = _aggregation2d(A, macro_shape)
    if agg is None:
        return None
    mx, my = agg.mx, agg.my

    def aggsum(R):
        return agg.aggsum(R).t().reshape(-1)  # [my,mx] -> [mx,my] flat

    def broadcast(yc):
        return agg.broadcast(yc.reshape(mx, my).t())

    return _Aggregation(aggsum, broadcast, mx, my, agg.fy, agg.fx)


def _crossing_masks(f: int, d: int, n: int) -> dict:
    """{v: bool[n]} partition of lattice positions i by the aggregate offset
    v = (i+d)//f - i//f that the shift d produces under f-fold aggregation.
    Out-of-domain targets keep their arithmetic v: their stencil weights are
    zero, so they contribute nothing."""
    i = np.arange(n)
    dA = (i + d) // f - i // f
    return {int(v): (dA == v) for v in np.unique(dA)}


@lru_cache(maxsize=None)
def _mask_vectors(f: int, d: int, n: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """((v, 0/1 mask on the device), ...) of ``_crossing_masks``, copied to
    the device once per lattice (a copy from the host waits for the device)."""
    return tuple((v, torch.as_tensor(m, dtype=dtype).to(device))
                 for v, m in _crossing_masks(f, d, n).items())


def _masked_fields(field: torch.Tensor, f: Tuple[int, int], d: Tuple[int, int]):
    """[(vy, vx), field * mask] for every aggregate offset the 2D shift d
    produces under the (fy, fx) aggregation of field's last two axes."""
    (fy, fx), (dy, dx) = f, d
    n_y, n_x = field.shape[-2:]
    out = []
    for vy, wy in _mask_vectors(fy, dy, n_y, field.dtype, field.device):
        for vx, wx in _mask_vectors(fx, dx, n_x, field.dtype, field.device):
            out.append(((vy, vx), field * wy[:, None] * wx[None, :]))
    return out


def _ordered_sum(terms) -> torch.Tensor:
    """Sum over the leading axis (or a list), one term after the other: the
    order of the reference's XLA reductions.  The coarse operators are
    ill-conditioned, so their rounding shows in the coarse solves."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _block_sums(field: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """[..., my*fy, mx*fx] -> [..., my, mx]: sums over each fy x fx block in
    row-major order (``_ordered_sum``)."""
    ny, nx = field.shape[-2:]
    t = field.reshape(field.shape[:-2] + (ny // fy, fy, nx // fx, fx))
    return _ordered_sum([t[..., a, :, b] for a in range(fy) for b in range(fx)])


def _accumulate(keys, contribs) -> dict:
    """{key: sum of its contributions}, keys in first-seen order, each sum
    taken in order (the reference's ``bands.get(key, 0) + contrib``)."""
    out: dict = {}
    for key, c in zip(keys, contribs):
        out[key] = out[key] + c if key in out else c
    return out


def _coarse_bands(A: StencilBlockEll, agg: _Aggregation, P: torch.Tensor) -> dict:
    """Bands of E = Z_w^T A Z_w keyed by aggregate offset (vy, vx), each a
    [n_agg] vector in x-major order: each (subclass, slot) family
    contributes to at most 4 aggregate offsets (crossing 0/1 macro
    boundaries per axis).  ``P`` [4, 8, KY, KX]: the (weighted) pairing
    sums of the planes."""
    my, fy, mx, fx = agg.my, agg.fy, agg.mx, agg.fx

    def x_major(v):  # [..., my, mx] -> [..., mx * my]
        return v.transpose(-1, -2).reshape(v.shape[:-2] + (mx * my,))

    # self slot: sum over (subclass, fy, fx) in row-major order
    self_terms = P[0].reshape(8, my, fy, mx, fx).permute(0, 2, 4, 1, 3).reshape(-1, my, mx)
    # every (subclass, slot) family's masked pairing field, then all their
    # aggregate sums at once
    keys, fields = [(0, 0)], []
    for s in range(3):
        for k in range(8):
            for key, field in _masked_fields(P[s + 1, k], (fy, fx), A.plan[k][s][1:]):
                keys.append(key)
                fields.append(field)
    vecs = x_major(_block_sums(torch.stack(fields), fy, fx))  # [n_fields, n_agg]
    return _accumulate(keys, [x_major(_ordered_sum(self_terms))] + list(vecs))


def _stencil_bands(A: StencilBlockEll, agg: _Aggregation2D,
                   P: Optional[torch.Tensor] = None) -> dict:
    """Galerkin coarse operator E = Z^T A Z of the piecewise-constant
    aggregation as stencil bands {(vy, vx): [my, mx]} on the coarse lattice
    (E[a, a+v] = band[v][a]), applied with rolls.  ``P`` [4, 8, KY, KX]: the
    per-(slot, subclass) pairing sums (default 1^T W 1; the w-weighted sums
    for a weighted deflation space Z_w)."""
    fy, fx = agg.fy, agg.fx
    if P is None:
        P = A.planes.sum(dim=(1, 2))
    keys, fields = [], []
    for s in range(3):
        for k in range(8):
            for key, field in _masked_fields(P[s + 1, k], (fy, fx), A.plan[k][s][1:]):
                keys.append(key)
                fields.append(field)
    contribs = _block_sums(torch.stack(fields), fy, fx)  # [n_fields, my, mx]
    self_band = _block_sums(_ordered_sum(P[0]), fy, fx)
    return _accumulate([(0, 0)] + keys, [self_band] + list(contribs))


def _band_matvec(bands: dict) -> Callable:
    """y[a] = sum_v band[v][a] * x[a+v] via 2-axis rolls (band entries whose
    target is out of domain are zero, so the wrap reads are harmless)."""
    diag = bands[(0, 0)]
    off = [(v, b) for v, b in bands.items() if v != (0, 0)]

    def mv(x):
        out = diag * x
        for (vy, vx), b in off:
            out = torch.addcmul(out, b, torch.roll(x, shifts=(-vy, -vx), dims=(0, 1)))
        return out

    return mv


def _aggregate_bands(bands: dict, my: int, mx: int, gy: int, gx: int) -> dict:
    """Re-aggregate stencil bands on an [my, mx] lattice by (gy, gx) -> bands
    on the [my//gy, mx//gx] lattice (Galerkin: Z2^T E Z2)."""
    keys, fields = [], []
    for v, b in bands.items():
        for key, field in _masked_fields(b, (gy, gx), v):
            keys.append(key)
            fields.append(field)
    return _accumulate(keys, list(_block_sums(torch.stack(fields), gy, gx)))


def _bands_to_dense(bands: dict, my: int, mx: int) -> torch.Tensor:
    """Dense float32 [mx*my, mx*my] operator from stencil bands, in the
    x-major flat ordering id = ax*my + ay of ``_coarse_inverse_bcr``.  Each
    entry comes from one band (a key fixes the column offset), so one
    scatter of all bands writes E; its indices cross from the host once."""
    ay, ax = np.mgrid[0:my, 0:mx]
    n = mx * my
    src, dst = [], []
    for i, (vy, vx) in enumerate(bands):
        by, bx = ay + vy, ax + vx
        valid = (by >= 0) & (by < my) & (bx >= 0) & (bx < mx)
        src.append(i * n + np.flatnonzero(valid))  # in the stacked [n_bands, my, mx]
        dst.append((ax * my + ay)[valid] * n + (bx * my + by)[valid])
    vals = torch.stack(list(bands.values())).to(torch.float32).reshape(-1)
    idx = torch.as_tensor(np.stack([np.concatenate(src), np.concatenate(dst)])).to(vals.device)
    E = torch.zeros(n * n, dtype=torch.float32, device=vals.device)
    E[idx[1]] = vals[idx[0]]
    return E.reshape(n, n)


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


_FACTORED_BCR = ("the factored BCR coarse solve for more than 4096 aggregates "
                 "is not ported yet (ROADMAP queue 1, step 4b)")


def _exact_inverse(E: torch.Tensor, mx: int, my: int, fx: int,
                   newton_schulz: int) -> Callable:
    """The exact coarse solve of a dense x-major E: BCR when the aggregation
    factor in x is >= 2 (the coarse lattice is then block-tridiagonal), the
    dense LU inverse when fx == 1 (|dx| = 2 shifts couple macro columns two
    apart, which BCR would drop)."""
    if fx >= 2 and mx * my > 4096:
        raise NotImplementedError(_FACTORED_BCR)
    if fx >= 2:
        return _coarse_inverse_bcr(E, mx, my, newton_schulz)
    return _coarse_inverse(E, newton_schulz)


# -- Chebyshev acceleration and the middle levels ----------------------------


def _power_lambda_max(matvec: Callable, precond: Callable, shape, dtype,
                      device=None, iters: int = 12, seed: int = 0) -> torch.Tensor:
    """Power iteration for lambda_max(precond o matvec) from the reference's
    numpy start vector (set-up time)."""
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(shape), dtype=dtype).to(device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = precond(matvec(v))
        v = w / torch.linalg.norm(w)
    w = precond(matvec(v))
    return _dot(v, w) / _dot(v, v)


def _cheb_apply(matvec: Callable, precond: Callable, degree: int, lmax,
                ratio: float = 8.0, lmax_safety: float = 1.1) -> Callable:
    """Chebyshev polynomial approximation of (matvec)^-1 preconditioned by
    ``precond`` on the spectral interval [lmax/ratio, lmax] of
    precond o matvec: a fixed symmetric positive operator, safe as (part of)
    a PCG preconditioner.  The recurrence's scalars are taken once, on the
    host, in lmax's precision (one sync at set-up)."""
    f = np.float32 if lmax.dtype == torch.float32 else np.float64
    lmax = f(lmax.item()) * f(lmax_safety)
    lmin = lmax / f(ratio)
    theta = f(0.5) * (lmax + lmin)
    delta = f(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f(1.0) / sigma
    coeffs = []
    for _ in range(degree - 1):
        rho_new = f(1.0) / (f(2.0) * sigma - rho)
        coeffs.append((float(rho_new * rho), float(f(2.0) * rho_new / delta)))
        rho = rho_new
    theta = float(theta)

    def apply(R):
        d = precond(R) / theta
        x = d
        for c_d, c_p in coeffs:
            r = R - matvec(x)
            d = torch.add(c_d * d, precond(r), alpha=c_p)
            x = x + d
        return x

    return apply


def _multilevel_inverse(bands1: dict, my1: int, mx1: int, shapes,
                        newton_schulz: int = 2, cheb_degree: int = 2,
                        cheb_ratio: float = 8.0, dtype=torch.float32) -> Callable:
    """Approximate inverse of the stencil operator E1 (bands on an [my1, mx1]
    lattice).  ``shapes``: successively coarser (mx, my) lattices below it;
    the last one is solved exactly (dense BCR / LU), every intermediate one
    by recursion.  Each level is the balanced two-level operator (Jacobi on
    the band diagonal + the next level's inverse as its coarse solve),
    Chebyshev-wrapped for ``cheb_degree`` >= 2, so the chain is a fixed SPD
    operator and the enclosing PCG stays a valid PCG.  Raises ValueError
    where a lattice does not tile the one above it."""
    mx2, my2 = int(shapes[0][0]), int(shapes[0][1])
    if mx1 % mx2 or my1 % my2:
        raise ValueError(f"lattice {(mx2, my2)} does not tile {(mx1, my1)}")
    gy, gx = my1 // my2, mx1 // mx2
    bands2 = _aggregate_bands(bands1, my1, mx1, gy, gx)
    if len(shapes) == 1:
        E2 = _bands_to_dense(bands2, my2, mx2)
        coarse2_flat = _exact_inverse(E2, mx2, my2, gx, newton_schulz)

        def coarse2(r2d):  # [my2, mx2] -> [my2, mx2] via the x-major flat solve
            return coarse2_flat(r2d.t().reshape(-1)).reshape(mx2, my2).t()
    else:
        coarse2 = _multilevel_inverse(bands2, my2, mx2, shapes[1:],
                                      newton_schulz=newton_schulz, cheb_degree=cheb_degree,
                                      cheb_ratio=cheb_ratio, dtype=dtype)
    E1mv = _band_matvec(bands1)
    d1 = bands1[(0, 0)]
    Dinv = torch.where(d1 != 0, 1.0 / torch.where(d1 != 0, d1, torch.ones_like(d1)),
                       torch.zeros_like(d1))

    def Q2(r):  # aggregate sums, coarse solve, broadcast back
        yc = coarse2(r.reshape(my2, gy, mx2, gx).sum(dim=(1, 3)))
        return yc[:, None, :, None].expand(my2, gy, mx2, gx).reshape(my1, mx1)

    def P1(r):
        qr = Q2(r)
        s = Dinv * (r - E1mv(qr))
        return qr + s - Q2(E1mv(s))

    if cheb_degree < 2:
        return P1
    lmax = _power_lambda_max(E1mv, P1, (my1, mx1), dtype, device=d1.device)
    return _cheb_apply(E1mv, P1, cheb_degree, lmax, ratio=cheb_ratio)


def stencil_deflation_preconditioner(A: StencilBlockEll, macro_shape,
                                     weight: torch.Tensor,
                                     newton_schulz: int = 3, mid_shape=None,
                                     mid_cheb: int = 2) -> Callable:
    """Balanced two- or three-level preconditioner in the plane layout,

        M^-1 r = Q r + (I - Q A) S (I - A Q) r,   Q = Z_w E^-1 Z_w^T,

    with S the block-Jacobi smoother and Z_w = diag(w) Z the weighted
    piecewise-constant aggregation onto ``macro_shape``.  ``weight``
    [nd, 8, KY, KX] is sqrt(diag A) = 1/s for a diagonally scaled system, so
    the coarse space contains the scaled near-kernel D^{1/2} 1.  The
    A-projections ride precomputed weighted AZ planes
    (AZ[s,i] = sum_j W[s,i,j] w_j(neighbour)) instead of full matvecs.

    ``mid_shape=(mx1, my1)``, or a finest-first list of such shapes: the
    three-level (multi-level) form for lattices where the ``macro_shape``
    space alone degrades.  Z_w aggregates onto the first mid lattice; its
    Galerkin operator E1 is a 9-point stencil of bands, inverted
    approximately by ``_multilevel_inverse`` down to the exact
    ``macro_shape`` level, Chebyshev-wrapped with degree ``mid_cheb``.
    The preconditioner is built from ``A.planes``, the assembled operator,
    also when A applies its symmetrized planes."""
    # weighted pairing sums P_w[s,k] = sum_ij w_i W[s,i,j] w_j(neighbour)
    wnbr = A.neighbor_fields(weight)  # [4][nd, 8, KY, KX]
    Pw = torch.stack([(weight[:, None] * A.planes[s] * wnbr[s][None, :]).sum(dim=(0, 1))
                      for s in range(4)])  # [4, 8, KY, KX]
    if mid_shape is not None:
        mids = ([tuple(mid_shape)] if isinstance(mid_shape[0], (int, np.integer))
                else [tuple(m) for m in mid_shape])
        agg = _aggregation2d(A, mids[0])
    else:
        agg = _aggregation(A, macro_shape)
    if agg is None:
        raise ValueError(f"aggregation lattice {tuple(mid_shape or macro_shape)} does not "
                         f"tile the stencil lattice {A.lattice}")
    smoother = jacobi_smoother(A)
    if mid_shape is not None:
        coarse = _multilevel_inverse(_stencil_bands(A, agg, Pw), agg.my, agg.mx,
                                     mids[1:] + [tuple(macro_shape)],
                                     newton_schulz=newton_schulz, cheb_degree=mid_cheb,
                                     dtype=A.planes.dtype)
    else:
        coarse = _exact_inverse(_coarse_E_banded(A, agg, Pw), agg.mx, agg.my, agg.fx,
                                newton_schulz)

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
                rtol: float = 1e-5, maxiter: int = 150, unroll: int = 4,
                dot_dtype: Optional[torch.dtype] = None,
                vec_dtype: Optional[torch.dtype] = None):
    """PCG in SoA layout; returns (X, iterations).  The rhs is assumed
    pre-scaled to ||B|| = 1 so the recurrence residual is relative.  The
    matvec and the preconditioner run in B's dtype; ``vec_dtype`` (default
    B's) is the dtype of the Krylov vectors X, R, Z, P and their updates, and
    ``dot_dtype`` (default B's) that of the three inner products.

    Convergence is checked (one host sync) before every block of ``unroll``
    iterations, so the count is a multiple of ``unroll`` and may pass
    ``maxiter`` by less than ``unroll``."""
    adt = B.dtype
    vdt = vec_dtype or adt
    dt = dot_dtype or adt

    def apply_in_adt(op, V):
        return op(V.to(adt)).to(vdt)

    def vdot(a, b):
        return _dot(a.to(dt), b.to(dt))

    B = B.to(vdt)
    X = torch.zeros_like(B)
    Z = apply_in_adt(M, B)
    P = Z
    rz = vdot(B, Z)
    R = B
    stop2 = torch.tensor(rtol * rtol, dtype=dt).item()  # rounded like the dots
    k = 0
    while k < maxiter and vdot(R, R).item() > stop2:
        for _ in range(max(1, int(unroll))):
            AP = apply_in_adt(A.matvec, P)
            pap = vdot(P, AP)
            ok = pap > 0
            alpha = torch.where(ok, rz / torch.where(ok, pap, torch.ones_like(pap)),
                                torch.zeros_like(pap)).to(vdt)
            X = X + alpha * P
            R = R - alpha * AP
            Z = apply_in_adt(M, R)
            rz_new = vdot(R, Z)
            ok = rz > 0
            beta = torch.where(ok, rz_new / torch.where(ok, rz, torch.ones_like(rz)),
                               torch.zeros_like(rz)).to(vdt)
            P = Z + beta * P
            rz = rz_new
            k += 1
    return X, k


def stencil_refined_solve(A: StencilBlockEll, B: torch.Tensor, M: Callable,
                          tol: float = 1e-6, inner_iters: int = 150,
                          inner_rtol: float = 1e-5, outer_max: int = 6,
                          unroll: int = 4, dot_dtype: Optional[torch.dtype] = None,
                          vec_dtype: Optional[torch.dtype] = None):
    """float32 deflated PCG inside float64 iterative refinement.  Returns
    (X float64, true relative residual, total inner iterations, outer
    sweeps).  Each sweep solves for the correction of the exact float64
    residual, which is recomputed with the float64 SpMV (of the symmetric
    operator when A is symmetric).  ``dot_dtype``/``vec_dtype`` go to
    :func:`stencil_pcg`."""
    # only the planes that A applies: a symmetric A's assembled planes would
    # be a float64 copy that no matvec reads
    A64 = StencilBlockEll(A.matvec_planes.to(torch.float64), A.plan, A.spmv)
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
                             rtol=inner_rtol, maxiter=inner_iters, unroll=unroll,
                             dot_dtype=dot_dtype, vec_dtype=vec_dtype)
        X = X + dX.to(torch.float64) * scale
        R64 = B64 - A64.matvec(X)
        rnorm = torch.linalg.norm(R64).item()
        sweeps += 1
        iters += ki
    return X, rnorm / max(bnorm, 1e-300), iters, sweeps
