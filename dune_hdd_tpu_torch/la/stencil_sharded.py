"""Multi-shard execution of the plane-layout stencil solver.

Counterpart of ``dune_hdd_tpu/la/stencil_sharded.py``.  The plane operator
shards naturally in slabs along the lattice x-axis.  Every neighbour access
is a lattice shift with |dx| <= 2, so each shard needs a 2-column halo from
its ring neighbours, and since the single-shard roll wraps (onto zero
blocks), a ring ``ppermute`` reproduces it exactly: shard 0's left halo is
shard D-1's right edge.  Each slab's matvec is the plane SpMV kernel in its
slab mode (``kernels/plane_spmv.plane_spmv_slab``), so the D-slab matvec is
bitwise the single-shard ``plane_spmv``.

Per iteration the exchange is 2 x [nd, 8, KY, 2] columns per shard and the
dots are ``psum``.  The two-level deflation stays slab-local: the macro
columns partition along x with the slabs, so Z^T r needs no communication
but the all-gather of the small coarse vector; the coarse operator is
``psum``-assembled once per solve and its block-cyclic-reduction inverse is
computed on every shard.

Shards are the devices of the mesh's "domain" axis (``parallel/sharded``);
they may repeat, so four slabs can share one card.  ``lower_solve`` of the
reference is JAX ahead-of-time plumbing and has no counterpart.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import highest_precision
from ..kernels.plane_spmv import SLAB_HALO, plane_spmv_slab, slab_neighbor_fields
from ..parallel.collectives import all_gather, ppermute, psum
from .stencil import StencilBlockEll, _coarse_inverse_bcr, jacobi_smoother

__all__ = ["ShardedStencilSystem"]


class ShardedStencilSystem:
    """Plane-layout system split over the mesh's "domain" axis in x-slabs.

    planes [4, nd, nd, 8, KY, KX] with KX % D == 0; with ``macro``
    (mx, my), additionally mx % D == 0 so aggregates stay slab-local.
    ``weight``: the deflation space Z_w = diag(w) Z (on a diagonally scaled
    system pass w = 1/s)."""

    def __init__(self, S: StencilBlockEll, B: torch.Tensor, mesh,
                 macro: Optional[Tuple[int, int]] = None,
                 weight: Optional[torch.Tensor] = None):
        D = mesh.shape["domain"]
        KY, KX = S.lattice
        if KX % D:
            raise ValueError(f"KX={KX} not divisible by {D} devices")
        if macro is not None and macro[0] % D:
            raise ValueError(f"macro mx={macro[0]} not divisible by {D}")
        self.mesh = mesh
        self.plan = S.plan
        self.macro = macro
        self.nd = S.nd
        self.lattice = (KY, KX)
        self.span = mesh.axis_span("domain")
        self.devices = mesh.axis_devices("domain")
        # axis index of each local slab
        self.slabs = [mesh.axis_offset("domain") + d for d in range(len(self.devices))]
        self.width = KX // D
        self.planes = self._split(S.planes)
        self.B = self._split(B)
        self.weight = None if weight is None else self._split(weight)

    def _split(self, T: torch.Tensor) -> List[torch.Tensor]:
        Wd = self.width
        return [T[..., g * Wd:(g + 1) * Wd].to(dev).contiguous()
                for g, dev in zip(self.slabs, self.devices)]

    # -- shard-local pieces --------------------------------------------------
    def _halo_ext(self, Xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each slab with SLAB_HALO columns of each ring neighbour attached."""
        D = self.mesh.shape["domain"]
        if D > 1:
            ring = range(D)
            # my left halo = left neighbour's right edge, and vice versa
            left = ppermute([X[..., -SLAB_HALO:] for X in Xs], [(i, (i + 1) % D) for i in ring],
                            self.span)
            right = ppermute([X[..., :SLAB_HALO] for X in Xs], [(i, (i - 1) % D) for i in ring],
                             self.span)
            return [torch.cat([lf, X, rt], dim=-1) for lf, X, rt in zip(left, Xs, right)]
        return [torch.cat([X[..., -SLAB_HALO:], X, X[..., :SLAB_HALO]], dim=-1) for X in Xs]

    def _neighbor_fields_local(self, Xs):
        """[4][nd, 8, KY, Wd] neighbour fields (self + 3 slots) per slab."""
        return [slab_neighbor_fields(e, self.plan) for e in self._halo_ext(Xs)]

    def _matvec_local(self, Ws, Xs):
        """Per-slab A X: ring halos, then the slab SpMV kernel."""
        return [plane_spmv_slab(W, e, self.plan) for W, e in zip(Ws, self._halo_ext(Xs))]

    def _jacobi_local(self, Ws):
        """Per slab, the blockwise inverse of the diagonal blocks."""
        return [jacobi_smoother(StencilBlockEll(W, self.plan)) for W in Ws]

    def _coarse_E_local(self, W, g, wl=None, wn=None) -> torch.Tensor:
        """Slab g's part of E = Z_w^T A Z_w [n_agg, n_agg]: its rows' plane
        pairing sums scattered onto the global aggregate pairs (one sorting
        accumulate, the same in every build)."""
        KY, KX = self.lattice
        D = self.mesh.shape["domain"]
        mx, my = self.macro
        mxl, Wd = mx // D, self.width
        fy, fx = KY // my, Wd // mxl
        n_agg = mx * my
        if wl is None:
            P = W.sum(dim=(1, 2))  # [4, 8, KY, Wd]
        else:
            P = torch.stack([(wl[:, None] * W[s] * wn[s][None, :]).sum(dim=(0, 1))
                             for s in range(4)])
        iy = np.arange(KY)[:, None]
        ixg = np.arange(Wd)[None, :] + g * Wd  # global x of the local columns
        row = np.broadcast_to((ixg // fx) * my + iy // fy, (KY, Wd))
        rows = np.broadcast_to(row, (4, 8, KY, Wd))
        cols = np.empty((4, 8, KY, Wd), dtype=np.int64)
        valid = np.ones((4, 8, KY, Wd), dtype=bool)
        cols[0] = row
        for s in range(3):
            for k in range(8):
                _, dy, dx = self.plan[k][s]
                cols[s + 1, k] = (((ixg + dx) % KX) // fx) * my + ((iy + dy) % KY) // fy
                # wrapped entries carry zero blocks; masked all the same
                valid[s + 1, k] = ((ixg + dx >= 0) & (ixg + dx < KX)
                                   & (iy + dy >= 0) & (iy + dy < KY))
        dev = P.device
        flat = torch.as_tensor((rows * n_agg + cols).reshape(-1)).to(dev)
        sums = P.reshape(-1) * torch.as_tensor(valid.reshape(-1)).to(dev, P.dtype)
        E = torch.zeros(n_agg * n_agg, dtype=P.dtype, device=dev)
        return E.index_put_((flat,), sums, accumulate=True).reshape(n_agg, n_agg)

    def _deflation_local(self, Ws, matvec, smoothers, newton_schulz: int = 2, wloc=None):
        """Balanced two-level deflation with slab-local aggregation: the
        coarse operator is psum-assembled and inverted on every shard."""
        KY, _ = self.lattice
        D = self.mesh.shape["domain"]
        mx, my = self.macro
        mxl, Wd = mx // D, self.width
        fy, fx = KY // my, Wd // mxl
        nloc = mxl * my

        def aggsum_local(R):
            # R [nd, 8, KY, Wd] -> [mxl * my] local aggregates, x-major
            rc = R.reshape(R.shape[:-2] + (my, fy, mxl, fx))
            lead = tuple(range(R.dim() - 2))
            return rc.sum(dim=lead + (R.dim() - 1, R.dim() + 1)).t().reshape(-1)

        def broadcast_local(yc_local, shape):
            g = yc_local.reshape(mxl, my).t()
            g = g[:, None, :, None].expand(my, fy, mxl, fx).reshape(KY, Wd)
            return g.expand(shape)

        def to_global(parts):
            # device g owns aggregate ids [g mxl my, (g + 1) mxl my)
            return all_gather(parts, tiled=True, span=self.span)

        if wloc is None:
            Es = [self._coarse_E_local(W, g) for W, g in zip(Ws, self.slabs)]
        else:
            wn = self._neighbor_fields_local(wloc)
            Es = [self._coarse_E_local(W, g, wl, f)
                  for W, g, wl, f in zip(Ws, self.slabs, wloc, wn)]
        solves, built = [], {}
        for E in psum(Es, self.span):
            if id(E) not in built:  # one inverse per distinct (per-device) E
                built[id(E)] = _coarse_inverse_bcr(E, mx, my, newton_schulz)
            solves.append(built[id(E)])

        weights = wloc if wloc is not None else [None] * len(Ws)

        def wsum(R, w):
            return aggsum_local(R if w is None else R * w)

        def wbcast(yc, g, shape, w):
            part = broadcast_local(yc[g * nloc:(g + 1) * nloc], shape)
            return part if w is None else part * w

        def apply_balanced(Rs):
            rc = to_global([wsum(R, w) for R, w in zip(Rs, weights)])
            Qr = [wbcast(solve(r), g, R.shape, w)
                  for solve, r, g, R, w in zip(solves, rc, self.slabs, Rs, weights)]
            AQr = matvec(Qr)
            s_ = [sm(R - a) for sm, R, a in zip(smoothers, Rs, AQr)]
            zc = to_global([wsum(v, w) for v, w in zip(matvec(s_), weights)])
            return [q + s - wbcast(solve(z), g, R.shape, w)
                    for q, s, solve, z, g, R, w in zip(Qr, s_, solves, zc, self.slabs, Rs,
                                                       weights)]

        return apply_balanced

    # -- solve ---------------------------------------------------------------
    def solve(self, tol: float = 1e-6, inner_iters: int = 150, inner_rtol: float = 1e-5,
              outer_max: int = 6, unroll: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 deflated PCG inside f64 refinement over the slabs.  Returns
        (X [nd, 8, KY, KX] on the first shard's device, the true relative
        residual of the float64 refinement)."""
        highest_precision()
        Ws = self.planes

        def dot(a, b):
            return psum([torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)],
                        self.span)

        def matvec(Xs):
            return self._matvec_local(Ws, Xs)

        smoothers = self._jacobi_local(Ws)
        if self.macro is not None:
            M = self._deflation_local(Ws, matvec, smoothers, wloc=self.weight)
        else:
            def M(Rs):
                return [sm(R) for sm, R in zip(smoothers, Rs)]
        W64 = [W.double() for W in Ws]

        def matvec64(Xs):
            return self._matvec_local(W64, Xs)

        B64 = [b.double() for b in self.B]
        bnorm = torch.sqrt(dot(B64, B64)[0])
        target = tol * torch.clamp(bnorm, min=1e-300)

        def pcg(R32):
            X = [torch.zeros_like(r) for r in R32]
            R = R32
            Z = M(R)
            Pv = Z
            rz = dot(R, Z)
            stop2 = inner_rtol ** 2
            k = 0
            while k < inner_iters and bool(dot(R, R)[0] > stop2):
                for _ in range(max(1, int(unroll))):
                    AP = matvec(Pv)
                    pap = dot(Pv, AP)
                    alpha = [torch.where(p > 0, r / torch.where(p > 0, p, torch.ones_like(p)),
                                         torch.zeros_like(p)) for p, r in zip(pap, rz)]
                    X = [x + a * p for x, a, p in zip(X, alpha, Pv)]
                    R = [r - a * ap for r, a, ap in zip(R, alpha, AP)]
                    Z = M(R)
                    rz_new = dot(R, Z)
                    beta = [torch.where(o > 0, n / torch.where(o > 0, o, torch.ones_like(o)),
                                        torch.zeros_like(o)) for n, o in zip(rz_new, rz)]
                    Pv = [z + b * p for z, b, p in zip(Z, beta, Pv)]
                    rz = rz_new
                    k += 1
            self.last_inner_iterations += k
            return X

        self.last_inner_iterations = 0
        X = [torch.zeros_like(b) for b in B64]
        rnorm = bnorm
        k = 0
        while k < outer_max and bool(rnorm > target):
            R64 = [b - ax for b, ax in zip(B64, matvec64(X))]
            scale = torch.sqrt(dot(R64, R64)[0])
            dX = pcg([(r / scale).float() for r in R64])
            X = [x + d.double() * scale for x, d in zip(X, dX)]
            R64 = [b - ax for b, ax in zip(B64, matvec64(X))]
            rnorm = torch.sqrt(dot(R64, R64)[0])
            k += 1
        self.last_outer_sweeps = k
        first = self.devices[0]
        X_full = torch.cat(all_gather(X, tiled=False, span=self.span)[0].to(first).unbind(0),
                           dim=-1)
        return X_full, rnorm / torch.clamp(bnorm, min=1e-300)
