"""Subdomain-aligned sharding with O(halo) ppermute neighbour exchange.

Counterpart of ``dune_hdd_tpu/parallel/halo.py``.  The reference's
BlockSWIPDG couples subdomains only through coupling faces
(block-swipdg.hh:308-326, 966-1025), so the off-diagonal blocks of the
global operator touch a boundary layer of DoFs per neighbour pair.
``ShardedAffineSystem`` (sharded.py) ignores that structure and
all-gathers the whole vector every CG iteration; here:

* rows are split into per-shard blocks aligned with the subdomains (each
  shard owns whole subdomains, padded per shard);
* each shard knows, per neighbour offset, exactly the remote DoFs its ELL
  rows reference (the discrete coupling-face halo), grouped by owner, so
  the exchange is a fixed set of ``ppermute`` rings;
* the SpMV gathers from ``cat(x_local, received buffers)`` through
  host-remapped column ids: O(sum of halo sizes) per iteration, not O(N).

The CG recurrence and reductions are ``sharded_cg``'s, so with the same row
split the solutions bit-match the all-gather path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..affine import AffineDecomposition
from .collectives import all_gather, pmax, ppermute, psum
from .sharded import Mesh, _numpy, _ShardedAffine

__all__ = ["HaloShardedSystem", "halo_exchange_spec", "halo_parameter_sweep"]


class _HaloPlan:
    """Host-side exchange plan: who sends what to whom, and the remapped
    column ids into the extended local vector."""

    def __init__(self, shifts, send_idx, recv_sizes, cols_ext, ext_size, perm_by_shift):
        self.shifts = shifts              # list[int] neighbour offsets (mod D)
        self.send_idx = send_idx          # list of [D, H_s] local send gathers
        self.recv_sizes = recv_sizes      # list[int] padded H_s per shift
        self.cols_ext = cols_ext          # [D, L, K] columns into x_ext
        self.ext_size = ext_size          # L + sum H_s + 1 (trailing zero slot)
        self.perm_by_shift = perm_by_shift  # list of [(src, dst), ...]


def _build_plan(ell_cols: np.ndarray, row_blocks: Sequence[np.ndarray],
                rows_per_device: int) -> _HaloPlan:
    """ell_cols [N, K] global columns; row_blocks[d] = global rows owned by
    shard d (unpadded).  Builds per-shift send gathers and extended-column
    remaps with shapes shared by the shards."""
    D = len(row_blocks)
    L = rows_per_device
    n = ell_cols.shape[0]
    owner = np.empty(n, dtype=np.int64)
    local_pos = np.empty(n, dtype=np.int64)
    for d, rows in enumerate(row_blocks):
        owner[rows] = d
        local_pos[rows] = np.arange(len(rows))

    # per (receiver d, shift s): global cols needed from owner (d+s) mod D
    needed: List[dict] = []
    shifts_set = set()
    for d, rows in enumerate(row_blocks):
        cols_d = np.unique(ell_cols[rows].reshape(-1))
        remote = cols_d[owner[cols_d] != d]
        by_shift: Dict[int, list] = {}
        for c in remote:
            s = int((owner[c] - d) % D)
            by_shift.setdefault(s, []).append(int(c))
        needed.append({s: np.asarray(v, dtype=np.int64) for s, v in by_shift.items()})
        shifts_set.update(by_shift.keys())
    shifts = sorted(shifts_set)

    send_idx, recv_sizes, perm_by_shift = [], [], []
    recv_cols: List[dict] = [{} for _ in range(D)]  # global col -> ext position, per shard
    offset = L
    for s in shifts:
        H = max(max((len(needed[d].get(s, ())) for d in range(D)), default=0), 1)
        idx = np.zeros((D, H), dtype=np.int64)
        for d in range(D):
            # shard d sends what receiver (d - s) mod D needs from it
            want = needed[int((d - s) % D)].get(s, np.empty(0, dtype=np.int64))
            idx[d, : len(want)] = local_pos[want]
        for d in range(D):
            want = needed[d].get(s, np.empty(0, dtype=np.int64))
            for j, c in enumerate(want):
                recv_cols[d][int(c)] = offset + j
        send_idx.append(idx)
        recv_sizes.append(H)
        perm_by_shift.append(tuple((int((d + s) % D), d) for d in range(D)))
        offset += H
    ext_size = offset + 1  # trailing zero slot for padded rows

    cols_ext = np.full((D, L, ell_cols.shape[1]), ext_size - 1, dtype=np.int64)
    for d, rows in enumerate(row_blocks):
        cmap = recv_cols[d]
        sub = ell_cols[rows]
        out = np.empty_like(sub)
        own_mask = owner[sub] == d
        out[own_mask] = local_pos[sub[own_mask]]
        out[~own_mask] = np.asarray([cmap[int(c)] for c in sub[~own_mask]], dtype=np.int64)
        cols_ext[d, : len(rows)] = out
    return _HaloPlan(shifts, send_idx, recv_sizes, cols_ext, ext_size, perm_by_shift)


def halo_exchange_spec(plan_or_system) -> dict:
    """Elements exchanged per shard per SpMV (the O(halo) volume), against
    the all-gather volume of ``ShardedAffineSystem``."""
    plan = getattr(plan_or_system, "plan", plan_or_system)
    return {
        "shifts": list(plan.shifts),
        "elements_per_spmv": int(sum(plan.recv_sizes)),
        "ext_size": int(plan.ext_size),
    }


class HaloShardedSystem(_ShardedAffine):
    """Affine ELL system split by whole subdomains with ppermute halos.

    The surface of ShardedAffineSystem (thetas / solve), but ``row_blocks``
    (from BlockSWIPDG's subdomain DoF maps, default the contiguous row
    split) decide ownership, rows are permuted shard-major and padded per
    shard, and the SpMV moves only the coupling-face halo.
    ``ell_vals_override``: per local shard [Q, L, K] values assembled on the
    shards (``parallel/sharded_assembly.py``)."""

    def __init__(self, operator: AffineDecomposition, rhs: AffineDecomposition, mesh: Mesh,
                 row_blocks: Optional[Sequence[np.ndarray]] = None, dtype=torch.float32,
                 ell_vals_override: Optional[Sequence[torch.Tensor]] = None):
        self.mesh = mesh
        n_dom = mesh.shape["domain"]
        expanded = operator.with_expanded_affine_part()
        rhs_expanded = rhs.with_expanded_affine_part()
        mats = list(expanded.components)
        self.op_coefficients = list(expanded.coefficients)
        self.rhs_coefficients = list(rhs_expanded.coefficients)
        pattern = mats[0].pattern
        n = pattern.shape[0]
        self.num_dofs = n
        if row_blocks is None:
            per = -(-n // n_dom)
            row_blocks = [np.arange(d * per, min((d + 1) * per, n)) for d in range(n_dom)]
        row_blocks = [np.asarray(b, dtype=np.int64) for b in row_blocks]
        if len(row_blocks) != n_dom:
            raise ValueError(f"{len(row_blocks)} row blocks for {n_dom} domain devices")
        L = max(len(b) for b in row_blocks)
        self.rows_per_device = L
        self.row_blocks = row_blocks
        ell_cols = np.asarray(pattern.ell_cols, dtype=np.int64)
        self.plan = _build_plan(ell_cols, row_blocks, L)
        self.dtype = dtype
        K, Q = ell_cols.shape[1], len(mats)

        offset = mesh.axis_offset("domain")
        local = range(offset, offset + mesh.devices.shape[-1])

        def padded(values_of, width_shape):
            out = []
            for d in local:
                rows = row_blocks[d]
                a = np.zeros(width_shape)
                for q, v in enumerate(values_of):
                    a[q, : len(rows)] = v[rows]
                out.append(a)
            return out

        if ell_vals_override is not None:
            vals = [v.to(dtype) for v in ell_vals_override]
            for v in vals:
                if tuple(v.shape) != (Q, L, K):
                    raise ValueError(f"assembled values {tuple(v.shape)}, expected {(Q, L, K)}")
        else:
            ell = [_numpy(m.pattern.ell_values(m.values)) for m in mats]
            vals = [torch.as_tensor(a).to(dtype) for a in padded(ell, (Q, L, K))]
        rhs_np = [_numpy(v) for v in rhs_expanded.components]
        rhs_local = [torch.as_tensor(a).to(dtype) for a in padded(rhs_np, (len(rhs_np), L))]
        self.ell_vals = self._rows(vals)
        self.rhs_stack = self._rows(rhs_local)
        self.cols_ext = self._rows([torch.as_tensor(self.plan.cols_ext[d]) for d in local])
        self.send_idx = [self._rows([torch.as_tensor(s[d]) for d in local])
                         for s in self.plan.send_idx]
        # the slot of each global row in the shard-major [D * L] layout
        self._slot_of_row = np.empty(n, dtype=np.int64)
        for d, rows in enumerate(row_blocks):
            self._slot_of_row[rows] = d * L + np.arange(len(rows))
        self._slot_of_row_t = torch.as_tensor(self._slot_of_row).to(mesh.devices.flat[0])

    def _rows(self, per_shard: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Per (mu row, local shard), each tensor moved to its device once
        per distinct device."""
        cache: Dict = {}
        rows = []
        for row in self.mesh.devices:
            out = []
            for d, device in enumerate(row):
                if (device, d) not in cache:
                    cache[(device, d)] = per_shard[d].to(device).contiguous()
                out.append(cache[(device, d)])
            rows.append(out)
        return rows

    def _matvec_body(self, row: int):
        """matvec(vals, x) over the shards of mesh row ``row``: one ppermute
        ring per neighbour offset, then the ELL product."""
        plan = self.plan
        span = self.mesh.axis_span("domain")
        cols = self.cols_ext[row]
        sends = [s[row] for s in self.send_idx]

        def matvec(vals, xs):
            parts = [[x] for x in xs]
            for s_i, perm in enumerate(plan.perm_by_shift):
                recv = ppermute([x[i] for x, i in zip(xs, sends[s_i])], perm, span)
                for p, r in zip(parts, recv):
                    p.append(r)
            out = []
            for v, c, p in zip(vals, cols, parts):
                x_ext = torch.cat(p + [p[0].new_zeros(1)])
                out.append((v * x_ext[c]).sum(dim=1))
            return out

        return matvec

    def _global(self, xs) -> torch.Tensor:
        """Per-shard solutions -> the solution in global row order."""
        flat = all_gather(xs, tiled=True, span=self.mesh.axis_span("domain"))[0]
        return flat.to(self._slot_of_row_t.device)[self._slot_of_row_t]

    def solve(self, mu, tol: float = 1e-6, maxiter: int = 1000) -> torch.Tensor:
        vals, b = self._frozen(0, self.thetas(self.op_coefficients, mu),
                               self.thetas(self.rhs_coefficients, mu))
        (x,) = _halo_cg([self._matvec_body(0)], [vals], [self.cols_ext[0]], [b],
                        self.mesh.axis_span("domain"), tol, maxiter)
        return self._global(x)


def _halo_cg(matvecs, vals, cols, bs, span, tol, maxiter, sync_axes=()):
    """Jacobi-preconditioned CG on the halo layout (``sharded_cg``'s
    recurrence and reductions), for the mesh rows in ``matvecs`` / ``vals``
    / ``cols`` / ``bs`` (lists over rows of lists over shards), run in
    lockstep.

    ``sync_axes``: ("mu",) when the rows solve different systems at once
    (the parameter sweep).  In the reference the matvec's ppermute is one
    collective over the whole mesh, so every shard must run the same number
    of iterations or the collective deadlocks; the loop condition is
    pmax-reduced over "mu" and converged rows keep iterating until the
    slowest finishes (0/0-guarded updates)."""

    def dot(a, c):
        return psum([(x * y).sum() for x, y in zip(a, c)], span)

    rows = range(len(matvecs))
    inv_diag = []
    for v_row, c_row in zip(vals, cols):
        out = []
        for v, c in zip(v_row, c_row):
            # own rows reference themselves at local position i
            on_diag = c == torch.arange(v.shape[0], device=v.device)[:, None]
            diag = torch.where(on_diag, v, torch.zeros_like(v)).sum(dim=1)
            out.append(torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)))
        inv_diag.append(out)

    def guarded(num, den):
        return [torch.where(q != 0, n / torch.where(q != 0, q, torch.ones_like(q)),
                            torch.zeros_like(q)) for n, q in zip(num, den)]

    x = [[torch.zeros_like(b) for b in b_row] for b_row in bs]
    r = [list(b_row) for b_row in bs]
    z = [[d * ri for d, ri in zip(inv_diag[m], r[m])] for m in rows]
    p = [list(z_row) for z_row in z]
    rz = [dot(r[m], z[m]) for m in rows]
    atol2 = []
    for m in rows:
        bnorm = torch.sqrt(dot(bs[m], bs[m])[0])
        atol2.append((tol * torch.clamp(bnorm, min=1e-30)) ** 2)

    def unconverged() -> bool:
        flags = [(dot(r[m], r[m])[0] > atol2[m]).to(torch.int32) for m in rows]
        if "mu" in sync_axes:
            flags = pmax(flags)
        return bool(flags[0] > 0)

    k = 0
    while k < maxiter and unconverged():
        for m in rows:
            ap = matvecs[m](vals[m], p[m])
            alpha = guarded(rz[m], dot(p[m], ap))
            x[m] = [xi + a * pi for xi, a, pi in zip(x[m], alpha, p[m])]
            r[m] = [ri - a * api for ri, a, api in zip(r[m], alpha, ap)]
            z[m] = [d * ri for d, ri in zip(inv_diag[m], r[m])]
            rz_new = dot(r[m], z[m])
            beta = guarded(rz_new, rz[m])
            p[m] = [zi + be * pi for zi, be, pi in zip(z[m], beta, p[m])]
            rz[m] = rz_new
        k += 1
    return x


def halo_parameter_sweep(system: HaloShardedSystem, thetas_op: torch.Tensor,
                         thetas_rhs: torch.Tensor, tol: float = 1e-6,
                         maxiter: int = 1000) -> torch.Tensor:
    """A batch of parameters split over the "mu" mesh axis, each solve on
    the O(halo) ppermute exchange over "domain"; the rows' trip counts are
    pmax-synchronised as in the reference.

    thetas_op [B, Q_op], thetas_rhs [B, Q_rhs] -> [B, num_dofs] solutions in
    global row order, on the mesh's first device."""
    mesh = system.mesh
    if "mu" not in mesh.shape:
        raise ValueError("mesh needs a 'mu' axis for the parameter sweep")
    M = mesh.shape["mu"]
    B = thetas_op.shape[0]
    if B % M:
        raise ValueError(f"a batch of {B} does not split over {M} mu shards")
    per = B // M
    matvecs = [system._matvec_body(m) for m in range(M)]
    out: List[Optional[torch.Tensor]] = [None] * B
    for i in range(per):
        items = [m * per + i for m in range(M)]
        frozen = [system._frozen(m, torch.as_tensor(thetas_op[j]).to(system.dtype),
                                 torch.as_tensor(thetas_rhs[j]).to(system.dtype))
                  for m, j in enumerate(items)]
        xs = _halo_cg(matvecs, [f[0] for f in frozen], system.cols_ext, [f[1] for f in frozen],
                      mesh.axis_span("domain"), tol, maxiter, sync_axes=("mu",))
        for j, x in zip(items, xs):
            out[j] = system._global(x)
    return torch.stack(out)
