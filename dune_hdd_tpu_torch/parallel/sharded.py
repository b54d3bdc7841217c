"""Sharded execution of affine block systems: the device mesh, the row-split
ELL system and its CG, and the parameter sweep.

Counterpart of ``dune_hdd_tpu/parallel/sharded.py``.  The reference runs
single-controller ``jax.shard_map`` over a ``Mesh``; the port keeps that
model without JAX:

* a ``Mesh`` is an object array of ``torch.device`` shaped by its named
  axes, and the devices may repeat (four shards on ``cuda:0`` are what
  eight virtual CPU devices are to the reference);
* a shard-local body runs once per shard, on per-shard tensors held in
  lists in shard order;
* the collectives are explicit functions over those lists
  (``parallel/collectives.py``); after ``initialize_distributed`` the mesh's
  last axis spans the processes and each collective adds a
  ``torch.distributed`` leg.

"domain" axis: the DoF rows of the global ELL operator are split over the
shards; the SpMV all-gathers x and the CG dots are ``psum``.  "mu" axis: a
batch of parameters is split over the mesh rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..device import highest_precision
from .collectives import ProcessSpan, all_gather, psum
from .distributed import is_distributed

__all__ = [
    "Mesh",
    "make_device_mesh",
    "ShardedAffineSystem",
    "sharded_cg",
    "sharded_parameter_sweep",
]


class Mesh:
    """Devices [axis sizes] with named axes; ``shape[name]`` is the axis
    size over all processes.  ``span`` (or None): the processes the last
    axis is split over, this process holding its slice of that axis."""

    def __init__(self, devices, axis_names: Sequence[str], span: Optional[ProcessSpan] = None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.span = span
        sizes = list(arr.shape)
        if span is not None:
            sizes[-1] *= span.count
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    def axis_span(self, name: str) -> Optional[ProcessSpan]:
        """The process split of axis ``name`` (None: the axis is local)."""
        return self.span if name == self.axis_names[-1] else None

    def axis_devices(self, name: str) -> list:
        """This process's devices along axis ``name``, at index 0 of the
        other axes."""
        arr = np.moveaxis(self.devices, self.axis_names.index(name), -1)
        return list(arr.reshape(-1, arr.shape[-1])[0])

    def axis_offset(self, name: str) -> int:
        """The axis index of this process's first shard along ``name``."""
        span = self.axis_span(name)
        return 0 if span is None else span.index * self.devices.shape[self.axis_names.index(name)]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def _devices(devices) -> List[torch.device]:
    """The given devices, or every visible card (raising without one)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass CPU devices to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(mu_axis: int = 1, domain_axis: Optional[int] = None,
                     devices=None) -> Mesh:
    """Mesh with ("mu", "domain") axes over ``devices`` (default: every
    visible card; a device may repeat).  After ``initialize_distributed``
    the "domain" axis spans the processes, each process giving its own
    devices."""
    devices = _devices(devices)
    n = len(devices)
    if domain_axis is None:
        domain_axis = n // mu_axis
    if mu_axis * domain_axis != n:
        raise ValueError(f"{mu_axis} x {domain_axis} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    span = None
    if is_distributed():
        import torch.distributed as dist

        span = ProcessSpan(dist.get_world_size(), dist.get_rank())
    return Mesh(arr.reshape(mu_axis, domain_axis), ("mu", "domain"), span)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    pad = rows - a.shape[0]
    if pad == 0:
        return a
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def thetas(coefficients, mu, dtype) -> torch.Tensor:
    """[Q] theta_q(mu) on the host, in ``dtype``."""
    return torch.stack([torch.as_tensor(c(mu)).to("cpu", dtype).reshape(()) for c in coefficients])


class _RowShards:
    """Per-(mu row, domain shard) placement of row-split host arrays: the
    slice of shard d goes to each row's device once per distinct device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.offset = mesh.axis_offset("domain")

    def place(self, array: np.ndarray, axis: int, dtype) -> List[List[torch.Tensor]]:
        per = array.shape[axis] // self.mesh.shape["domain"]
        host = torch.as_tensor(array).to(dtype)
        cache: Dict = {}
        rows = []
        for row in self.mesh.devices:
            out = []
            for d, device in enumerate(row):
                key = (device, d)
                if key not in cache:
                    g = self.offset + d
                    cache[key] = host.narrow(axis, g * per, per).to(device).contiguous()
                out.append(cache[key])
            rows.append(out)
        return rows


class _ShardedAffine:
    """The theta contraction shared by the sharded affine systems, whose
    ``ell_vals`` [mu][d] -> [Q, L, K] and ``rhs_stack`` [mu][d] -> [Qr, L]
    hold each shard's component values."""

    def thetas(self, decomposition_coeffs, mu) -> torch.Tensor:
        return thetas(decomposition_coeffs, mu, self.dtype)

    def _frozen(self, row: int, th_op: torch.Tensor, th_rhs: torch.Tensor):
        """Per shard of mesh row ``row``, the frozen values and rhs (full
        float32 products: TF32 stays off)."""
        highest_precision()
        vals = [torch.einsum("q,qnk->nk", th_op.to(v.device), v) for v in self.ell_vals[row]]
        b = [torch.einsum("q,qn->n", th_rhs.to(r.device), r) for r in self.rhs_stack[row]]
        return vals, b


class ShardedAffineSystem(_ShardedAffine):
    """An affine family of ELL operators + rhs, row-split over "domain".

    Stacks the Q component value arrays as ELL [Q, N_pad, K] with global
    column ids and N padded to a multiple of the domain axis; ``solve(mu)``
    freezes (the theta contraction) and runs the Jacobi CG with mesh
    collectives on the first mesh row."""

    def __init__(self, operator: AffineDecomposition, rhs: AffineDecomposition,
                 mesh: Mesh, dtype=torch.float32):
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
        self.n_pad = ((n + n_dom - 1) // n_dom) * n_dom
        self.dtype = dtype
        ell_cols = _pad_rows(np.asarray(pattern.ell_cols, dtype=np.int64), self.n_pad)
        ell_vals = np.stack([_pad_rows(_numpy(m.pattern.ell_values(m.values)), self.n_pad)
                             for m in mats])
        rhs_stack = np.stack([_pad_rows(_numpy(v), self.n_pad) for v in rhs_expanded.components])
        shards = _RowShards(mesh)
        self.ell_vals = shards.place(ell_vals, 1, dtype)    # [mu][d] -> [Q, N/D, K]
        self.ell_cols = shards.place(ell_cols, 0, torch.int64)
        self.rhs_stack = shards.place(rhs_stack, 1, dtype)  # [mu][d] -> [Qr, N/D]

    def solve(self, mu, tol: float = 1e-6, maxiter: int = 1000) -> torch.Tensor:
        """Freeze at mu and run the sharded CG; the unpadded solution on the
        mesh's first device."""
        vals, b = self._frozen(0, self.thetas(self.op_coefficients, mu),
                               self.thetas(self.rhs_coefficients, mu))
        span = self.mesh.axis_span("domain")
        x = sharded_cg(vals, self.ell_cols[0], b, span, tol=tol, maxiter=maxiter,
                       offset=self.mesh.axis_offset("domain"))
        return all_gather(x, tiled=True, span=span)[0][: self.num_dofs]


def sharded_cg(ell_vals_local: Sequence[torch.Tensor], ell_cols_local: Sequence[torch.Tensor],
               b_local: Sequence[torch.Tensor], span: Optional[ProcessSpan] = None,
               tol: float = 1e-6, maxiter: int = 1000, offset: int = 0) -> List[torch.Tensor]:
    """Jacobi-preconditioned CG on a row-split ELL matrix: per shard
    [L, K] values and global columns and [L] rhs, in shard order (``offset``:
    the axis index of the first).  The SpMV all-gathers x, the dots are
    ``psum``.  Returns the per-shard solutions."""

    def matvec(xs):
        full = all_gather(xs, tiled=True, span=span)
        return [(v * f[c]).sum(dim=1) for v, c, f in zip(ell_vals_local, ell_cols_local, full)]

    def dot(a, c):
        return psum([(x * y).sum() for x, y in zip(a, c)], span)

    # local diagonal for the Jacobi preconditioner, from global row ids
    inv_diag = []
    for i, (v, c) in enumerate(zip(ell_vals_local, ell_cols_local)):
        n_local = v.shape[0]
        rows_global = (offset + i) * n_local + torch.arange(n_local, device=v.device)
        diag = torch.where(c == rows_global[:, None], v, torch.zeros_like(v)).sum(dim=1)
        inv_diag.append(torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)))

    x = [torch.zeros_like(b) for b in b_local]
    r = list(b_local)
    z = [d * ri for d, ri in zip(inv_diag, r)]
    p = z
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b_local, b_local)[0])
    atol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
    k = 0
    while k < maxiter and bool(dot(r, r)[0] > atol2):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = [a / q for a, q in zip(rz, pap)]
        x = [xi + al * pi for xi, al, pi in zip(x, alpha, p)]
        r = [ri - al * api for ri, al, api in zip(r, alpha, ap)]
        z = [d * ri for d, ri in zip(inv_diag, r)]
        rz_new = dot(r, z)
        p = [zi + (rn / ro) * pi for zi, rn, ro, pi in zip(z, rz_new, rz, p)]
        rz = rz_new
        k += 1
    return x


def sharded_parameter_sweep(system: ShardedAffineSystem, thetas_op: torch.Tensor,
                            thetas_rhs: torch.Tensor, tol: float = 1e-6,
                            maxiter: int = 1000) -> torch.Tensor:
    """Solve a batch of parameters: the batch is split over the "mu" mesh
    axis (data parallelism), each solve row-split over "domain".

    thetas_op [B, Q_op], thetas_rhs [B, Q_rhs] -> solutions [B, N_pad] on
    the mesh's first device."""
    mesh = system.mesh
    rows = mesh.shape["mu"]
    B = thetas_op.shape[0]
    if B % rows:
        raise ValueError(f"a batch of {B} does not split over {rows} mu shards")
    per = B // rows
    span = mesh.axis_span("domain")
    first = mesh.devices.flat[0]
    out = []
    for i in range(B):
        row = i // per
        vals, b = system._frozen(row, torch.as_tensor(thetas_op[i]).to(system.dtype),
                                 torch.as_tensor(thetas_rhs[i]).to(system.dtype))
        x = sharded_cg(vals, system.ell_cols[row], b, span, tol=tol, maxiter=maxiter,
                       offset=mesh.axis_offset("domain"))
        out.append(all_gather(x, tiled=True, span=span)[0].to(first))
    return torch.stack(out)
