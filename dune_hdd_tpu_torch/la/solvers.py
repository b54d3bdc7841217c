"""Linear solvers + options registry.

Counterpart of ``dune_hdd_tpu/la/solvers.py``.  The Krylov methods follow
``jax.scipy.sparse.linalg.cg`` / ``bicgstab`` / ``gmres``: relative ``tol`` on ||b||
(non-legacy scipy semantics), ``atol`` 0, ``x0`` zero by default, ``M``
applied to the residual, maxiter 10 N by default, and the same stopping
test before every iteration.  The loop runs on the device: an iteration
after the stopping test has failed changes nothing (its step lengths are
masked to zero on the device), and the host reads the test once every
``CHECK_EVERY`` iterations, so the solution and iteration count are the
ones of the loop that stops exactly, at one host sync per block.  GMRES
(:func:`gmres`) reads its residual estimate once per Arnoldi step.
"direct" densifies up to 4096 rows and runs a sparse LU
(``scipy.sparse.linalg.spsolve``) on the host above that.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from .sparse import SparseMatrix

__all__ = ["solver_types", "solver_options", "solve", "make_preconditioner", "cg", "bicgstab",
           "gmres"]

CHECK_EVERY = 8  # iterations between host reads of the stopping test

_DEFAULT_OPTS = {
    "direct": {"type": "direct"},
    # handled by the DG discretizations; listed so solver_options() documents them
    "block_cg.jacobi": {"type": "block_cg.jacobi", "max_iter": 10000, "precision": 1e-10},
    "stencil_cg": {"type": "stencil_cg", "max_iter": 10000, "precision": 1e-10},
    "cg": {"type": "cg", "max_iter": 10000, "precision": 1e-10},
    "cg.jacobi": {"type": "cg.jacobi", "max_iter": 10000, "precision": 1e-10},
    "bicgstab": {"type": "bicgstab", "max_iter": 10000, "precision": 1e-10},
    "bicgstab.jacobi": {"type": "bicgstab.jacobi", "max_iter": 10000, "precision": 1e-10},
    "gmres": {"type": "gmres", "max_iter": 2000, "restart": 50, "precision": 1e-10},
    "gmres.jacobi": {"type": "gmres.jacobi", "max_iter": 2000, "restart": 50, "precision": 1e-10},
}


def solver_types() -> List[str]:
    """Available solver ids; the first entry is the default."""
    return ["bicgstab.jacobi", "cg.jacobi", "cg", "bicgstab", "gmres.jacobi",
            "gmres", "direct", "block_cg.jacobi", "stencil_cg"]


def solver_options(type_: Optional[str] = None) -> Dict:
    type_ = type_ or solver_types()[0]
    if type_ not in _DEFAULT_OPTS:
        raise ValueError(f"unknown solver type {type_!r}; available: {solver_types()}")
    return dict(_DEFAULT_OPTS[type_])


def make_preconditioner(matrix: SparseMatrix, kind: str) -> Optional[Callable]:
    if kind == "jacobi":
        inv_diag = 1.0 / matrix.diagonal()
        return lambda r: inv_diag * r
    if kind in (None, "", "none"):
        return None
    raise ValueError(f"unknown preconditioner {kind!r}")


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _masked(active: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """value where the loop is still active, else 0 (NaNs of a stopped loop
    never reach the iterates)."""
    return torch.where(active, value, value.new_zeros(()))


def _stop2(b: torch.Tensor, tol: float, atol: float) -> torch.Tensor:
    return torch.clamp(tol * tol * _dot(b, b), min=atol * atol)


def cg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-5,
       atol: float = 0.0, maxiter: Optional[int] = None,
       M: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """Preconditioned CG; returns (x, iterations)."""
    maxiter = 10 * b.numel() if maxiter is None else int(maxiter)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    atol2 = _stop2(b, tol, atol)
    r = b - A(x)
    z = r if M is None else M(r)
    p = z
    gamma = _dot(r, z)

    def rs(r, gamma):
        return gamma if M is None else _dot(r, r)

    active = rs(r, gamma) > atol2
    iters = torch.zeros((), dtype=torch.long, device=b.device)
    for k in range(maxiter):
        if k % CHECK_EVERY == 0 and not bool(active):
            break
        Ap = A(p)
        alpha = _masked(active, gamma / _dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if M is None else M(r)
        gamma_new = _dot(r, z)
        p = z + _masked(active, gamma_new / gamma) * p
        gamma = gamma_new
        iters = iters + active
        active = active & (rs(r, gamma) > atol2)
    return x, int(iters)


def bicgstab(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
             tol: float = 1e-5, atol: float = 0.0, maxiter: Optional[int] = None,
             M: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
    """Preconditioned BiCGSTAB with jax's early exit and breakdown stops;
    returns (x, iterations)."""
    maxiter = 10 * b.numel() if maxiter is None else int(maxiter)
    Mf = M or (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    atol2 = _stop2(b, tol, atol)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = b.new_ones(())
    alpha = omega = rho = one
    active = _dot(r, r) > atol2
    iters = torch.zeros((), dtype=torch.long, device=b.device)
    for k in range(maxiter):
        if k % CHECK_EVERY == 0 and not bool(active):
            break
        rho_ = _dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p_ = r + beta * (p - omega * q)
        phat = Mf(p_)
        q_ = A(phat)
        alpha_ = rho_ / _dot(rhat, q_)
        s = r - alpha_ * q_
        exit_early = _dot(s, s) < atol2
        shat = Mf(s)
        t = A(shat)
        omega_ = _dot(t, s) / _dot(t, t)
        x_ = torch.where(exit_early, x + alpha_ * phat, x + alpha_ * phat + omega_ * shat)
        r_ = torch.where(exit_early, s, s - omega_ * t)
        x, r = torch.where(active, x_, x), torch.where(active, r_, r)
        p, q = torch.where(active, p_, p), torch.where(active, q_, q)
        alpha, omega, rho = (torch.where(active, alpha_, alpha), torch.where(active, omega_, omega),
                             torch.where(active, rho_, rho))
        breakdown = (omega_ == 0) | (alpha_ == 0) | (rho_ == 0)
        iters = iters + active
        active = active & ~breakdown & (_dot(r, r) > atol2)
    return x, int(iters)


def gmres(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter: Optional[int] = None,
          M: Optional[Callable] = None) -> Tuple[torch.Tensor, int, int]:
    """Restarted GMRES, left-preconditioned as ``jax.scipy.sparse.linalg.gmres``:
    the Krylov space is that of M A, and every residual is M (b - A x).

    ``maxiter`` counts restarts (each one rebuilds a Krylov space of at most
    ``restart`` vectors), as in jax, not Arnoldi steps; default 10 N.  The
    outer loop stops when ||M (b - A x)|| <= max(tol ||b||, atol): the
    preconditioned residual against the unpreconditioned rhs, jax's test.
    Within a restart the Arnoldi process (modified Gram-Schmidt) runs with
    Givens rotations, whose residual estimate stops it early at
    ||M b|| min(1, atol / ||b||) (jax's ``ptol``; jax's default "batched"
    method runs every restart to its full length instead, so the two agree
    to the solve's tolerance, not bitwise).  An invariant subspace (a new
    Arnoldi vector below eps times its norm before orthogonalization) ends a
    restart.  Returns (x, Arnoldi steps, restarts)."""
    n = b.numel()
    maxiter = 10 * n if maxiter is None else int(maxiter)
    restart = min(int(restart), n)
    Mf = M or (lambda v: v)
    eps = torch.finfo(b.dtype).eps
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    b_norm = float(torch.linalg.norm(b))
    atol = max(tol * b_norm, atol)
    ptol = float(torch.linalg.norm(Mf(b))) * min(1.0, atol / b_norm) if b_norm else 0.0
    r = Mf(b - A(x))
    beta = torch.linalg.norm(r)
    steps = restarts = 0
    while restarts < maxiter and float(beta) > atol:
        V = [r / beta]
        H = b.new_zeros((restart + 1, restart))
        cs, sn = b.new_zeros(restart), b.new_zeros(restart)
        g = b.new_zeros(restart + 1)
        g[0] = beta
        k = 0
        while k < restart:
            w = Mf(A(V[k]))
            w_norm0 = torch.linalg.norm(w)
            for i in range(k + 1):  # modified Gram-Schmidt
                H[i, k] = _dot(w, V[i])
                w = w - H[i, k] * V[i]
            w_norm = torch.linalg.norm(w)
            H[k + 1, k] = w_norm
            breakdown = bool(w_norm <= eps * w_norm0)
            for i in range(k):  # the earlier rotations on the new column
                hi, hj = H[i, k].clone(), H[i + 1, k].clone()
                H[i, k] = cs[i] * hi + sn[i] * hj
                H[i + 1, k] = cs[i] * hj - sn[i] * hi
            denom = torch.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / denom, H[k + 1, k] / denom
            H[k, k], H[k + 1, k] = denom, 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k += 1
            steps += 1
            if breakdown or float(g[k].abs()) <= ptol:
                break
            V.append(w / w_norm)
        y = torch.linalg.solve_triangular(H[:k, :k], g[:k, None], upper=True)[:, 0]
        x = x + torch.stack(V[:k], dim=1) @ y
        r = Mf(b - A(x))
        beta = torch.linalg.norm(r)
        restarts += 1
    return x, steps, restarts


def solve(matrix: SparseMatrix, rhs: torch.Tensor, options: Optional[Dict] = None,
          x0: Optional[torch.Tensor] = None, info: Optional[Dict] = None) -> torch.Tensor:
    """Solve A x = b according to an options dict; a Krylov solver writes
    its iteration count into ``info`` when one is given."""
    opts = solver_options() if options is None else dict(options)
    type_ = opts.get("type", solver_types()[0])
    base, _, precond = type_.partition(".")
    tol = float(opts.get("precision", 1e-10))
    maxiter = int(opts.get("max_iter", 10000))

    if base == "direct":
        if matrix.pattern.shape[0] > 4096:
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            p = matrix.pattern
            A = sp.csc_matrix((matrix.values.detach().cpu().double().numpy(),
                               (p.slot_rows, p.slot_cols)), shape=p.shape)
            x = spla.spsolve(A, rhs.detach().cpu().double().numpy())
            return torch.as_tensor(x, dtype=rhs.dtype).to(rhs.device)
        return torch.linalg.solve(matrix.to_dense(), rhs)
    M = make_preconditioner(matrix, precond) if precond else None
    if base == "gmres":
        x, iterations, restarts = gmres(matrix.matvec, rhs, x0=x0, tol=tol, maxiter=maxiter,
                                        restart=int(opts.get("restart", 50)), M=M)
        if info is not None:
            info["restarts"] = restarts
    elif base == "cg":
        x, iterations = cg(matrix.matvec, rhs, x0=x0, tol=tol, maxiter=maxiter, M=M)
    elif base == "bicgstab":
        x, iterations = bicgstab(matrix.matvec, rhs, x0=x0, tol=tol, maxiter=maxiter, M=M)
    else:
        raise ValueError(f"unknown solver type {type_!r}")
    if info is not None:
        info["iterations"] = int(iterations)
    return x
