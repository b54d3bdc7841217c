"""Stage pipelining of the assemble -> solve -> estimate chain.

Counterpart of ``dune_hdd_tpu/parallel/pipeline.py``: a GPipe-style
schedule over a "stage" mesh axis of S >= 3 shards.

* stages 0 .. S-3 (assembly): the affine component stacks, the pipeline's
  "weights", are split over the assembly stages (ceil(Q / (S-2))
  components each; the solve and estimate stages hold zero padding).  Each
  assembly stage adds its part of the theta contraction to the item's
  partial operator and rhs as the item passes;
* stage S-2 (solve): fixed-trip Jacobi CG on the frozen system;
* stage S-1 (estimate): (relative residual, energy norm), and optionally
  the port's ESV2007 estimators at the item's mu.

B parameters flow through S stages in B + S - 1 steps; at step t stage s
works on item t - s and hands its payload (partial ELL values, rhs,
solution) to stage s + 1 with one ``ppermute``.  The last stage records the
results and a ``psum`` replicates them.  A stage with no item at a step
passes its payload on unchanged (the reference computes on a clipped item
and discards it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..device import highest_precision
from .collectives import ppermute, psum
from .sharded import Mesh, _devices

__all__ = ["make_stage_mesh", "pipeline_parameter_stages", "sequential_parameter_stages",
           "EstimatorStage"]

NUM_STAGES = 3


def make_stage_mesh(devices=None, num_stages: int = NUM_STAGES) -> Mesh:
    """Mesh with one ("stage",) axis over the first ``num_stages`` devices
    (default: the visible cards; a device may repeat)."""
    if num_stages < NUM_STAGES:
        raise ValueError(f"stage pipelining needs >= {NUM_STAGES} stages")
    devices = _devices(devices)
    if len(devices) < num_stages:
        raise ValueError(f"stage pipelining needs {num_stages} devices, got {len(devices)}")
    arr = np.empty(num_stages, dtype=object)
    arr[:] = devices[:num_stages]
    return Mesh(arr, ("stage",))


class EstimatorStage:
    """The estimate stage's ESV2007 estimator ids, on which space and
    problem, at which per-item parameters.

    ``mus``: one Parameter dict per pipeline item, stacked into [B, dim]
    arrays.  ``mu_hat`` (optional): a fixed parameter for the eta_DF
    weighting (estimators/swipdg.hh:582-585); default the item's mu."""

    def __init__(self, space, boundary_info, problem, mus: Sequence[Dict],
                 types: Sequence[str] = ("eta_NC_ESV2007", "eta_DF_ESV2007", "eta_R_ESV2007_*"),
                 mu_hat: Optional[Dict] = None):
        self.space = space
        self.boundary_info = boundary_info
        self.problem = problem
        self.types = tuple(types)
        self.mu_hat = mu_hat
        keys = sorted({k for mu in mus for k in mu})
        self.mu_arrays = {k: torch.stack([torch.atleast_1d(torch.as_tensor(
            mu[k], dtype=torch.float64)) for mu in mus]) for k in keys}

    def mu(self, i: int):
        return ({k: v[i] for k, v in self.mu_arrays.items()}
                if self.problem.parametric() else None)


def _ell_stacks(operator: AffineDecomposition, rhs: AffineDecomposition, dtype, device=None):
    """Stacked ELL component values [Q, N, K], columns [N, K], rhs [Qr, N]."""
    expanded = operator.with_expanded_affine_part()
    rhs_expanded = rhs.with_expanded_affine_part()
    mats = list(expanded.components)
    pattern = mats[0].pattern
    device = device if device is not None else mats[0].device
    ell_cols = torch.as_tensor(np.asarray(pattern.ell_cols, dtype=np.int64)).to(device)
    ell_vals = torch.stack([m.pattern.ell_values(m.values).to(device, dtype) for m in mats])
    rhs_stack = torch.stack([v.to(device, dtype) for v in rhs_expanded.components])
    return ell_vals, ell_cols, rhs_stack, list(expanded.coefficients), \
        list(rhs_expanded.coefficients)


def _local_cg(vals, cols, b, iters: int, rtol: float = 1e-12):
    """Fixed-trip Jacobi CG on one ELL system: every pipeline step costs the
    same.  Convergence freezes the iterate (a mask, not an early exit),
    which also guards against the post-convergence near-breakdown of a
    slightly indefinite strong-contrast SWIPDG operator."""
    rows = torch.arange(b.shape[0], device=b.device)
    diag = torch.where(cols == rows[:, None], vals, torch.zeros_like(vals)).sum(dim=1)
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))

    def matvec(x):
        return (vals * x[cols]).sum(dim=1)

    zero = b.new_zeros(())
    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = torch.dot(r, z)
    atol2 = (rtol ** 2) * torch.clamp(torch.dot(b, b), min=1e-300)
    for _ in range(iters):
        done = torch.dot(r, r) <= atol2
        ap = matvec(p)
        pap = torch.dot(p, ap)
        # signed alpha: CG takes negative-curvature steps in the slightly
        # indefinite case; only an exact breakdown pap == 0 is masked
        ok = (pap != 0) & ~done
        alpha = torch.where(ok, rz / torch.where(pap != 0, pap, torch.ones_like(pap)), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = torch.where(ok, torch.dot(r, z), rz)
        beta = torch.where(ok & (rz != 0), rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)),
                           zero)
        p = torch.where(ok, z + beta * p, p)
        rz = rz_new
    return x


def _default_estimate(vals, cols, b, u):
    """(relative residual, energy norm) of the solution."""
    au = (vals * u[cols]).sum(dim=1)
    relres = torch.linalg.norm(b - au) / torch.clamp(torch.linalg.norm(b), min=1e-30)
    energy = torch.sqrt(torch.clamp(torch.dot(u, au), min=0.0))
    return torch.stack([relres, energy])


def _estimator_values(est: EstimatorStage, u, i):
    """The ESV2007 estimators at item i's mu, from their local squares."""
    from ..estimators.swipdg import SWIPDGEstimators

    mu = est.mu(i)
    mu_hat = est.mu_hat if est.mu_hat is not None else mu
    u = u.to(est.space.device, est.space.dtype)
    return torch.stack([torch.sqrt(torch.sum(SWIPDGEstimators._local_squared(
        est.space, est.boundary_info, est.problem, u, t, mu, mu_hat))) for t in est.types])


def _pad_rows(stack: torch.Tensor, chunk: int, num_stages: int) -> torch.Tensor:
    """Zero-pad axis 0 to num_stages * chunk rows (the real rows go to the
    assembly stages)."""
    pad = num_stages * chunk - stack.shape[0]
    return torch.cat([stack, stack.new_zeros((pad,) + tuple(stack.shape[1:]))])


def pipeline_parameter_stages(
    operator: AffineDecomposition,
    rhs: AffineDecomposition,
    thetas_op: torch.Tensor,
    thetas_rhs: torch.Tensor,
    mesh: Optional[Mesh] = None,
    cg_iters: int = 200,
    dtype=torch.float32,
    estimator: Optional[EstimatorStage] = None,
    _return_stacks: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run B parameters through the S-stage pipeline.

    thetas_op [B, Q_op], thetas_rhs [B, Q_rhs] (theta(mu) per item) ->
    (solutions [B, N], estimates [B, 2 (+ len(estimator.types))]) on the
    first stage's device.  Stage s holds components [s Qc, (s + 1) Qc) of
    the affine stacks; ``_return_stacks`` also returns those per-stage
    parts."""
    mesh = mesh if mesh is not None else make_stage_mesh()
    highest_precision()  # the theta contractions in full float32 products
    S = mesh.shape.get("stage")
    if S is None or S < NUM_STAGES:
        raise ValueError(f'mesh must have a "stage" axis of size >= {NUM_STAGES}')
    devices = mesh.axis_devices("stage")
    A = S - 2
    ell_vals, ell_cols, rhs_stack, _, _ = _ell_stacks(operator, rhs, dtype, "cpu")
    Q, Qr = ell_vals.shape[0], rhs_stack.shape[0]
    Qc, Qcr = -(-Q // A), -(-Qr // A)
    vals_parts = [part.to(dev) for part, dev in zip(_pad_rows(ell_vals, Qc, S).split(Qc), devices)]
    rhs_parts = [part.to(dev) for part, dev in zip(_pad_rows(rhs_stack, Qcr, S).split(Qcr),
                                                   devices)]
    cols = [ell_cols.to(dev) for dev in devices]
    th_op = torch.zeros((thetas_op.shape[0], S * Qc), dtype=dtype)
    th_op[:, :Q] = torch.as_tensor(thetas_op).to("cpu", dtype)
    th_rhs = torch.zeros((thetas_rhs.shape[0], S * Qcr), dtype=dtype)
    th_rhs[:, :Qr] = torch.as_tensor(thetas_rhs).to("cpu", dtype)
    B = th_op.shape[0]
    n, K = ell_cols.shape
    n_est = 2 + (len(estimator.types) if estimator is not None else 0)

    def assemble(s, payload, i):
        # stage s < A adds its shard's theta contraction (stage 0 starts
        # the item from zero)
        vals, b, _ = payload
        t_op = th_op[i, s * Qc:(s + 1) * Qc].to(devices[s])
        t_rhs = th_rhs[i, s * Qcr:(s + 1) * Qcr].to(devices[s])
        v = torch.einsum("q,qnk->nk", t_op, vals_parts[s])
        r = torch.einsum("q,qn->n", t_rhs, rhs_parts[s])
        if s > 0:
            v, r = vals + v, b + r
        return v, r, torch.zeros_like(r)

    def solve(s, payload, i):
        vals, b, _ = payload
        return vals, b, _local_cg(vals, cols[s], b, cg_iters)

    def estimate(s, payload, i):
        vals, b, u = payload
        parts = [_default_estimate(vals, cols[s], b, u)]
        if estimator is not None:
            parts.append(_estimator_values(estimator, u, i).to(devices[s], dtype))
        return torch.cat(parts)

    payloads = [(torch.zeros((n, K), dtype=dtype, device=dev), torch.zeros(n, dtype=dtype,
                 device=dev), torch.zeros(n, dtype=dtype, device=dev)) for dev in devices]
    out_u = [torch.zeros((B, n), dtype=dtype, device=dev) for dev in devices]
    out_est = [torch.zeros((B, n_est), dtype=dtype, device=dev) for dev in devices]
    perm = [(k, k + 1) for k in range(S - 1)]
    for t in range(B + S - 1):
        for s in range(S):
            i = t - s
            if not 0 <= i < B:
                continue
            if s < A:
                payloads[s] = assemble(s, payloads[s], i)
            elif s == A:
                payloads[s] = solve(s, payloads[s], i)
            else:  # the last stage records its item's results
                out_est[s][i] = estimate(s, payloads[s], i)
                out_u[s][i] = payloads[s][2]
        # hand each payload to the next stage
        moved = [ppermute([p[j] for p in payloads], perm) for j in range(3)]
        payloads = list(zip(*moved))
    # only the last stage wrote anything; psum replicates its results
    result = (psum(out_u)[0], psum(out_est)[0])
    if _return_stacks:
        return result + ((vals_parts, rhs_parts),)
    return result


def sequential_parameter_stages(
    operator: AffineDecomposition,
    rhs: AffineDecomposition,
    thetas_op: torch.Tensor,
    thetas_rhs: torch.Tensor,
    cg_iters: int = 200,
    dtype=torch.float32,
    estimator: Optional[EstimatorStage] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pipeline's stage functions in sequence on the operator's device
    (the equality baseline).  With an ``EstimatorStage`` the estimator
    values come from the public front-end ``SWIPDGEstimators.estimate``."""
    from ..estimators.swipdg import SWIPDGEstimators

    highest_precision()
    ell_vals, ell_cols, rhs_stack, _, _ = _ell_stacks(operator, rhs, dtype)
    device = ell_vals.device
    us: List[torch.Tensor] = []
    ests: List[torch.Tensor] = []
    for i, (t_op, t_rhs) in enumerate(zip(torch.as_tensor(thetas_op), torch.as_tensor(thetas_rhs))):
        vals = torch.einsum("q,qnk->nk", t_op.to(device, dtype), ell_vals)
        b = torch.einsum("q,qn->n", t_rhs.to(device, dtype), rhs_stack)
        u = _local_cg(vals, ell_cols, b, int(cg_iters))
        us.append(u)
        parts = [_default_estimate(vals, ell_cols, b, u)]
        if estimator is not None:
            mu = estimator.mu(i)
            mu_hat = estimator.mu_hat if estimator.mu_hat is not None else mu
            parts.append(torch.tensor([SWIPDGEstimators.estimate(
                estimator.space, estimator.boundary_info, estimator.problem,
                u.to(estimator.space.dtype), t, mu, mu_hat) for t in estimator.types],
                dtype=dtype, device=device))
        ests.append(torch.cat(parts))
    return torch.stack(us), torch.stack(ests)
