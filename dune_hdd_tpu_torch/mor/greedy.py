"""Greedy reduced-basis training (standard RB and LRBMS variants).

Counterpart of ``dune_hdd_tpu/mor/greedy.py``, the pyMOR workflows of the
reference's ``thermalblock_main.py``:

* ``greedy_rb`` (perform_standard_rb): greedy over a training set with
  gram_schmidt / pod / trivial extension, max_extensions / target_error
  stopping;
* ``greedy_lrbms`` (perform_lrbms): per-subdomain local bases extended with
  the local products, initial basis from the local rhs, optional final POD
  compression.

The basis lives on the discretization's device in float64; the candidate
errors go to the host, where ``np.argmax`` picks the worst one.  Each step
is a span of the port's record while recording (``utils/profiling.py``):
"mor.snapshot", "mor.reduce", "mor.offline" and "mor.estimate".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.logging import timed
from .gram_schmidt import gram_schmidt, pod, trivial_extension
from .reductor import RBReductor, ReducedModel

__all__ = ["GreedyResult", "greedy_rb", "greedy_lrbms", "sample_uniformly", "sample_randomly"]


@dataclass
class GreedyResult:
    reduced_model: ReducedModel
    basis: torch.Tensor
    max_errors: List[float] = field(default_factory=list)
    selected_mus: List[dict] = field(default_factory=list)
    extensions: int = 0
    #: the RieszResidualEstimator of an estimator-driven run (its row cache
    #: counts), else None
    estimator: Optional[object] = None


def sample_uniformly(parameter_type, low: float, high: float, count: int) -> List[dict]:
    """``count`` points per scalar ramp, shared across components."""
    return [{name: torch.full((size,), float(t), dtype=torch.float64)
             for name, size in parameter_type.items()}
            for t in np.linspace(low, high, count)]


def sample_randomly(parameter_type, low: float, high: float, count: int,
                    seed: int = 0) -> List[dict]:
    """``count`` uniform draws from ``np.random.default_rng(seed)``, in the
    reference's order."""
    rng = np.random.default_rng(seed)
    return [{name: torch.as_tensor(rng.uniform(low, high, size))
             for name, size in parameter_type.items()}
            for _ in range(count)]


def _stacked(basis: torch.Tensor, new_vec: torch.Tensor) -> torch.Tensor:
    return torch.cat([basis, new_vec[None, :]]) if basis.shape[0] else new_vec[None, :]


def _extend(basis, new_vec, algorithm: str, product):
    if algorithm == "trivial":
        return trivial_extension(basis, new_vec)
    if algorithm == "gram_schmidt":
        return gram_schmidt(_stacked(basis, new_vec), product)
    if algorithm == "pod":
        modes, _ = pod(_stacked(basis, new_vec), product)
        return modes
    raise ValueError(f"unknown extension algorithm {algorithm!r}")


def _riesz_estimator(d, training_set, error_norm, coercivity):
    from .residual import RieszResidualEstimator, min_theta_coercivity

    if coercivity == "min_theta":
        coercivity = min_theta_coercivity(d.get_operator(),
                                          d.problem.parse_parameter(training_set[0]))
    return RieszResidualEstimator(d, product=error_norm, coercivity=coercivity)


def _reduce(reductor, estimator, basis):
    """(reduced model, online residual or None) of the basis, timed."""
    dev = reductor.d.device
    with timed("mor.reduce", sync=dev):
        rm = reductor.reduce(basis)
    if estimator is None:
        return rm, None
    with timed("mor.offline", sync=dev):
        return rm, estimator.offline(basis)


def greedy_rb(
    discretization,
    training_set: Sequence[dict],
    target_error: float = 1e-6,
    max_extensions: int = 20,
    extension_algorithm: str = "gram_schmidt",
    error_norm: str = "h1_semi",
    use_estimator=False,
    solver_options: Optional[dict] = None,
    verbose: bool = False,
    coercivity=None,
    checkpoint_path: Optional[str] = None,
) -> GreedyResult:
    """Weak greedy: pick the worst-approximated training parameter, extend
    the basis with its (orthonormalized) snapshot, stop at target_error or
    max_extensions.

    use_estimator: False -> detailed solve + true error per candidate;
    True or "riesz" -> the offline/online Riesz residual estimator
    (mor/residual.py), all candidates scored in one batched sweep
    (mor/batch.py); "algebraic" -> the Euclidean residual surrogate.

    coercivity: callable mu -> alpha_LB(mu) dividing the residual dual norm
    into a true-error bound; "min_theta" -> min_theta_coercivity at the
    first training parameter.  With coercivity=None in estimator mode,
    target_error is a residual dual-norm tolerance.

    checkpoint_path: the greedy state is saved there after every extension
    and, if present, resumed from."""
    d = discretization
    reductor = RBReductor(d)
    product = d.product_matrix(error_norm)
    estimator = online = None
    if use_estimator in (True, "riesz"):
        estimator = _riesz_estimator(d, training_set, error_norm, coercivity)
    basis = torch.zeros((0, d.space.num_dofs), dtype=torch.float64, device=d.device)
    result = GreedyResult(None, basis, estimator=estimator)
    if checkpoint_path is not None:
        from .io import load_greedy_state

        state = load_greedy_state(checkpoint_path, device=d.device)
        if state is not None:
            basis, result.selected_mus, result.max_errors, result.extensions = state
            # the stored max_errors include the last pre-extension score,
            # which the loop below appends again
            result.max_errors = result.max_errors[: result.extensions]
            if verbose:
                print(f"  greedy: resumed {result.extensions} extensions "
                      f"from {checkpoint_path}")
    rm, online = _reduce(reductor, estimator, basis)
    stacked = coercivities = None
    if estimator is not None and training_set:
        from .batch import batched_estimates, stack_parameters

        stacked = stack_parameters(d.problem, training_set)
        if estimator.coercivity is not None:
            coercivities = np.asarray([float(estimator.coercivity(d.problem.parse_parameter(mu)))
                                       for mu in training_set])
    for it in range(result.extensions, max_extensions + 1):
        with timed("mor.estimate", sync=d.device):
            if estimator is not None and training_set:
                errors = list(batched_estimates(online, rm, stacked, coercivities))
            else:
                errors = []
                for mu in training_set:
                    if rm.dim == 0 and estimator is None:
                        e = float("inf")
                    elif use_estimator == "algebraic":
                        e = reductor.residual_norm(rm, mu)
                    else:
                        e = reductor.true_error(rm, mu, error_norm, solver_options)
                    errors.append(e)
        worst = int(np.argmax(errors))
        max_err = errors[worst]
        result.max_errors.append(max_err if np.isfinite(max_err) else -1.0)
        if verbose:
            print(f"  greedy it {it}: max err {max_err:.3e} at {worst}")
        if (np.isfinite(max_err) and max_err <= target_error) or it == max_extensions:
            break
        mu = training_set[worst]
        result.selected_mus.append(mu)
        with timed("mor.snapshot", sync=d.device):
            snapshot = d.solve(mu, options=solver_options or {"type": "direct"})
        basis = _extend(basis, snapshot, extension_algorithm, product)
        rm, online = _reduce(reductor, estimator, basis)
        result.extensions += 1
        if checkpoint_path is not None:
            from .io import save_greedy_state

            save_greedy_state(checkpoint_path, basis, result.selected_mus,
                              result.max_errors, result.extensions)
    result.reduced_model = rm
    result.basis = basis
    return result


def greedy_lrbms(
    block_discretization,
    training_set: Sequence[dict],
    target_error: float = 1e-6,
    max_extensions: int = 20,
    local_product: str = "h1_semi",
    error_norm: str = "h1_semi",
    initial_basis_from_rhs: bool = True,
    final_compression: bool = False,
    solver_options: Optional[dict] = None,
    verbose: bool = False,
    use_estimator=False,
    coercivity=None,
) -> GreedyResult:
    """LRBMS greedy: per-subdomain local bases orthonormalized with the
    local products, globalized as zero-padded rows.  Snapshots are localized
    (d.localize_vector) and each subdomain's basis is extended on its own.

    use_estimator=True/"riesz": candidates are scored by the offline/online
    Riesz residual estimator on the globalized basis, one detailed solve per
    extension.  coercivity: as in greedy_rb.  The result also carries
    ``local_bases``."""
    d = block_discretization
    S = d.num_subdomains()
    reductor = RBReductor(d)
    error_product = d.product_matrix(error_norm)
    estimator = online = None
    if use_estimator in (True, "riesz"):
        estimator = _riesz_estimator(d, training_set, error_norm, coercivity)
    local_products = [d.get_local_product(ss, local_product).freeze({}) for ss in range(S)]
    nloc = [len(d._local_dof_map(ss)) for ss in range(S)]
    local_bases: List[torch.Tensor] = [
        torch.zeros((0, nloc[ss]), dtype=torch.float64, device=d.device) for ss in range(S)]

    if initial_basis_from_rhs:
        mu0 = d.problem.parse_parameter(training_set[0]) if d.parametric() else {}
        for ss in range(S):
            v = d.get_local_rhs(ss).freeze(mu0)
            local_bases[ss] = gram_schmidt(v[None, :], local_products[ss])

    basis = globalize(d, local_bases)
    rm, online = _reduce(reductor, estimator, basis)
    result = GreedyResult(rm, basis, estimator=estimator)
    for it in range(max_extensions + 1):
        with timed("mor.estimate", sync=d.device):
            if estimator is not None:
                errors = [online.estimate(mu, rm.solve(mu) if rm.dim else basis.new_zeros((0,)))
                          for mu in training_set]
            else:
                errors = [reductor.true_error(rm, mu, error_norm, solver_options)
                          if rm.dim else float("inf") for mu in training_set]
        worst = int(np.argmax(errors))
        max_err = errors[worst]
        result.max_errors.append(max_err if np.isfinite(max_err) else -1.0)
        if verbose:
            print(f"  lrbms greedy it {it}: max err {max_err:.3e}")
        if (np.isfinite(max_err) and max_err <= target_error) or it == max_extensions:
            break
        mu = training_set[worst]
        result.selected_mus.append(mu)
        with timed("mor.snapshot", sync=d.device):
            snapshot = d.solve(mu, options=solver_options or {"type": "direct"})
        for ss in range(S):
            local_snap = d.localize_vector(snapshot, ss)
            local_bases[ss] = gram_schmidt(_stacked(local_bases[ss], local_snap),
                                           local_products[ss])
        basis = globalize(d, local_bases)
        rm, online = _reduce(reductor, estimator, basis)
        result.extensions += 1
    if final_compression and basis.shape[0]:
        basis, _ = pod(basis, error_product)
        rm, _ = _reduce(reductor, None, basis)
    result.reduced_model = rm
    result.basis = basis
    result.local_bases = local_bases
    return result


def globalize(d, local_bases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Zero-padded global rows [total local rows, N] of per-subdomain
    bases, subdomain by subdomain, made on the discretization's device."""
    blocks = []
    for ss, lb in enumerate(local_bases):
        if lb.shape[0] == 0:
            continue
        dofs = torch.as_tensor(d._local_dof_map(ss)).to(d.device)
        rows = torch.zeros((lb.shape[0], d.space.num_dofs), dtype=torch.float64,
                           device=d.device)
        rows.index_put_((torch.arange(lb.shape[0], device=d.device)[:, None], dofs[None, :]),
                        lb.to(device=d.device, dtype=torch.float64))
        blocks.append(rows)
    if not blocks:
        return torch.zeros((0, d.space.num_dofs), dtype=torch.float64, device=d.device)
    return torch.cat(blocks)
