"""Adaptive LRBMS: estimator-driven online enrichment of local bases.

Counterpart of ``dune_hdd_tpu/mor/adaptive.py``: solve reduced -> localize
the OS2014 error estimator -> enrich the marked subdomains' bases with an
oversampled local correction solve (solve_for_local_correction) ->
re-project.  The bases live on the discretization's device; the local
indicators go to the host, where the marking picks the subdomains.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .greedy import _stacked, globalize
from .gram_schmidt import gram_schmidt
from .reductor import RBReductor, ReducedModel

__all__ = ["AdaptiveResult", "adaptive_lrbms", "doerfler_marking", "snapshot_local_bases"]


def snapshot_local_bases(block_disc, mu_train, local_product: str = "h1_semi",
                         solver_options: Optional[Dict] = None) -> List[torch.Tensor]:
    """Per-subdomain bases from one detailed snapshot u(mu_train).  The
    rhs-only initialization leaves every subdomain outside the force support
    with an empty basis; one training snapshot gives each a non-trivial
    one (the LRBMS papers' initialization, reduced to one parameter)."""
    d = block_disc
    u = d.solve(mu_train, options=solver_options or {"type": "direct"})
    return [gram_schmidt(d.localize_vector(u, ss)[None, :],
                         d.get_local_product(ss, local_product).freeze({}))
            for ss in range(d.num_subdomains())]


def doerfler_marking(indicators: np.ndarray, theta: float) -> List[int]:
    """Bulk-chasing (Doerfler) marking: the smallest set of subdomains whose
    squared indicators sum to >= theta * total (the worst one if the total
    is zero)."""
    ind = np.maximum(np.asarray(indicators, dtype=float), 0.0)
    order = np.argsort(-ind, kind="stable")
    csum = np.cumsum(ind[order])
    total = csum[-1] if len(csum) else 0.0
    if total <= 0.0:
        return [int(np.argmax(ind))] if len(ind) else []
    k = int(np.searchsorted(csum, theta * total)) + 1
    return [int(s) for s in order[:k]]


@dataclass
class AdaptiveResult:
    reduced_model: ReducedModel
    basis: torch.Tensor
    local_bases: List[torch.Tensor]
    estimates: List[float] = field(default_factory=list)
    enriched_subdomains: List = field(default_factory=list)
    true_errors: List[float] = field(default_factory=list)
    rb_bounds: List[float] = field(default_factory=list)


def adaptive_lrbms(
    block_disc,
    mu,
    estimator_parameters: Dict,
    initial_local_bases: Optional[Sequence[torch.Tensor]] = None,
    target_estimate: float = 1e-3,
    max_enrichments: int = 10,
    local_product: str = "h1_semi",
    estimator_type: str = "eta_OS2014_*",
    solver_options: Optional[Dict] = None,
    track_true_errors: bool = False,
    verbose: bool = False,
    marking="worst",
    marking_estimator_type: Optional[str] = None,
    rb_bound: bool = True,
    rb_product: str = "energy",
) -> AdaptiveResult:
    """Enrich per-subdomain bases adaptively for one target parameter mu;
    the discretization needs oversampling_layers > 0.

    ``marking``: "worst" enriches the single worst subdomain per iteration;
    ``("doerfler", theta)`` the Doerfler bulk set, all corrections from the
    same reduced solution.  ``marking_estimator_type``: the indicator used
    for marking (stopping always uses ``estimator_type``).

    ``rb_bound``: also record the reduced-consistent Riesz residual bound
    ||P^{-1}(f - A u_rb)||_P / sqrt(alpha_LB(mu)) per iteration in
    ``result.rb_bounds`` (P the ``rb_product`` at mu_bar, min-theta
    coercivity).  The loop stops when EITHER ``estimator_type`` OR this
    bound reaches ``target_estimate``, as the reference does."""
    from ..estimators.block_swipdg import BlockSWIPDGEstimators

    d = block_disc
    S = d.num_subdomains()
    mu_p = d.problem.parse_parameter(mu) if d.parametric() else {}
    reductor = RBReductor(d)
    local_products = [d.get_local_product(ss, local_product).freeze({}) for ss in range(S)]
    if initial_local_bases is not None:
        local_bases = [torch.as_tensor(b).to(device=d.device, dtype=torch.float64)
                       for b in initial_local_bases]
    else:
        # start from the localized rhs like the LRBMS greedy
        local_bases = [gram_schmidt(d.get_local_rhs(ss).freeze(mu_p)[None, :], local_products[ss])
                       for ss in range(S)]

    u_detailed = None
    if track_true_errors:
        u_detailed = d.solve(mu, options=solver_options or {"type": "direct"})

    riesz = None
    if rb_bound:
        from .residual import RieszResidualEstimator, min_theta_coercivity

        mu_bar = estimator_parameters.get("mu_bar", mu)
        coer = None
        if d.parametric():
            op_exp = d.get_operator().with_expanded_affine_part()
            coer = min_theta_coercivity(op_exp, d.problem.parse_parameter(mu_bar))
        kw = {"mu_bar": mu_bar} if d.get_product(rb_product).parametric() else {}
        riesz = RieszResidualEstimator(d, product=rb_product, coercivity=coer, **kw)

    basis = globalize(d, local_bases)
    rm = reductor.reduce(basis)
    result = AdaptiveResult(rm, basis, local_bases)
    for it in range(max_enrichments + 1):
        coeffs = rm.solve(mu_p)
        u_rb = rm.reconstruct(coeffs)
        eta = BlockSWIPDGEstimators.estimate(d, u_rb, estimator_type, estimator_parameters)
        result.estimates.append(float(eta))
        if riesz is not None:
            result.rb_bounds.append(riesz.offline(basis).estimate(mu_p, coeffs))
        if track_true_errors:
            e = u_detailed - u_rb
            pm = d.product_matrix("h1_semi")
            result.true_errors.append(float(torch.sqrt(torch.clamp(e @ pm.matvec(e), min=0))))
        if verbose:
            msg = f"  adaptive it {it}: {estimator_type} = {eta:.3e}"
            if track_true_errors:
                msg += f"  (true h1 err {result.true_errors[-1]:.3e})"
            print(msg)
        certified = eta <= target_estimate or (
            riesz is not None and result.rb_bounds[-1] <= target_estimate)
        if certified or it == max_enrichments:
            break
        indicators = BlockSWIPDGEstimators.estimate_local(
            d, u_rb, marking_estimator_type or estimator_type, estimator_parameters)
        if marking == "worst":
            marked = [int(np.argmax(indicators))]
            result.enriched_subdomains.append(marked[0])
        else:
            kind, theta = marking
            if kind != "doerfler":
                raise ValueError(f"unknown marking {marking!r}")
            marked = doerfler_marking(indicators, float(theta))
            result.enriched_subdomains.append(marked)
        locals_ = [d.localize_vector(u_rb, ss) for ss in range(S)]
        for ss in marked:
            delta = d.solve_for_local_correction(locals_, ss, mu_p, options=solver_options)
            local_bases[ss] = gram_schmidt(_stacked(local_bases[ss], delta), local_products[ss])
        basis = globalize(d, local_bases)
        rm = reductor.reduce(basis)
    result.reduced_model = rm
    result.basis = basis
    result.local_bases = local_bases
    return result
