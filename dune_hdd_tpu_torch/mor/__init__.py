"""Model order reduction: RB greedy, Riesz residual estimator, LRBMS and
adaptive enrichment (counterpart of ``dune_hdd_tpu/mor``)."""
from .adaptive import AdaptiveResult, adaptive_lrbms, doerfler_marking, snapshot_local_bases
from .gram_schmidt import gram_schmidt, pod, trivial_extension
from .greedy import GreedyResult, greedy_lrbms, greedy_rb, sample_randomly, sample_uniformly
from .io import load_reduced_model, save_reduced_model
from .pymor_shim import StationaryModelShim, as_pymor_model
from .reductor import RBReductor, ReducedModel
from .residual import OnlineResidual, RieszResidualEstimator, min_theta_coercivity

__all__ = [
    "AdaptiveResult",
    "adaptive_lrbms",
    "doerfler_marking",
    "snapshot_local_bases",
    "gram_schmidt",
    "pod",
    "trivial_extension",
    "GreedyResult",
    "greedy_rb",
    "greedy_lrbms",
    "sample_randomly",
    "sample_uniformly",
    "RBReductor",
    "save_reduced_model",
    "load_reduced_model",
    "ReducedModel",
    "RieszResidualEstimator",
    "OnlineResidual",
    "min_theta_coercivity",
    "as_pymor_model",
    "StationaryModelShim",
]
