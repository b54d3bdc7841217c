from .swipdg import (
    SWIPDGEstimators,
    min_diffusion_eigenvalue,
    oswald_interpolation,
    oswald_interpolation_nodal,
    rt0_divergence,
    rt0_evaluate,
    rt0_flux_reconstruction,
    rt1_divergence_at,
    rt1_evaluate,
    rt1_flux_reconstruction,
    scheme_flux_parts,
)

__all__ = [
    "SWIPDGEstimators",
    "oswald_interpolation",
    "oswald_interpolation_nodal",
    "rt0_flux_reconstruction",
    "rt0_evaluate",
    "rt0_divergence",
    "rt1_flux_reconstruction",
    "rt1_evaluate",
    "rt1_divergence_at",
    "min_diffusion_eigenvalue",
    "scheme_flux_parts",
]
