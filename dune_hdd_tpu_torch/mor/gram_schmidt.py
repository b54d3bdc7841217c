"""Product-orthonormalization of reduced bases.

Counterpart of ``dune_hdd_tpu/mor/gram_schmidt.py``: the gram_schmidt / pod /
trivial extension algorithms of the reference's RB scripts.  Rows live on
their own device; a product is a SparseMatrix on the same device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["gram_schmidt", "pod", "trivial_extension"]


def _inner(product, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if product is None:
        return torch.dot(a, b)
    return a @ product.matvec(b)


def gram_schmidt(vectors: torch.Tensor, product=None, atol: float = 1e-13,
                 reiterate: bool = True) -> torch.Tensor:
    """Rows of ``vectors`` [n, N] -> product-orthonormal rows [m, N] (m <= n),
    dropping (numerically) linearly dependent vectors."""
    basis = []
    for v in vectors:
        w = v
        for _ in range(2 if reiterate else 1):
            for b in basis:
                w = w - _inner(product, b, w) * b
        norm = torch.sqrt(torch.clamp(_inner(product, w, w), min=0.0))
        if float(norm) > atol:
            basis.append(w / norm)
    if not basis:
        return vectors.new_zeros((0, vectors.shape[1]))
    return torch.stack(basis)


def pod(snapshots: torch.Tensor, product=None, rtol: float = 1e-7,
        modes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """POD of snapshot rows [n, N] w.r.t. a product; returns (modes [m, N],
    singular values [m]).  The sign of each mode is the eigensolver's."""
    n = snapshots.shape[0]
    if product is None:
        gram = snapshots @ snapshots.T
    else:
        gram = snapshots @ torch.stack([product.matvec(s) for s in snapshots]).T
    evals, evecs = torch.linalg.eigh(gram)
    order = torch.argsort(evals, descending=True)
    evals = torch.clamp(evals[order], min=0.0)
    evecs = evecs[:, order]
    svals = torch.sqrt(evals)
    s_host = svals.cpu().numpy()
    keep = s_host > s_host[0] * rtol if n else np.zeros(0, bool)
    if modes is not None:
        keep[modes:] = False
    idx = torch.as_tensor(np.nonzero(keep)[0]).to(snapshots.device)
    coeffs = evecs[:, idx] / svals[idx][None, :]
    return coeffs.T @ snapshots, svals[idx]


def trivial_extension(basis: torch.Tensor, new_vector: torch.Tensor,
                      atol: float = 1e-13) -> torch.Tensor:
    """Append without orthonormalization (pyMOR's trivial extension)."""
    if basis.shape[0] == 0:
        return new_vector[None, :]
    return torch.cat([basis, new_vector[None, :]], dim=0)
