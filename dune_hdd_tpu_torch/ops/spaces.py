"""P1 triangle DG basis (host numpy).

Counterpart of ``_tri_shape_values`` / ``_tri_shape_grads`` in
``dune_hdd_tpu/ops/spaces.py``: the barycentric basis that the structured
assembly evaluates at its representative cells and faces.
"""
from __future__ import annotations

import numpy as np

__all__ = ["tri_shape_values", "tri_shape_grads"]


def tri_shape_values(cellverts: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Barycentric coordinates of x in the triangle == P1 shape values.

    cellverts [..., 3, 2], x [..., k, 2] -> [..., k, 3].
    """
    v0 = cellverts[..., 0, :]
    e1 = cellverts[..., 1, :] - v0
    e2 = cellverts[..., 2, :] - v0
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    r = x - v0[..., None, :]
    lam1 = (r[..., 0] * e2[..., None, 1] - r[..., 1] * e2[..., None, 0]) / det[..., None]
    lam2 = (e1[..., None, 0] * r[..., 1] - e1[..., None, 1] * r[..., 0]) / det[..., None]
    lam0 = 1.0 - lam1 - lam2
    return np.stack([lam0, lam1, lam2], axis=-1)


def tri_shape_grads(cellverts: np.ndarray) -> np.ndarray:
    """[..., 3, 2] constant physical gradients of the barycentric basis."""
    v0 = cellverts[..., 0, :]
    e1 = cellverts[..., 1, :] - v0
    e2 = cellverts[..., 2, :] - v0
    det = (e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])[..., None]
    g1 = np.stack([e2[..., 1], -e2[..., 0]], axis=-1) / det
    g2 = np.stack([-e1[..., 1], e1[..., 0]], axis=-1) / det
    g0 = -g1 - g2
    return np.stack([g0, g1, g2], axis=-2)
