"""On-disk persistence of reduced models and greedy training state.

Counterpart of ``dune_hdd_tpu/mor/io.py``, in the same format: a plain
``.npz`` of the arrays plus a JSON meta entry with the coefficient
expressions (compiled again on load), so a model saved by either package
loads in the other.  Loading puts the arrays on ``device``, the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..parameters import ParameterFunctional, ParameterType
from .reductor import ReducedModel

__all__ = ["save_reduced_model", "load_reduced_model", "save_greedy_state", "load_greedy_state"]


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_bytes(meta) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _coeffs_meta(coeffs):
    return [{"expression": c.expression, "parameter_type": dict(c.parameter_type.items())}
            for c in coeffs]


def _coeffs_from_meta(meta):
    return [ParameterFunctional(ParameterType(m["parameter_type"]), m["expression"])
            for m in meta]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_reduced_model(rm: ReducedModel, path: str) -> str:
    path = _npz(path)
    meta = {
        "op_coeffs": _coeffs_meta(rm.op_coeffs),
        "rhs_coeffs": _coeffs_meta(rm.rhs_coeffs),
        "products": sorted(rm.products),
    }
    arrays = {"op_mats": _host(rm.op_mats), "rhs_vecs": _host(rm.rhs_vecs),
              "basis": _host(rm.basis), "meta": _meta_bytes(meta)}
    for name, mat in rm.products.items():
        arrays[f"product_{name}"] = _host(mat)
    np.savez(path, **arrays)
    return path


def load_reduced_model(path: str, device="cuda") -> ReducedModel:
    device = resolve_device(device)
    with np.load(_npz(path)) as data:
        meta = json.loads(bytes(data["meta"]).decode())

        def t(name):
            return torch.as_tensor(data[name]).to(device)

        return ReducedModel(t("op_mats"), _coeffs_from_meta(meta["op_coeffs"]), t("rhs_vecs"),
                            _coeffs_from_meta(meta["rhs_coeffs"]), t("basis"),
                            {name: t(f"product_{name}") for name in meta["products"]})


def save_greedy_state(path: str, basis, selected_mus, max_errors, extensions: int) -> str:
    """Checkpoint greedy training state (basis + history) so an interrupted
    run resumes where it stopped (greedy_rb(checkpoint_path=...))."""
    path = _npz(path)
    meta = {
        "selected_mus": [{k: _host(v).tolist() for k, v in mu.items()} for mu in selected_mus],
        "max_errors": [float(e) for e in max_errors],
        "extensions": int(extensions),
    }
    np.savez(path, basis=_host(basis), meta=_meta_bytes(meta))
    return path


def load_greedy_state(path: str, device="cuda"):
    """(basis, selected_mus, max_errors, extensions), or None if absent; the
    basis on ``device``, the parameters float64 host tensors."""
    path = _npz(path)
    if not os.path.exists(path):
        return None
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        basis = torch.as_tensor(data["basis"]).to(device)
    mus = [{k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in mu.items()}
           for mu in meta["selected_mus"]]
    return basis, mus, list(meta["max_errors"]), int(meta["extensions"])
