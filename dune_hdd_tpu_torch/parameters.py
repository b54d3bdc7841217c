"""Parameter substrate: ParameterType, Parameter, ParameterFunctional.

Counterpart of ``dune_hdd_tpu/parameters.py``.  A parameter is a dict of
named 1-d float64 tensors on the host; parameter functionals are scalar
expressions theta_q(mu) evaluated with torch, returning 0-d float64 host
tensors.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "ParameterType",
    "Parameter",
    "ParameterFunctional",
    "ProductFunctional",
    "ConstantFunctional",
    "parse_parameter",
    "parameter_key",
]


class ParameterType:
    """An ordered mapping component-name -> size (number of scalar entries);
    two types merge with ``|`` when their shared components agree in size."""

    def __init__(self, entries: Optional[Mapping[str, int]] = None, **kw: int):
        items: Dict[str, int] = {}
        if entries:
            for k, v in entries.items():
                items[str(k)] = int(v)
        for k, v in kw.items():
            items[k] = int(v)
        self._items: Dict[str, int] = dict(sorted(items.items()))

    def empty(self) -> bool:
        return not self._items

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __getitem__(self, key: str) -> int:
        return self._items[key]

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def __eq__(self, other) -> bool:
        return isinstance(other, ParameterType) and self._items == other._items

    def __hash__(self):
        return hash(tuple(self._items.items()))

    def __or__(self, other: "ParameterType") -> "ParameterType":
        merged = dict(self._items)
        for k, v in other.items():
            if k in merged and merged[k] != v:
                raise ValueError(
                    f"incompatible parameter types: component {k!r} has sizes "
                    f"{merged[k]} and {v}"
                )
            merged[k] = v
        return ParameterType(merged)

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v}" for k, v in self._items.items())
        return f"ParameterType({{{inner}}})"


#: A Parameter is a plain dict name -> 1-d float64 tensor on the host.
Parameter = Dict[str, torch.Tensor]


def _vector(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return torch.atleast_1d(torch.as_tensor(np.asarray(v, dtype=np.float64)))


def parse_parameter(
    mu: Union[None, float, Sequence[float], Mapping[str, object]],
    parameter_type: Optional[ParameterType] = None,
) -> Parameter:
    """Coerce user input into a canonical Parameter dict: a dict, a scalar
    (for single-component single-entry types), or a flat sequence (split
    across the type's components in order)."""
    if mu is None:
        return {}
    if isinstance(mu, Mapping):
        return {str(k): _vector(v) for k, v in mu.items()}
    if parameter_type is None or parameter_type.empty():
        raise ValueError("cannot coerce non-dict parameter without a parameter type")
    flat = np.atleast_1d(np.asarray(mu, dtype=float))
    total = sum(parameter_type[k] for k in parameter_type)
    if flat.size != total:
        raise ValueError(f"parameter has {flat.size} entries, type requires {total}")
    out: Parameter = {}
    off = 0
    for k in parameter_type:
        n = parameter_type[k]
        out[k] = torch.as_tensor(flat[off: off + n].copy())
        off += n
    return out


def parameter_key(mu: Parameter) -> Tuple:
    """Hashable key for solution caching."""
    return tuple((k, tuple(np.asarray(v).ravel().tolist())) for k, v in sorted(mu.items()))


def _t(fn: Callable) -> Callable:
    """A torch function that also takes Python numbers and a bare
    component name (its first entry)."""
    def wrapped(*args):
        return fn(*[torch.as_tensor(_unwrap(a), dtype=torch.float64) for a in args])
    return wrapped


_EXPR_NAMESPACE = {
    "sin": _t(torch.sin),
    "cos": _t(torch.cos),
    "tan": _t(torch.tan),
    "exp": _t(torch.exp),
    "log": _t(torch.log),
    "sqrt": _t(torch.sqrt),
    "abs": _t(torch.abs),
    "min": _t(torch.minimum),
    "max": _t(torch.maximum),
    "pi": math.pi,
    "pow": _t(torch.pow),
}

_ALLOWED_EXPR = re.compile(r"^[\w\s\+\-\*/\(\)\.,\[\]]+$")


def _compile_expression(expression: str, names: Iterable[str]) -> Callable:
    """Compile a scalar expression over parameter components.  Entries are
    addressable as ``name[i]``; a bare ``name`` means ``name[0]``."""
    if not _ALLOWED_EXPR.match(expression):
        raise ValueError(f"disallowed characters in expression {expression!r}")
    code = compile(expression, f"<theta:{expression}>", "eval")
    name_set = set(names)
    for nm in code.co_names:
        if nm not in _EXPR_NAMESPACE and nm not in name_set:
            raise ValueError(f"unknown name {nm!r} in expression {expression!r}")

    def evaluate(mu: Parameter) -> torch.Tensor:
        env = dict(_EXPR_NAMESPACE)
        for nm in name_set:
            if nm not in mu:
                raise KeyError(f"expression {expression!r} needs parameter component {nm!r}")
            env[nm] = _ScalarOrVector(_vector(mu[nm]))
        out = eval(code, {"__builtins__": {}}, env)  # noqa: S307 - vetted charset
        return torch.as_tensor(_unwrap(out), dtype=torch.float64)

    return evaluate


class _ScalarOrVector:
    """``mu`` acts as mu[0] in arithmetic but supports mu[i] indexing."""

    def __init__(self, vec):
        self._vec = vec

    def __getitem__(self, i):
        return self._vec[i]

    def _s(self):
        return self._vec[0]

    def __add__(self, o):
        return self._s() + _unwrap(o)

    def __radd__(self, o):
        return _unwrap(o) + self._s()

    def __sub__(self, o):
        return self._s() - _unwrap(o)

    def __rsub__(self, o):
        return _unwrap(o) - self._s()

    def __mul__(self, o):
        return self._s() * _unwrap(o)

    def __rmul__(self, o):
        return _unwrap(o) * self._s()

    def __truediv__(self, o):
        return self._s() / _unwrap(o)

    def __rtruediv__(self, o):
        return _unwrap(o) / self._s()

    def __pow__(self, o):
        return self._s() ** _unwrap(o)

    def __rpow__(self, o):
        return _unwrap(o) ** self._s()

    def __neg__(self):
        return -self._s()

    def __pos__(self):
        return self._s()

    def __float__(self):
        return float(self._s())


def _unwrap(o):
    return o._s() if isinstance(o, _ScalarOrVector) else o


class ParameterFunctional:
    """A scalar coefficient theta(mu) given as an expression string."""

    def __init__(self, parameter_type: Union[ParameterType, Mapping[str, int], Tuple[str, int]],
                 expression: str):
        if isinstance(parameter_type, tuple):
            parameter_type = ParameterType({parameter_type[0]: parameter_type[1]})
        elif not isinstance(parameter_type, ParameterType):
            parameter_type = ParameterType(parameter_type)
        self.parameter_type = parameter_type
        self.expression = str(expression)
        self._fn = _compile_expression(self.expression, parameter_type.keys())

    def __call__(self, mu: Parameter) -> torch.Tensor:
        return self._fn(mu)

    def evaluate(self, mu: Parameter) -> torch.Tensor:
        return self._fn(mu)

    def __eq__(self, other):
        return (
            isinstance(other, ParameterFunctional)
            and self.expression == other.expression
            and self.parameter_type == other.parameter_type
        )

    def __hash__(self):
        return hash((self.expression, self.parameter_type))

    def __repr__(self):
        return f"ParameterFunctional({self.parameter_type!r}, {self.expression!r})"


def ProductFunctional(a: ParameterFunctional, b: ParameterFunctional) -> ParameterFunctional:
    """theta_a * theta_b."""
    return ParameterFunctional(
        a.parameter_type | b.parameter_type,
        f"({a.expression})*({b.expression})",
    )


def ConstantFunctional(value: float) -> ParameterFunctional:
    return ParameterFunctional(ParameterType(), repr(float(value)))
