"""Function library: data functions over 2D space as torch callables.

Counterpart of ``dune_hdd_tpu/functions/base.py``.  A function takes a point
tensor ``x`` of shape ``[..., 2]`` and returns ``[...] + range_shape`` on
x's device and in x's dtype.  Constant and Indicator functions (and Sums and
Scalings of them) also take a coordinate-plane pair ``(x0, x1)`` of
equal-shape tensors, as the stencil assembly passes them.  Gradients come
from ``torch.func`` forward-mode autodiff unless a class gives its own.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..parameters import Parameter, ParameterFunctional, ParameterType

__all__ = [
    "Function",
    "ConstantFunction",
    "ExpressionFunction",
    "LambdaFunction",
    "CheckerboardFunction",
    "IndicatorFunction",
    "FlatTopFunction",
    "SumFunction",
    "ProductFunction",
    "ScaledFunction",
    "FrozenAffineFunction",
    "ParametricFunction",
    "make_checkerboard_decomposition",
    "constant_matrix",
    "nonparametric",
    "freeze_function",
]

Points = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _planes(x: Points) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first two coordinates; a point with one coordinate gives it twice."""
    if isinstance(x, tuple):
        return x
    return x[..., 0], x[..., min(1, x.shape[-1] - 1)]


def _like(x: Points, values: np.ndarray) -> torch.Tensor:
    """``values`` as a tensor on x's device in x's dtype."""
    ref = x[0] if isinstance(x, tuple) else x
    return torch.as_tensor(values, dtype=ref.dtype, device=ref.device)


class Function:
    """Base: scalar (range_shape=()), vector ((2,)) or matrix ((2,2)) valued."""

    range_shape: Tuple[int, ...] = ()
    order: int = 0  # polynomial order hint for quadrature selection
    name: str = "function"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def gradient(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 2] -> [..., *range_shape, 2] by forward-mode autodiff."""
        flat = x.reshape(-1, x.shape[-1])
        out = torch.func.vmap(torch.func.jacfwd(self.__call__))(flat)
        return out.reshape(x.shape[:-1] + tuple(self.range_shape) + (x.shape[-1],))

    def __add__(self, other: "Function") -> "Function":
        return SumFunction([self, other])

    def __mul__(self, other: "Function") -> "Function":
        return ProductFunction([self, other])

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class ConstantFunction(Function):
    def __init__(self, value, name: str = "constant"):
        self.value = np.asarray(value, dtype=np.float64)
        self.range_shape = self.value.shape
        self.order = 0
        self.name = name

    def __call__(self, x: Points) -> torch.Tensor:
        x0 = _planes(x)[0] if isinstance(x, tuple) else x[..., 0]
        if not self.range_shape:
            return torch.full_like(x0, float(self.value))
        return torch.broadcast_to(_like(x, self.value), x0.shape + self.range_shape)

    def gradient(self, x):
        return torch.zeros(x.shape[:-1] + self.range_shape + (x.shape[-1],),
                           dtype=x.dtype, device=x.device)


def constant_matrix(diag=1.0, name: str = "diffusion_tensor", dim: int = 2) -> ConstantFunction:
    """Unit (or scaled-identity) dim x dim tensor."""
    return ConstantFunction(np.eye(dim) * diag, name=name)


def _torch_fn(fn: Callable) -> Callable:
    def wrapped(*args):
        ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
        return fn(*[a if isinstance(a, torch.Tensor) else
                    torch.as_tensor(a, dtype=torch.float64 if ref is None else ref.dtype,
                                    device=None if ref is None else ref.device)
                    for a in args])
    return wrapped


_X_EXPR_NAMESPACE = {
    "sin": _torch_fn(torch.sin),
    "cos": _torch_fn(torch.cos),
    "tan": _torch_fn(torch.tan),
    "exp": _torch_fn(torch.exp),
    "log": _torch_fn(torch.log),
    "sqrt": _torch_fn(torch.sqrt),
    "abs": _torch_fn(torch.abs),
    "pi": math.pi,
    "pow": _torch_fn(torch.pow),
}
_ALLOWED_X_EXPR = re.compile(r"^[\w\s\+\-\*/\(\)\.,\[\]]+$")


class ExpressionFunction(Function):
    """Scalar function from an expression string in x[0], x[1]."""

    def __init__(self, expression: str, order: int = 2, name: str = "expression"):
        if not _ALLOWED_X_EXPR.match(expression):
            raise ValueError(f"disallowed characters in expression {expression!r}")
        self.expression = str(expression)
        code = compile(self.expression, f"<fn:{expression}>", "eval")
        for nm in code.co_names:
            if nm not in _X_EXPR_NAMESPACE and nm != "x":
                raise ValueError(f"unknown name {nm!r} in expression {expression!r}")
        self._code = code
        self.order = int(order)
        self.name = name
        self.range_shape = ()

    def __call__(self, x):
        env = dict(_X_EXPR_NAMESPACE)
        env["x"] = torch.movedim(x, -1, 0)  # x[0], x[1] broadcast over the batch
        out = eval(self._code, {"__builtins__": {}}, env)  # noqa: S307 - vetted charset
        out = torch.as_tensor(out, dtype=x.dtype, device=x.device)
        return torch.broadcast_to(out, x.shape[:-1])


class LambdaFunction(Function):
    """Wrap an arbitrary torch callable."""

    def __init__(self, fn: Callable, range_shape=(), order: int = 2, name: str = "lambda"):
        self._fn = fn
        self.range_shape = tuple(range_shape)
        self.order = int(order)
        self.name = name

    def __call__(self, x):
        return self._fn(x)


class IndicatorFunction(Function):
    """Sum of value_k * 1_{[lower_k, upper_k)}(x).  Boxes are HALF-OPEN so
    adjacent boxes sharing an edge never double-count at points on the
    shared line.  As in the reference, boxes and points are read in their
    first two coordinates: one with a single coordinate reads it twice (the
    reference's clamped gathers), and a third coordinate is not read (a 3D
    box is its 2D box extruded along x_2)."""

    def __init__(self, subdomains: Sequence[Tuple[Sequence[float], Sequence[float], float]],
                 name: str = "indicator"):
        def first_two(p):
            return float(p[0]), float(p[min(1, len(p) - 1)])

        self.boxes = [(first_two(lo), first_two(up), float(v)) for lo, up, v in subdomains]
        self.order = 0
        self.name = name
        self.range_shape = ()

    def __call__(self, x: Points) -> torch.Tensor:
        x0, x1 = _planes(x)
        # one box at a time: never materializes a [K, points] intermediate
        # (105 channel boxes at millions of points); the boxes are disjoint,
        # so the summation order cannot change the result
        out = torch.zeros_like(x0)
        for (l0, l1), (u0, u1), v in self.boxes:
            inside = (x0 >= l0) & (x0 < u0) & (x1 >= l1) & (x1 < u1)
            out = out + v * inside.to(x0.dtype)
        return out


class FlatTopFunction(Function):
    """Smoothed indicator with boundary layer delta per dim: value on the
    inner box, 0 outside, the C^1 smoothstep 3t^2 - 2t^3 within the layer."""

    def __init__(self, lower, upper, boundary_layer, value: float = 1.0,
                 name: str = "flattop"):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.delta = np.asarray(boundary_layer, dtype=np.float64)
        self.value = float(value)
        self.order = 3
        self.name = name
        self.range_shape = ()

    def __call__(self, x):
        d = _like(x, self.delta)
        lo, up = _like(x, self.lower), _like(x, self.upper)
        safe = torch.clamp(d, min=1e-300)
        t_lo = torch.clamp((x - (lo - d)) / safe, 0.0, 1.0)
        t_hi = torch.clamp(((up + d) - x) / safe, 0.0, 1.0)

        def ramp(t):
            return 3.0 * t**2 - 2.0 * t**3

        return self.value * torch.prod(ramp(t_lo) * ramp(t_hi), dim=-1)


class CheckerboardFunction(Function):
    """Piecewise-constant on a tensor partition of [lower, upper] in d = 1,
    2, 3; block ordering x fastest (ix + nx*(iy + ny*iz))."""

    def __init__(self, lower, upper, num_elements, values, name: str = "checkerboard"):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.num_elements = tuple(int(n) for n in num_elements)
        vals = np.asarray(values, dtype=np.float64).reshape(-1)
        expected = int(np.prod(self.num_elements))
        if vals.shape[0] != expected:
            raise ValueError(f"expected {expected} values, got {vals.shape[0]}")
        self.values = vals
        self.order = 0
        self.name = name
        self.range_shape = ()

    def _block_index(self, x):
        d = len(self.num_elements)
        ne = _like(x, np.asarray(self.num_elements, dtype=np.float64))
        rel = (x[..., :d] - _like(x, self.lower)) / _like(x, self.upper - self.lower)
        ij = torch.minimum(torch.clamp(torch.floor(rel * ne), min=0.0), ne - 1).to(torch.long)
        idx = ij[..., 0]
        stride = 1
        for a in range(1, d):
            stride *= self.num_elements[a - 1]
            idx = idx + stride * ij[..., a]
        return idx

    def __call__(self, x):
        return _like(x, self.values)[self._block_index(x)]


class SumFunction(Function):
    def __init__(self, functions: Sequence[Function], name: str = "sum"):
        self.functions = list(functions)
        self.range_shape = self.functions[0].range_shape
        self.order = max(f.order for f in self.functions)
        self.name = name

    def __call__(self, x):
        out = self.functions[0](x)
        for f in self.functions[1:]:
            out = out + f(x)
        return out


class ProductFunction(Function):
    def __init__(self, functions: Sequence[Function], name: str = "product"):
        self.functions = list(functions)
        self.range_shape = max((f.range_shape for f in self.functions), key=len)
        self.order = sum(f.order for f in self.functions)
        self.name = name

    def __call__(self, x):
        out = self.functions[0](x)
        for f in self.functions[1:]:
            out = out * f(x)
        return out


class ScaledFunction(Function):
    def __init__(self, function: Function, scale: float, name: Optional[str] = None):
        self.function = function
        self.scale = float(scale)
        self.range_shape = function.range_shape
        self.order = function.order
        self.name = name or f"{scale}*{function.name}"

    def __call__(self, x):
        return self.scale * self.function(x)


class FrozenAffineFunction(Function):
    """Sum_q theta_q(mu) f_q(x) + affine_part(x) at a fixed mu."""

    def __init__(self, decomposition: "ParametricFunction", mu: Parameter,
                 name: str = "frozen"):
        self.decomposition = decomposition
        self.mu = mu
        parts = decomposition.components + (
            [decomposition.affine_part] if decomposition.affine_part is not None else []
        )
        self.range_shape = parts[0].range_shape
        self.order = max(p.order for p in parts)
        self.name = name

    def __call__(self, x):
        dec = self.decomposition
        out = None
        for q in range(dec.num_components):
            term = float(dec.coefficients[q](self.mu)) * dec.components[q](x)
            out = term if out is None else out + term
        if dec.affine_part is not None:
            part = dec.affine_part(x)
            out = part if out is None else out + part
        return out


#: An affinely decomposable function is an AffineDecomposition of Functions.
ParametricFunction = AffineDecomposition


def nonparametric(f: Function) -> ParametricFunction:
    return AffineDecomposition(affine_part=f)


def freeze_function(pf: ParametricFunction, mu: Optional[Parameter] = None) -> Function:
    if not pf.parametric():
        return pf.affine_part
    return FrozenAffineFunction(pf, mu or {})


def make_checkerboard_decomposition(
    lower, upper, num_elements, parameter_name: str = "diffusion_factor",
    name: str = "checkerboard",
) -> ParametricFunction:
    """Parametric checkerboard: one indicator component and one parameter
    entry per block, d = 1, 2, 3, block numbering x fastest."""
    ne = tuple(int(n) for n in num_elements)
    nblocks = int(np.prod(ne))
    lower = np.asarray(lower, dtype=float)[: len(ne)]
    upper = np.asarray(upper, dtype=float)[: len(ne)]
    pt = ParameterType({parameter_name: nblocks})
    dec = AffineDecomposition()
    for block in range(nblocks):
        values = np.zeros(nblocks)
        values[block] = 1.0
        comp = CheckerboardFunction(lower, upper, ne, values, name=f"{name}_{block}")
        dec.register_component(comp, ParameterFunctional(pt, f"{parameter_name}[{block}]"))
    return dec
