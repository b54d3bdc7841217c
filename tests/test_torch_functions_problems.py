"""functions/ and problems/ of the PyTorch port against the JAX package's
(x64, CPU): every function class, and every data entry of the ESV2007 and
thermalblock problems (frozen at seeded mu), at the same seeded points, to
1e-13 relative (the same float64 formulas; the two libraries' sin/cos/exp
may differ in the last ulp)."""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.functions import base as jb  # noqa: E402
from dune_hdd_tpu.functions import esv2007 as je  # noqa: E402
from dune_hdd_tpu import problems as jp  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tb  # noqa: E402
from dune_hdd_tpu_torch.functions import esv2007 as te  # noqa: E402
from dune_hdd_tpu_torch import problems as tp  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-13
BOXES = [((0.0, 0.0), (0.5, 0.5), 2.0), ((0.25, 0.5), (1.0, 0.75), -1.5),
         ((0.5, 0.0), (1.0, 0.5), 0.25)]


def _points(d=2, shape=(7, 5), lo=-0.1, hi=1.1, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape + (d,))


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=1e-15)


def _pair(case):
    """(port function, reference function, point dimension) for ``case``."""
    if case == "constant":
        return tb.ConstantFunction(2.5), jb.ConstantFunction(2.5), 2
    if case == "constant_matrix":
        return tb.constant_matrix(0.3), jb.constant_matrix(0.3), 2
    if case == "expression":
        e = "1+0.75*(sin(4*pi*(x[0]+0.5*x[1]))) + exp(-x[1])*sqrt(abs(x[0]))"
        return tb.ExpressionFunction(e, order=3), jb.ExpressionFunction(e, order=3), 2
    if case == "lambda":
        return (tb.LambdaFunction(lambda x: x[..., 0] * torch.cos(x[..., 1])),
                jb.LambdaFunction(lambda x: x[..., 0] * jnp.cos(x[..., 1])), 2)
    if case == "checkerboard":
        vals = np.arange(6.0) + 1
        return (tb.CheckerboardFunction((0, 0), (1, 1), (3, 2), vals),
                jb.CheckerboardFunction((0, 0), (1, 1), (3, 2), vals), 2)
    if case == "checkerboard_3d":
        vals = np.arange(12.0) - 3
        return (tb.CheckerboardFunction((0, 0, 0), (1, 1, 1), (2, 3, 2), vals),
                jb.CheckerboardFunction((0, 0, 0), (1, 1, 1), (2, 3, 2), vals), 3)
    if case == "indicator":
        return tb.IndicatorFunction(BOXES), jb.IndicatorFunction(BOXES), 2
    if case == "flattop":
        return (tb.FlatTopFunction((0.2, 0.3), (0.6, 0.7), (0.1, 0.05), 3.0),
                jb.FlatTopFunction((0.2, 0.3), (0.6, 0.7), (0.1, 0.05), 3.0), 2)
    if case == "sum":
        return (tb.ConstantFunction(1.0) + tb.IndicatorFunction(BOXES),
                jb.ConstantFunction(1.0) + jb.IndicatorFunction(BOXES), 2)
    if case == "product":
        return (tb.ExpressionFunction("x[0]*x[1]") * tb.IndicatorFunction(BOXES),
                jb.ExpressionFunction("x[0]*x[1]") * jb.IndicatorFunction(BOXES), 2)
    if case == "scaled":
        return (tb.ScaledFunction(tb.IndicatorFunction(BOXES), -0.9),
                jb.ScaledFunction(jb.IndicatorFunction(BOXES), -0.9), 2)
    if case == "frozen_checkerboard":
        mu = {"diffusion_factor": np.random.default_rng(3).uniform(0.1, 1, 6)}
        return (tb.freeze_function(tb.make_checkerboard_decomposition((0, 0), (1, 1), (3, 2)),
                                   mu),
                jb.freeze_function(jb.make_checkerboard_decomposition((0, 0), (1, 1), (3, 2)),
                                   {k: jnp.asarray(v) for k, v in mu.items()}), 2)
    if case == "nonparametric":
        return (tb.freeze_function(tb.nonparametric(tb.FlatTopFunction((0, 0), (1, 1), 0.2))),
                jb.freeze_function(jb.nonparametric(jb.FlatTopFunction((0, 0), (1, 1), 0.2))), 2)
    if case == "esv2007_force":
        return te.Testcase1Force(), je.Testcase1Force(), 2
    if case == "esv2007_exact":
        return te.Testcase1ExactSolution(), je.Testcase1ExactSolution(), 2
    raise KeyError(case)


CASES = ["constant", "constant_matrix", "expression", "lambda", "checkerboard",
         "checkerboard_3d", "indicator", "flattop", "sum", "product", "scaled",
         "frozen_checkerboard", "nonparametric", "esv2007_force", "esv2007_exact"]
WITH_GRADIENT = {"expression", "lambda", "flattop", "esv2007_exact", "constant"}


@pytest.mark.parametrize("case", CASES)
def test_function(case):
    f, g, d = _pair(case)
    x = _points(d)
    _close(f(torch.tensor(x)), g(jnp.asarray(x)))
    assert tuple(f.range_shape) == tuple(g.range_shape)
    assert f.order == g.order
    if case in WITH_GRADIENT:
        _close(f.gradient(torch.tensor(x)), g.gradient(jnp.asarray(x)))


def test_cutoff_and_plane_pairs():
    lam, kap = tb.ConstantFunction(2.0), tb.ConstantFunction([[1.0, 0.2], [0.2, 0.5]])
    jlam, jkap = jb.ConstantFunction(2.0), jb.ConstantFunction([[1.0, 0.2], [0.2, 0.5]])
    x = _points()
    c, jc = te.CutoffFunction(lam, kap), je.CutoffFunction(jlam, jkap)
    _close(c.min_diffusion_eigenvalue(torch.tensor(x)),
           jc.min_diffusion_eigenvalue(jnp.asarray(x)))
    assert math.isclose(c.poincare_constant, jc.poincare_constant)
    # the coordinate-plane form of the stencil assembly's callers
    f = tb.IndicatorFunction(BOXES)
    xt = torch.tensor(x)
    _close(f((xt[..., 0], xt[..., 1])), f(xt))


@pytest.mark.parametrize("problem", ["esv2007", "thermalblock", "thermalblock_3x2",
                                     "local_thermalblock", "default"])
def test_problem_entries(problem):
    pt_prob, jx_prob = {
        "esv2007": (tp.ESV2007Problem(), jp.ESV2007Problem()),
        "thermalblock": (tp.ThermalblockProblem((2, 2)), jp.ThermalblockProblem((2, 2))),
        "thermalblock_3x2": (tp.ThermalblockProblem((3, 2), (0, 0), (2, 1)),
                             jp.ThermalblockProblem((3, 2), (0, 0), (2, 1))),
        "local_thermalblock": (tp.LocalThermalblockProblem(), jp.LocalThermalblockProblem()),
        "default": (tp.DefaultProblem.create({"force": {"type": "stuff.function.expression",
                                                        "expression": "x[0]*x[1]"}}),
                    jp.DefaultProblem.create({"force": {"type": "stuff.function.expression",
                                                        "expression": "x[0]*x[1]"}})),
    }[problem]
    assert repr(pt_prob.parameter_type) == repr(jx_prob.parameter_type)
    assert pt_prob.report() == jx_prob.report()
    x = _points(shape=(6, 4), lo=0.0, hi=1.0, seed=4)
    mus = [None]
    if pt_prob.parametric():
        rng = np.random.default_rng(5)
        size = sum(n for _, n in pt_prob.parameter_type.items())
        mus = [rng.uniform(0.1, 1.0, size) for _ in range(3)]
    for mu in mus:
        pf = pt_prob.with_mu(mu) if mu is not None else pt_prob
        jf = jx_prob.with_mu(mu) if mu is not None else jx_prob
        for name, dec in pf.entries().items():
            got = tb.freeze_function(dec)(torch.tensor(x))
            want = jb.freeze_function(jf.entries()[name])(jnp.asarray(x))
            _close(got, want)


# -- ProblemsProvider, MixedBoundariesProblem, Problem.visualize ----------------

def _provider_mus(problem):
    if not problem.parametric():
        return [None]
    rng = np.random.default_rng(8)
    size = sum(n for _, n in problem.parameter_type.items())
    return [rng.uniform(0.1, 1.0, size) for _ in range(2)]


def _same_entries(pt_prob, jx_prob, x):
    assert repr(pt_prob.parameter_type) == repr(jx_prob.parameter_type)
    assert pt_prob.report() == jx_prob.report()
    for mu in _provider_mus(pt_prob):
        pf = pt_prob.with_mu(mu) if mu is not None else pt_prob
        jf = jx_prob.with_mu(mu) if mu is not None else jx_prob
        for name, dec in pf.entries().items():
            _close(tb.freeze_function(dec)(torch.tensor(x)),
                   jb.freeze_function(jf.entries()[name])(jnp.asarray(x)))


def test_problems_provider_registry():
    assert tp.ProblemsProvider.available() == jp.ProblemsProvider.available()
    for name in jp.ProblemsProvider.available():
        assert tp.ProblemsProvider.default_config(name) == jp.ProblemsProvider.default_config(name)
    assert type(tp.ProblemsProvider.create("ESV2007")).__name__ == "ESV2007Problem"
    with pytest.raises(ValueError, match="unknown problem type"):
        tp.ProblemsProvider.create("nope")


@pytest.mark.parametrize("name", sorted(set(jp.ProblemsProvider.available())))
def test_problems_provider_create(name):
    """Each registered problem from its default config equals the
    reference's at sample points (frozen at seeded mu when parametric)."""
    cfg = jp.ProblemsProvider.default_config(name)
    pt_prob = tp.ProblemsProvider.create(name, cfg)
    jx_prob = jp.ProblemsProvider.create(name, cfg)
    assert type(pt_prob).__name__ == type(jx_prob).__name__
    assert pt_prob.type() == jx_prob.type()
    _same_entries(pt_prob, jx_prob, _points(shape=(5, 4), lo=0.0, hi=1.0, seed=6))


def test_mixed_boundaries_problem():
    pt_prob, jx_prob = tp.MixedBoundariesProblem(), jp.MixedBoundariesProblem()
    assert pt_prob.static_id == jx_prob.static_id == "hdd.linearelliptic.problem.mixedboundaries"
    assert tp.MixedBoundariesProblem.create({}).default_config() == {}
    _same_entries(pt_prob, jx_prob, _points(shape=(6, 3), lo=-1.0, hi=1.0, seed=7))


def _vtu_arrays(path):
    import re

    text = open(path).read()
    return {name: np.array(vals.split(), dtype=float) for name, vals in re.findall(
        r'<DataArray type="Float64" Name="([^"]+)" format="ascii">\n([^<]*)\n</DataArray>',
        text)}


@pytest.mark.parametrize("problem", ["esv2007", "thermalblock", "mixed"])
def test_problem_visualize(problem, tmp_path):
    """Every data entry and affine component as cell data, the values equal
    to the reference's (1e-13), the same files and fields."""
    from dune_hdd_tpu.grid import structured as jg
    from dune_hdd_tpu_torch.grid import structured as tg

    pt_prob, jx_prob, mu = {
        "esv2007": (tp.ESV2007Problem(), jp.ESV2007Problem(), None),
        "thermalblock": (tp.ThermalblockProblem((2, 2)), jp.ThermalblockProblem((2, 2)),
                         {"diffusion_factor": np.array([0.1, 0.2, 0.5, 1.0])}),
        "mixed": (tp.MixedBoundariesProblem(), jp.MixedBoundariesProblem(), None),
    }[problem]
    t_grid = tg.rectangle_grid((0, 0), (1, 1), (4, 3))
    j_grid = jg.rectangle_grid((0, 0), (1, 1), (4, 3))
    t_paths = pt_prob.visualize(t_grid, str(tmp_path / "port" / problem), mu=mu, device="cpu")
    j_paths = jx_prob.visualize(j_grid, str(tmp_path / "reference" / problem), mu=mu)
    assert [os.path.basename(p) for p in t_paths] == [os.path.basename(p) for p in j_paths]
    for a, b in zip(t_paths, j_paths):
        fa, fb = _vtu_arrays(a), _vtu_arrays(b)
        assert list(fa) == list(fb)
        for name in fa:
            _close(fa[name], fb[name])


def test_problem_visualize_tensor_grid_raises_like_reference(tmp_path):
    """The reference's writer has no hexahedra: both raise the same error."""
    from dune_hdd_tpu.grid.tensor import tensor_grid as jtensor_grid
    from dune_hdd_tpu_torch.grid.tensor import tensor_grid

    with pytest.raises(AttributeError) as port_err:
        tp.ESV2007Problem().visualize(tensor_grid((0.0,) * 3, (1.0,) * 3, (2, 2, 2)),
                                      str(tmp_path / "p"), device="cpu")
    with pytest.raises(AttributeError) as ref_err:
        jp.ESV2007Problem().visualize(jtensor_grid((0.0,) * 3, (1.0,) * 3, (2, 2, 2)),
                                      str(tmp_path / "j"))
    assert str(port_err.value) == str(ref_err.value)
