"""parameters.py and affine.py of the PyTorch port against the JAX package's
(x64, CPU), on the same seeded numpy inputs: parsing, parameter functionals,
and freezing affine decompositions of vectors and of SparseMatrix, to
1e-14 relative (both sides sum the same float64 terms in the same order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import affine as jx_affine  # noqa: E402
from dune_hdd_tpu import parameters as jx_par  # noqa: E402
from dune_hdd_tpu.la import sparse as jx_sparse  # noqa: E402
from dune_hdd_tpu_torch import affine as pt_affine  # noqa: E402
from dune_hdd_tpu_torch import parameters as pt_par  # noqa: E402
from dune_hdd_tpu_torch.convert import pattern_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.la import sparse as pt_sparse  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-14
TYPE = {"diffusion_factor": 4, "mu": 1, "nu": 3}
EXPRESSIONS = [
    "mu",
    "-1.0*mu",
    "diffusion_factor[2]",
    "1 + 0.75*sin(4*pi*mu[0])",
    "exp(-nu[1]) * sqrt(abs(nu[2])) + log(1 + mu)",
    "pow(mu, 2) / (1 + nu[0]*nu[0]) - cos(diffusion_factor[3])",
    "min(mu[0], nu[1]) + max(diffusion_factor[0], nu[2]) + tan(0.1*mu)",
]


def _mu(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.1, 2.0, n) for k, n in TYPE.items()}


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=0)


def test_parameter_type_merge_and_parse():
    a, b = pt_par.ParameterType({"b": 2, "a": 1}), pt_par.ParameterType(c=3)
    ja, jb = jx_par.ParameterType({"b": 2, "a": 1}), jx_par.ParameterType(c=3)
    assert list((a | b).items()) == list((ja | jb).items())
    assert repr(a | b) == repr(ja | jb)
    with pytest.raises(ValueError):
        a | pt_par.ParameterType(a=2)
    pt_t, jx_t = pt_par.ParameterType(TYPE), jx_par.ParameterType(TYPE)
    flat = np.random.default_rng(1).uniform(size=8)
    for mu in (flat, _mu(2)):
        got, want = pt_par.parse_parameter(mu, pt_t), jx_par.parse_parameter(mu, jx_t)
        assert sorted(got) == sorted(want)
        for k in got:
            _close(got[k], want[k])
        assert pt_par.parameter_key(got) == jx_par.parameter_key(want)
    single = pt_par.ParameterType(mu=1)
    _close(pt_par.parse_parameter(0.3, single)["mu"],
           jx_par.parse_parameter(0.3, jx_par.ParameterType(mu=1))["mu"])
    with pytest.raises(ValueError):
        pt_par.parse_parameter(flat[:3], pt_t)
    assert pt_par.parse_parameter(None) == {}


@pytest.mark.parametrize("expression", EXPRESSIONS)
def test_parameter_functional(expression):
    f = pt_par.ParameterFunctional(TYPE, expression)
    g = jx_par.ParameterFunctional(TYPE, expression)
    parsed = [pt_par.parse_parameter(_mu(seed)) for seed in range(3)]
    for seed, mu in enumerate(parsed):
        _close(f(mu), g(jx_par.parse_parameter(_mu(seed))))
    # stacked [M, k] components evaluate all M parameters at once
    stacked = {k: torch.stack([mu[k] for mu in parsed]) for k in parsed[0]}
    np.testing.assert_allclose(f(stacked).expand(3).numpy(),
                               [float(f(mu)) for mu in parsed], rtol=1e-15, atol=0)
    assert f == pt_par.ParameterFunctional(TYPE, expression)
    assert repr(f) == repr(g)


def test_functional_products_and_errors():
    a = pt_par.ParameterFunctional(TYPE, EXPRESSIONS[3])
    b = pt_par.ParameterFunctional({"mu": 1}, "2*mu")
    ja = jx_par.ParameterFunctional(TYPE, EXPRESSIONS[3])
    jb = jx_par.ParameterFunctional({"mu": 1}, "2*mu")
    mu = _mu(5)
    p, jp = pt_par.ProductFunctional(a, b), jx_par.ProductFunctional(ja, jb)
    assert p.expression == jp.expression
    _close(p(pt_par.parse_parameter(mu)), jp(jx_par.parse_parameter(mu)))
    _close(pt_par.ConstantFunctional(2.5)({}), jx_par.ConstantFunctional(2.5)({}))
    with pytest.raises(ValueError):
        pt_par.ParameterFunctional(TYPE, "__import__('os')")
    with pytest.raises(ValueError):
        pt_par.ParameterFunctional(TYPE, "unknown_name + 1")
    with pytest.raises(KeyError):
        pt_par.ParameterFunctional(TYPE, "mu")({"nu": torch.ones(3)})


def _decompositions(payloads, affine_part):
    pt_dec = pt_affine.AffineDecomposition()
    jx_dec = jx_affine.AffineDecomposition()
    for q, (p, j) in enumerate(payloads):
        expr = EXPRESSIONS[q % len(EXPRESSIONS)]
        pt_dec.register_component(p, pt_par.ParameterFunctional(TYPE, expr))
        jx_dec.register_component(j, jx_par.ParameterFunctional(TYPE, expr))
    if affine_part is not None:
        pt_dec.register_affine_part(affine_part[0])
        jx_dec.register_affine_part(affine_part[1])
    return pt_dec, jx_dec


@pytest.mark.parametrize("with_affine_part", [True, False])
def test_freeze_vectors(with_affine_part):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(50) for _ in range(5)]
    pairs = [(torch.tensor(a), jnp.asarray(a)) for a in arrays]
    pt_dec, jx_dec = _decompositions(pairs[:4], pairs[4] if with_affine_part else None)
    assert pt_dec.parameter_type == pt_par.ParameterType(dict(jx_dec.parameter_type.items()))
    for seed in range(3):
        mu = _mu(seed)
        _close(pt_dec.freeze(pt_par.parse_parameter(mu)),
               jx_dec.freeze(jx_par.parse_parameter(mu)))
        _close(pt_dec.thetas(pt_par.parse_parameter(mu)),
               jx_dec.thetas(jx_par.parse_parameter(mu)))
    expanded = pt_dec.with_expanded_affine_part()
    assert expanded.num_components == jx_dec.with_expanded_affine_part().num_components
    assert expanded.affine_part is None
    assert pt_dec.find_component(pt_dec.coefficients[2]) == 2


def test_freeze_sparse_matrix_and_coefficient_bounds():
    rng = np.random.default_rng(8)
    n, e = 40, 300
    rows, cols = rng.integers(0, n, e), rng.integers(0, n, e)
    jx_pattern = jx_sparse.build_pattern(rows, cols, (n, n))
    pt_pattern = pt_sparse.build_pattern(rows, cols, (n, n))
    converted = pattern_from_numpy(jx_pattern)
    for name in ("perm", "seg_ids", "slot_rows", "slot_cols", "ell_cols", "ell_mask",
                 "slot_ell_pos", "diag_slot"):
        np.testing.assert_array_equal(getattr(pt_pattern, name), getattr(jx_pattern, name))
        np.testing.assert_array_equal(getattr(converted, name), getattr(jx_pattern, name))
    values = [rng.standard_normal(jx_pattern.nnz) for _ in range(4)]
    pairs = [(pt_sparse.SparseMatrix(pt_pattern, torch.tensor(v)),
              jx_sparse.SparseMatrix(jx_pattern, jnp.asarray(v))) for v in values]
    pt_dec, jx_dec = _decompositions(pairs[:3], pairs[3])
    for seed in range(3):
        mu = _mu(seed)
        got = pt_dec.freeze(pt_par.parse_parameter(mu))
        want = jx_dec.freeze(jx_par.parse_parameter(mu))
        _close(got.values, want.values)
        x = rng.standard_normal(n)
        _close(got.matvec(torch.tensor(x)), want.matvec(jnp.asarray(x)), rtol=1e-13)
    mu, mu_ref = _mu(1), _mu(2)
    lo, hi = pt_affine.coefficient_bounds(pt_dec, pt_par.parse_parameter(mu),
                                          pt_par.parse_parameter(mu_ref))
    jlo, jhi = jx_affine.coefficient_bounds(jx_dec, jx_par.parse_parameter(mu),
                                            jx_par.parse_parameter(mu_ref))
    _close([lo, hi], [jlo, jhi])
    one = pt_affine.coefficient_bounds(pt_affine.affine_from_parts(pairs[0][0]), {}, {})
    _close(one, [1.0, 1.0])
