"""Adaptive LRBMS enrichment of the PyTorch port against the JAX package's
(x64, CPU), on the reference test's configuration: OS2014 multiscale [2 2]
at level 0 (384 DoF) with 3 oversampling layers, mu = mu_bar = 0.3:

* adaptive_lrbms with worst-subdomain marking and with Doerfler(0.85)
  marking on eta_DF_OS2014: estimates, rb_bounds and true_errors at 1e-8
  relative, the same enriched subdomains, the local bases at 1e-8;
* snapshot_local_bases at 1e-10;
* doerfler_marking on crafted indicators (ties, a zero total, theta 1);
* the ValueError of an enrichment without oversampling.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from dune_hdd_tpu import mor as jmor  # noqa: E402
from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.testcases import OS2014MultiscaleTestCase as JTC  # noqa: E402
from dune_hdd_tpu_torch import mor as tmor  # noqa: E402
from dune_hdd_tpu_torch.discretizations.block_swipdg import (  # noqa: E402
    BlockSWIPDGDiscretization as TB,
)
from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase as TTC  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PARAMS = {"mu": 0.3, "mu_bar": 0.3, "mu_hat": 0.1, "mu_minimizing": 0.1}
LAYERS = 3
MARKINGS = {"worst": dict(marking="worst"),
            "doerfler": dict(marking=("doerfler", 0.85), marking_estimator_type="eta_DF_OS2014")}


def _case(tc_cls, block_cls, layers, **kw):
    tc = tc_cls(PARAMS, num_partitions=(2, 2), num_refinements=0, oversampling_layers=layers)
    return tc, block_cls(tc.level_grid(0), tc.boundary_info(), tc.problem,
                         num_partitions=(2, 2), oversampling_layers=layers, **kw)


@pytest.fixture(scope="module")
def cases():
    """(reference (test case, disc), port (test case, disc))."""
    return _case(JTC, JB, LAYERS), _case(TTC, TB, LAYERS, device="cpu")


@pytest.fixture(scope="module")
def runs(cases):
    """{marking: (reference result, port result)}, one enrichment each."""
    (jtc, jd), (ttc, td) = cases
    out = {}
    for name, kw in MARKINGS.items():
        common = dict(max_enrichments=1, target_estimate=1e-6, track_true_errors=True, **kw)
        out[name] = (jmor.adaptive_lrbms(jd, jtc.parameters["mu"], jtc.estimator_parameters(),
                                         **common),
                     tmor.adaptive_lrbms(td, ttc.parameters["mu"], ttc.estimator_parameters(),
                                         **common))
    return out


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("marking", list(MARKINGS))
def test_adaptive_lrbms_matches_reference(marking, runs):
    jres, tres = runs[marking]
    for name in ("estimates", "rb_bounds", "true_errors"):
        got, want = getattr(tres, name), getattr(jres, name)
        assert len(got) == len(want) == 2, name
        np.testing.assert_allclose(got, want, rtol=1e-8, err_msg=name)
    assert tres.enriched_subdomains == jres.enriched_subdomains
    assert len(tres.enriched_subdomains) == 1
    for ss, (t, j) in enumerate(zip(tres.local_bases, jres.local_bases, strict=True)):
        _close(t, j, 1e-8, f"local basis {ss}")
    _close(tres.basis, jres.basis, 1e-8, "basis")
    # the enrichment lowers the reduced-consistent bound and the true error
    assert tres.rb_bounds[1] < tres.rb_bounds[0]
    assert tres.true_errors[1] < tres.true_errors[0]


def test_snapshot_local_bases_match_reference(cases):
    (_, jd), (_, td) = cases
    jb, tb = jmor.snapshot_local_bases(jd, 1.0), tmor.snapshot_local_bases(td, 1.0)
    assert len(tb) == len(jb) == 4
    for ss, (t, j) in enumerate(zip(tb, jb, strict=True)):
        assert t.shape == (1, len(td._local_dof_map(ss)))
        _close(t, j, 1e-10, f"subdomain {ss}")


@pytest.mark.parametrize("indicators,theta,want", [
    ([1.0, 3.0, 2.0, 0.5], 0.4, [1]),
    ([1.0, 3.0, 2.0, 0.5], 0.6, [1, 2]),
    ([1.0, 3.0, 2.0, 0.5], 0.95, [1, 2, 0, 3]),
    ([2.0, 2.0, 2.0, 2.0], 0.5, [0, 1]),     # ties: the stable order
    ([2.0, 2.0, 2.0, 2.0], 1.0, [0, 1, 2, 3]),
    ([0.0, 0.0, 0.0], 0.85, [0]),             # zero total: the worst one
    ([-1.0, 0.0, -2.0], 0.85, [0]),           # negative indicators count as 0
    ([], 0.85, []),
])
def test_doerfler_marking(indicators, theta, want):
    assert tmor.doerfler_marking(np.asarray(indicators), theta) == want
    assert jmor.doerfler_marking(np.asarray(indicators), theta) == want


def test_adaptive_requires_oversampling():
    tc, d = _case(TTC, TB, 0, device="cpu")
    with pytest.raises(ValueError):
        tmor.adaptive_lrbms(d, tc.parameters["mu"], tc.estimator_parameters(), max_enrichments=1)
