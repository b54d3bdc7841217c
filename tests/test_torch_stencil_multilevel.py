"""The large-size solver pieces of the PyTorch port (la/stencil.py) against
the JAX package's, on the bench's scaled SPE10 operator at 4 bisections
(lattice 40 x 200) with the exact level at (25, 5) and the middle level at
(100, 20), as the reference's own multilevel test cuts it (float32, the
reference in its bench scope: x64 off, highest matmul precision):

* the symmetrized (half-storage) operator: matvec 1e-5 x max (f32) and
  1e-12 x max (f64, ``astype`` keeps it symmetric), within assembly
  roundoff (1e-5 x max) of the assembled operator, and exactly symmetric;
* stencil bands, their re-aggregation and the dense coarse operator,
  1e-6 x max;
* the power iteration's lambda_max, rel 1e-4;
* the middle-level inverse and the three-level and chain preconditioner
  applies, 2e-4 x max;
* the refined solve with the symmetric operator and the three-level
  preconditioner reaching a true 1e-6;
* PCG with float64 Krylov vectors and/or dots (2 bisections): iterations
  within 2, X within the measured float32 floor of 1e-3 x max, every inner
  product taken in the dot dtype, and with float64 vectors a true residual
  that float32 vectors do not reach.
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.la import stencil as jx  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import build_spe10_bench  # noqa: E402
from dune_hdd_tpu_torch.convert import stencil_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference  # noqa: E402
from dune_hdd_tpu_torch.kernels.sym_plane_spmv import (  # noqa: E402
    sym_plane_spmv,
    sym_plane_spmv_reference,
)
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BISECTIONS = 4
MACRO = (25, 5)    # the exact level, aggregation factor 8 from the fine lattice
MID = (100, 20)    # the middle level, factor 2 from the fine lattice
CHAIN = [(100, 20), (50, 10)]


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs), for the module's fixtures
    too."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield


@contextlib.contextmanager
def _jx_f32():
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        yield


def _scaled_system(bisections):
    bench = build_spe10_bench(bisections, device="cpu")
    S, B, s = bench.assemble(bench.field)
    return S.planes.numpy(), B.numpy(), s.numpy(), S.plan


@pytest.fixture(scope="module")
def system():
    """(planes, B, s, plan) of the bench's scaled system, as numpy."""
    return _scaled_system(BISECTIONS)


def _both(system, dtype=np.float32):
    planes, _, _, plan = system
    planes = planes.astype(dtype)
    return stencil_from_numpy(planes, plan, "cpu"), jx.StencilBlockEll(jnp.asarray(planes), plan)


def _r(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_symmetrized_matvec_matches(system, dtype, rel):
    S_t, S_j = _both(system, dtype)
    X = _r(system[1].shape, 1, dtype)
    with _jx_f32() if dtype == np.float32 else contextlib.nullcontext():
        y_j = np.asarray(S_j.symmetrized().matvec(jnp.asarray(X)))
    Ssym = S_t.symmetrized()
    assert Ssym.spmv is sym_plane_spmv and S_t.spmv is plane_spmv
    assert Ssym.sym and not S_t.sym and Ssym.planes is S_t.planes
    _close(Ssym.matvec(torch.as_tensor(X)).numpy(), y_j, rel)
    # within assembly roundoff of the assembled operator
    _close(Ssym.matvec(torch.as_tensor(X)).numpy(), S_t.matvec(torch.as_tensor(X)).numpy(), 1e-5)


def test_symmetrized_astype_keeps_sym_and_is_symmetric(system):
    S_t, _ = _both(system)
    S64 = S_t.symmetrized().astype(torch.float64)
    assert S64.spmv is sym_plane_spmv and S64.sym and S64.planes.dtype == torch.float64
    np.testing.assert_array_equal(S64.planes.numpy(), S_t.planes.double().numpy())
    # the half-storage operator is the materialized symmetric planes' one
    np.testing.assert_array_equal(pt.symmetric_planes(S64).numpy(),
                                  pt.symmetric_planes(S_t).double().numpy())
    x = torch.as_tensor(_r(system[1].shape, 2, np.float64))
    y = torch.as_tensor(_r(system[1].shape, 3, np.float64))
    lhs = float(torch.dot(S64.matvec(x).reshape(-1), y.reshape(-1)))
    rhs = float(torch.dot(x.reshape(-1), S64.matvec(y).reshape(-1)))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def _pairing(S, weight, stack):
    wnbr = S.neighbor_fields(weight)
    return stack([(weight[:, None] * S.planes[s] * wnbr[s][None, :]).sum((0, 1))
                  for s in range(4)])


def _bands_close(bands_t, bands_j, rel):
    assert list(bands_t) == list(bands_j)  # keys in the reference's order
    scale = max(float(np.abs(np.asarray(v)).max()) for v in bands_j.values())
    for key, vec in bands_j.items():
        np.testing.assert_allclose(bands_t[key].numpy(), np.asarray(vec), rtol=0,
                                   atol=rel * scale, err_msg=str(key))


def test_stencil_bands_aggregate_and_dense_match(system):
    """Each function on the same inputs: the weighted pairing sums, then the
    reference's bands of each stage."""
    S_t, S_j = _both(system)
    w = 1.0 / system[2]
    with _jx_f32():
        Pw = _pairing(S_j, jnp.asarray(w), jnp.stack)
        agg_j = jx._aggregation2d(S_j, MID)
        bands1_j = jx._stencil_bands(S_j, agg_j, Pw)
        gy, gx = agg_j.my // MACRO[1], agg_j.mx // MACRO[0]
        bands2_j = jx._aggregate_bands(bands1_j, agg_j.my, agg_j.mx, gy, gx)
        E_j = np.asarray(jx._bands_to_dense(bands2_j, MACRO[1], MACRO[0]))
    agg_t = pt._aggregation2d(S_t, MID)
    assert (agg_t.mx, agg_t.my, agg_t.fy, agg_t.fx) == (agg_j.mx, agg_j.my, agg_j.fy, agg_j.fx)
    _bands_close(pt._stencil_bands(S_t, agg_t, torch.as_tensor(np.asarray(Pw))), bands1_j, 1e-6)

    def t(bands):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in bands.items()}

    _bands_close(pt._aggregate_bands(t(bands1_j), agg_j.my, agg_j.mx, gy, gx), bands2_j, 1e-6)
    _close(pt._bands_to_dense(t(bands2_j), MACRO[1], MACRO[0]).numpy(), E_j, 1e-6)
    # the 2D aggregation's sums and broadcast
    R = _r(system[1].shape, 4)
    with _jx_f32():
        a_j = np.asarray(agg_j.aggsum(jnp.asarray(R)))
        b_j = np.asarray(agg_j.broadcast(jnp.asarray(a_j)))
    _close(agg_t.aggsum(torch.as_tensor(R)).numpy(), a_j, 1e-6)
    np.testing.assert_array_equal(agg_t.broadcast(torch.as_tensor(a_j)).numpy(), b_j)


def test_power_lambda_max_matches(system):
    S_t, S_j = _both(system)
    with _jx_f32():
        bands_j = jx._stencil_bands(S_j, jx._aggregation2d(S_j, MID))
        d = bands_j[(0, 0)]
        lmax_j = float(jx._power_lambda_max(jx._band_matvec(bands_j), lambda r: r / d,
                                            (MID[1], MID[0]), jnp.float32))
    bands_t = {k: torch.as_tensor(np.asarray(v)) for k, v in bands_j.items()}
    d_t = bands_t[(0, 0)]
    lmax = pt._power_lambda_max(pt._band_matvec(bands_t), lambda r: r / d_t,
                                (MID[1], MID[0]), torch.float32)
    assert lmax.dtype == torch.float32
    assert float(lmax) == pytest.approx(lmax_j, rel=1e-4)


def test_middle_inverse_matches(system):
    """The middle level alone (Jacobi + the exact (25, 5) level, Chebyshev
    degree 2) on the reference's bands."""
    S_t, S_j = _both(system)
    w = 1.0 / system[2]
    r = _r((MID[1], MID[0]), 6)
    with _jx_f32():
        agg_j = jx._aggregation2d(S_j, MID)
        bands_j = jx._stencil_bands(S_j, agg_j, _pairing(S_j, jnp.asarray(w), jnp.stack))
        y_ref = np.asarray(jx._middle_inverse(bands_j, agg_j.my, agg_j.mx, MACRO)(jnp.asarray(r)))
    bands_t = {k: torch.as_tensor(np.asarray(v)) for k, v in bands_j.items()}
    y = pt._multilevel_inverse(bands_t, agg_j.my, agg_j.mx, [MACRO])(torch.as_tensor(r))
    _close(y.numpy(), y_ref, 2e-4)


@pytest.mark.parametrize("mid", [MID, CHAIN], ids=["three_level", "chain"])
def test_multilevel_apply_matches(system, mid):
    S_t, S_j = _both(system)
    w = 1.0 / system[2]
    R = _r(system[1].shape, 5)
    with _jx_f32():
        M_j = jx.stencil_deflation_preconditioner(S_j, MACRO, newton_schulz=2, mid_shape=mid,
                                                  mid_cheb=2, weight=jnp.asarray(w))
        z_ref = np.asarray(M_j(jnp.asarray(R)))
    M_t = pt.stencil_deflation_preconditioner(S_t, MACRO, weight=torch.as_tensor(w),
                                              newton_schulz=2, mid_shape=mid, mid_cheb=2)
    _close(M_t(torch.as_tensor(R)).numpy(), z_ref, 2e-4)


def test_multilevel_preconditioner_rejects_untiled_lattices(system):
    S_t, _ = _both(system)
    w = torch.as_tensor(1.0 / system[2])
    with pytest.raises(ValueError, match="does not tile"):
        pt.stencil_deflation_preconditioner(S_t, MACRO, weight=w, mid_shape=(30, 20))
    with pytest.raises(ValueError, match="does not tile"):
        pt.stencil_deflation_preconditioner(S_t, (30, 5), weight=w, mid_shape=MID)


def test_refined_solve_symmetric_three_level(system):
    planes, B, s, plan = system
    S = stencil_from_numpy(planes, plan, "cpu").symmetrized()
    M = pt.stencil_deflation_preconditioner(S, MACRO, weight=torch.as_tensor(1.0 / s),
                                            newton_schulz=2, mid_shape=MID, mid_cheb=2)
    X, res, iters, sweeps = pt.stencil_refined_solve(S, torch.as_tensor(B), M, tol=1e-6,
                                                     inner_iters=300, inner_rtol=3e-1,
                                                     outer_max=500, unroll=2)
    assert res <= 1e-6 and iters > 0 and sweeps > 1
    # the residual is the symmetric float64 operator's, rechecked plainly
    B64 = torch.as_tensor(B).double()
    R = B64 - sym_plane_spmv_reference(S.planes.double(), X, plan)
    assert float(R.norm() / B64.norm()) <= 1.01e-6


@pytest.mark.parametrize("vec64,dot64", [(True, False), (True, True), (False, True)])
def test_pcg_wide_vectors_and_dots_match(vec64, dot64, monkeypatch):
    """Both PCGs apply the reference's preconditioner and the float32
    operator, so the comparison is of the PCG alone.  X's bar is the float32
    floor of ``test_torch_stencil.test_pcg_matches``, 1e-3 x max: the matvec
    and the preconditioner still round in float32, and the reference's own X
    moves by up to
    4.4e-4 x max in these modes when every seventh entry of B moves by
    1.2e-7 relative (the port's X differs from it by 2.6e-4 to 4.9e-4).
    So X alone cannot tell float64 vectors from float32 ones cast at the
    end; the true residual ||B - A X|| can: float32 vectors leave it at
    1.7e-4, float64 vectors at 4e-5, both at rtol 1e-5 (the matvec's float32
    rounding of P and AP bounds it there)."""
    planes, B, s, plan = _scaled_system(2)
    S_t = stencil_from_numpy(planes, plan, "cpu")
    S_j = jx.StencilBlockEll(jnp.asarray(planes), plan)
    B = (B / np.linalg.norm(B.astype(np.float64))).astype(np.float32)
    with _jx_f32():
        M_j = jx.stencil_deflation_preconditioner(S_j, (100, 20), newton_schulz=2,
                                                  weight=jnp.asarray(1.0 / s))
    kw_j = {"vec_dtype": jnp.float64 if vec64 else None,
            "dot_dtype": jnp.float64 if dot64 else None}
    X_j, it_j = jx.stencil_pcg(S_j, jnp.asarray(B), M_j, rtol=1e-5, maxiter=2000, unroll=2,
                               **kw_j)
    X_j, it_j = np.asarray(X_j), int(it_j)

    def M_t(R):
        with _jx_f32():
            return torch.as_tensor(np.array(M_j(jnp.asarray(R.numpy()))))

    dots, dot = [], pt._dot

    def recording_dot(a, b):
        dots.append((a.dtype, b.dtype))
        return dot(a, b)

    monkeypatch.setattr(pt, "_dot", recording_dot)
    X_t, it_t = pt.stencil_pcg(S_t, torch.as_tensor(B), M_t, rtol=1e-5, maxiter=2000, unroll=2,
                               vec_dtype=torch.float64 if vec64 else None,
                               dot_dtype=torch.float64 if dot64 else None)
    B64 = torch.as_tensor(B).double()
    res = float((B64 - plane_spmv_reference(torch.as_tensor(planes).double(), X_t.double(), plan)
                 ).norm() / B64.norm())
    print(f"PCG (vec64={vec64}, dot64={dot64}): iterations port {it_t}, reference {it_j}; "
          f"true residual {res:.3e}")
    assert X_t.dtype == (torch.float64 if vec64 else torch.float32)
    dot_dtype = torch.float64 if dot64 else torch.float32
    assert dots and set(dots) == {(dot_dtype, dot_dtype)}
    assert abs(it_t - it_j) <= 2
    _close(X_t.numpy(), X_j, 1e-3)
    if vec64:
        assert res <= 8e-5
