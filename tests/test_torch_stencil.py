"""Solver pieces of the PyTorch port (la/stencil.py) against the JAX
package's, on the same scaled SPE10 operator at 2 bisections (float32, the
reference in its bench scope: x64 off, highest matmul precision):

* block-Jacobi smoother, rtol 3e-5;
* weighted coarse bands and dense E, 1e-5 x max;
* the BCR (macro 50 x 10, fx = 2) and dense-LU (macro 100 x 20, fx = 1)
  coarse solves, 2e-5 x max;
* the weighted two-level deflation apply, 2e-4 x max;
* PCG: iteration counts within max(4, 10%), X within 1e-4 x max.
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
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402

BISECTIONS = 2
MACROS = [(100, 20), (50, 10)]  # fx = 1 (dense LU) and fx = 2 (BCR) at 2 bisections


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs) for the module's fixtures
    too, and one torch thread: the suite runs one worker process per core,
    and torch's intra-op pool on top of that oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _jx_f32():
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def system():
    """(planes, B, s, plan) of the bench's scaled system, as numpy."""
    bench = build_spe10_bench(BISECTIONS, device="cpu")
    S, B, s = bench.assemble(bench.field)
    return S.planes.numpy(), B.numpy(), s.numpy(), S.plan


def _both(system):
    planes, B, s, plan = system
    return stencil_from_numpy(planes, plan, "cpu"), jx.StencilBlockEll(jnp.asarray(planes), plan)


def _r(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_operator_accessors_match(system):
    """neighbor_fields, row_sums, diagonal_blocks and astype: bitwise except
    the row sums (reduction order), which hold at 1e-6 x max."""
    S_t, S_j = _both(system)
    X = _r(system[1].shape, 5)
    for f_t, f_j in zip(S_t.neighbor_fields(torch.as_tensor(X)),
                        S_j.neighbor_fields(jnp.asarray(X)), strict=True):
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(S_t.diagonal_blocks().numpy(), np.asarray(S_j.diagonal_blocks()))
    rs_j = np.asarray(S_j.row_sums())
    np.testing.assert_allclose(S_t.row_sums().numpy(), rs_j, rtol=0, atol=1e-6 * np.abs(rs_j).max())
    S64 = S_t.astype(torch.float64)
    assert S64.planes.dtype == torch.float64 and S64.plan == S_t.plan and S64.spmv is S_t.spmv
    np.testing.assert_array_equal(S64.planes.numpy(), np.asarray(S_j.astype(jnp.float64).planes))


def test_jacobi_smoother_matches(system):
    S_t, S_j = _both(system)
    R = _r(system[1].shape, 1)
    with _jx_f32():
        z_ref = np.asarray(jx.jacobi_smoother(S_j)(jnp.asarray(R)))
    z = pt.jacobi_smoother(S_t)(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=3e-5)


def _weighted_pairing(S, weight, stack):
    wnbr = S.neighbor_fields(weight)
    return stack([(weight[:, None] * S.planes[s] * wnbr[s][None, :]).sum((0, 1))
                  for s in range(4)])


@pytest.mark.parametrize("macro", MACROS)
def test_coarse_bands_dense_E_and_solves_match(system, macro):
    S_t, S_j = _both(system)
    w = 1.0 / system[2]
    with _jx_f32():
        agg_j = jx._aggregation(S_j, macro)
        Pw_j = _weighted_pairing(S_j, jnp.asarray(w), jnp.stack)
        bands_j = jx._coarse_bands(S_j, agg_j, Pw_j)
        E_j = np.asarray(jx._coarse_E_banded(S_j, agg_j, Pw_j))
    agg_t = pt._aggregation(S_t, macro)
    Pw_t = _weighted_pairing(S_t, torch.as_tensor(w), torch.stack)
    bands_t = pt._coarse_bands(S_t, agg_t, Pw_t)
    E_t = pt._coarse_E_banded(S_t, agg_t, Pw_t)

    assert sorted(bands_t) == sorted(bands_j)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in bands_j.values())
    for key, vec in bands_j.items():
        np.testing.assert_allclose(bands_t[key].numpy(), np.asarray(vec), rtol=0,
                                   atol=1e-5 * scale, err_msg=str(key))
    np.testing.assert_allclose(E_t.numpy(), E_j, rtol=0, atol=1e-5 * np.abs(E_j).max())

    # the coarse solve the preconditioner picks for this aggregation factor
    r = _r(E_j.shape[0], 3)
    with _jx_f32():
        if agg_j.fx >= 2:
            y_ref = jx._coarse_inverse_bcr(jnp.asarray(E_j), agg_j.mx, agg_j.my, 2)(jnp.asarray(r))
        else:
            y_ref = jx._coarse_inverse(jnp.asarray(E_j), 2)(jnp.asarray(r))
        y_ref = np.asarray(y_ref)
    E = torch.as_tensor(np.array(E_j))
    if agg_t.fx >= 2:
        y = pt._coarse_inverse_bcr(E, agg_t.mx, agg_t.my, 2)(torch.as_tensor(r))
    else:
        y = pt._coarse_inverse(E, 2)(torch.as_tensor(r))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("macro", MACROS)
def test_weighted_deflation_apply_matches(system, macro):
    S_t, S_j = _both(system)
    w = 1.0 / system[2]
    R = _r(system[1].shape, 4)
    with _jx_f32():
        M_j = jx.stencil_deflation_preconditioner(S_j, macro, newton_schulz=2,
                                                  weight=jnp.asarray(w))
        z_ref = np.asarray(M_j(jnp.asarray(R)))
    M_t = pt.stencil_deflation_preconditioner(S_t, macro, weight=torch.as_tensor(w),
                                              newton_schulz=2)
    z = M_t(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=2e-4 * np.abs(z_ref).max())


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-4), (np.float32, 1e-3)])
def test_pcg_matches(system, dtype, rel):
    """Both PCGs apply the reference's preconditioner, so the comparison is
    of the PCG alone (the two dense float32 coarse inverses, LAPACK's LU and
    XLA's, of the cond ~1e6 coarse operator differ by ~6e-5 themselves).
    The float32 bar is 1e-3: on this 1e6-contrast system the reference's
    own float32 iterates move by 3.3e-4 x max when B is perturbed by 1e-7
    relative, so no float32 PCG that rounds differently can agree closer."""
    planes, B, s, plan = system
    S_t = stencil_from_numpy(planes.astype(dtype), plan, "cpu")
    S_j = jx.StencilBlockEll(jnp.asarray(planes.astype(dtype)), plan)
    B = (B / np.linalg.norm(B.astype(np.float64))).astype(dtype)
    w = (1.0 / s).astype(dtype)
    scope = _jx_f32 if dtype == np.float32 else contextlib.nullcontext
    with scope():
        M_j = jx.stencil_deflation_preconditioner(S_j, (100, 20), newton_schulz=2,
                                                  weight=jnp.asarray(w))
        X_j, it_j = jx.stencil_pcg(S_j, jnp.asarray(B), M_j, rtol=1e-5, maxiter=2000,
                                   unroll=2)
        X_j, it_j = np.asarray(X_j), int(it_j)

    def M_t(R):
        with scope():
            return torch.as_tensor(np.array(M_j(jnp.asarray(R.numpy()))))

    X_t, it_t = pt.stencil_pcg(S_t, torch.as_tensor(B), M_t, rtol=1e-5, maxiter=2000,
                               unroll=2)
    print(f"PCG iterations ({dtype.__name__}): port {it_t}, reference {it_j}")
    assert X_t.dtype == S_t.planes.dtype
    assert it_t % 2 == 0 and abs(it_t - it_j) <= max(4, 0.1 * it_j)
    np.testing.assert_allclose(X_t.numpy(), X_j, rtol=0, atol=rel * np.abs(X_j).max())
