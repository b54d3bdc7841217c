"""The PyTorch port's plane-layout aggregation multigrid
(la/stencil_multigrid.py) against the JAX package's, on the stencil
bench's float32 plane operator at 2 bisections (lattice 20 x 100; the
reference in its bench scope: x64 off), each side on the same planes:

* one V-cycle apply with ``coarsest_max=512`` (a band level 10 x 50 below
  the cell lattice, dense LU coarsest) and with the default 4096 (the cell
  lattice solved by dense BCR), 1e-5 x max, and with the Chebyshev smoother
  on top;
* the transfer pair (restriction on integer-valued fields, so its sums are
  exact in any order) and the damped band Jacobi, bitwise;
* the V-cycle is symmetric, <M r, s> = <r, M s> within 1e-5 relative;
* ``stencil_refined_solve`` with it reaches a true 1e-6 on both sides, the
  inner iterations within max(6, 15%), X within 1e-4 x max.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.la import stencil as jxs  # noqa: E402
from dune_hdd_tpu.la import stencil_multigrid as jx  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import build_spe10_bench  # noqa: E402
from dune_hdd_tpu_torch.convert import stencil_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as pts  # noqa: E402
from dune_hdd_tpu_torch.la import stencil_multigrid as pt  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@contextlib.contextmanager
def _jx_f32():
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def system():
    """(planes, plan, B) of the stencil branch's scaled float32 system."""
    bench = build_spe10_bench(2, device="cpu", preconditioner="stencil")
    A, b, s = bench.assemble(bench.field)
    S, _ = bench.precondition(A, s)
    B = b[bench.to_soa].reshape(3, 8, *S.lattice)
    return S.planes.numpy(), S.plan, B.numpy()


def _both(system):
    planes, plan, _ = system
    return stencil_from_numpy(planes, plan, "cpu"), jxs.StencilBlockEll(jnp.asarray(planes), plan)


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


def _r(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("coarsest_max,cheb", [(512, False), (4096, False), (512, True)])
def test_apply_matches(system, coarsest_max, cheb):
    S_t, S_j = _both(system)
    R = _r(system[2].shape, 2)
    with _jx_f32():
        sm = jxs.chebyshev_smoother(S_j, degree=2) if cheb else None
        y_j = np.asarray(jx.stencil_multigrid_preconditioner(
            S_j, coarsest_max=coarsest_max, smoother=sm)(jnp.asarray(R)))
    sm = pts.chebyshev_smoother(S_t, degree=2) if cheb else None
    M_t = pt.stencil_multigrid_preconditioner(S_t, coarsest_max=coarsest_max, smoother=sm)
    y_t = M_t(torch.as_tensor(R)).numpy()
    print(f"coarsest_max {coarsest_max} cheb {cheb}: "
          f"{np.abs(y_t - y_j).max() / np.abs(y_j).max():.3e} x max apart")
    _close(y_t, y_j, 1e-5)


def test_transfers_and_band_jacobi_bitwise():
    x = np.random.default_rng(3).integers(-50, 50, (20, 100)).astype(np.float32)
    np.testing.assert_array_equal(pt._restrict2(torch.as_tensor(x)).numpy(),
                                  np.asarray(jx._restrict2(jnp.asarray(x))))
    xc = _r((10, 50), 4)
    np.testing.assert_array_equal(pt._prolong2(torch.as_tensor(xc)).numpy(),
                                  np.asarray(jx._prolong2(jnp.asarray(xc))))
    d = _r((10, 50), 5)
    d[3, 4] = 0.0  # a zero diagonal entry maps to zero
    bands_t, bands_j = {(0, 0): torch.as_tensor(d)}, {(0, 0): jnp.asarray(d)}
    np.testing.assert_array_equal(
        pt._damped_jacobi_bands(bands_t, 0.7)(torch.as_tensor(xc)).numpy(),
        np.asarray(jx._damped_jacobi_bands(bands_j, 0.7)(jnp.asarray(xc))))


def test_vcycle_is_symmetric(system):
    S_t, _ = _both(system)
    M = pt.stencil_multigrid_preconditioner(S_t, coarsest_max=512)
    r = torch.as_tensor(_r(system[2].shape, 6)).double()
    s = torch.as_tensor(_r(system[2].shape, 7)).double()
    lhs = float(torch.dot(M(r.float()).double().reshape(-1), s.reshape(-1)))
    rhs = float(torch.dot(r.reshape(-1), M(s.float()).double().reshape(-1)))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs)), (lhs, rhs)


def test_refined_solve_with_it_matches(system):
    S_t, S_j = _both(system)
    B = system[2]
    with _jx_f32():
        M_j = jx.stencil_multigrid_preconditioner(S_j)
    X_j, res_j, it_j = jxs.stencil_refined_solve(S_j, jnp.asarray(B), M_j, tol=1e-6,
                                                 inner_iters=300)
    X_t, res_t, it_t, sweeps = pts.stencil_refined_solve(
        S_t, torch.as_tensor(B), pt.stencil_multigrid_preconditioner(S_t), tol=1e-6,
        inner_iters=300)
    print(f"refined solve: {it_t} inner iterations in {sweeps} sweeps, residual {res_t:.3e} "
          f"(reference {int(it_j)}, {float(res_j):.3e})")
    assert res_t <= 1e-6 and float(res_j) <= 1e-6
    assert abs(it_t - int(it_j)) <= max(6, 0.15 * int(it_j))
    _close(X_t.numpy(), X_j, 1e-4)
