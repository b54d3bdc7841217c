"""The PyTorch port's two-level deflation (la/deflation.py) against the JAX
package's:

* on the reference's own SPE10 fixture at 0 bisections (12,000 DoF, float64,
  x64 on): ``coarse_operator`` 1e-12 x max, one ``deflation_preconditioner``
  apply 5e-6 x max (its coarse inverse is a float32 LU in both, measured
  3.4e-7 x max apart), ``block_cg`` with it (the same iterations within 2,
  x within 1e-10 x max), and the gather route of ``refined_deflated_solve``
  in float32 (both reach a true 1e-6; x within 1e-5 x max);
* ``structured_aggregation`` on the 2-bisection structured order: the
  aggregate map bitwise, and aggsum / broadcast bitwise on integer-valued
  vectors (every sum exact, so any summation order gives the same bits);
* on the deflation bench's float32 structured operator at 2 bisections (the
  reference in its bench scope: x64 off): the balanced and additive
  ``structured_deflation_preconditioner`` applies, 1e-5 x max, and the
  structured route of ``refined_deflated_solve`` as the bench calls it
  (both reach a true 1e-6; x within 1e-5 x max).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.bench_harness import _FORCES, _field_tensor_function  # noqa: E402
from dune_hdd_tpu.functions.base import (  # noqa: E402
    ConstantFunction, IndicatorFunction, ScaledFunction, SumFunction)
from dune_hdd_tpu.functions.spe10 import _synthetic_model1_field  # noqa: E402
from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu.la import block_ell as jbe  # noqa: E402
from dune_hdd_tpu.la import deflation as jx  # noqa: E402
from dune_hdd_tpu.ops.assembly import elliptic_cell_matrices, force_cell_vectors  # noqa: E402
from dune_hdd_tpu.ops.spaces import dg_space  # noqa: E402
from dune_hdd_tpu.ops.swipdg import swipdg_face_blocks  # noqa: E402
from dune_hdd_tpu.testcases._spe10_channel import CHANNEL  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import _bench_geometry, build_spe10_bench  # noqa: E402
from dune_hdd_tpu_torch.convert import block_ell_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.la import block_ell as tbe  # noqa: E402
from dune_hdd_tpu_torch.la import deflation as pt  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@contextlib.contextmanager
def _jx_f32():
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        yield


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


@pytest.fixture(scope="module")
def spe10_system():
    """The reference's tests/test_deflation.py fixture: (neighbors, blocks,
    b, cell_agg) of the scaled float64 system at 0 bisections, as numpy."""
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=0)
    bi = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    space = dg_space(grid)
    interior = np.nonzero(grid.interior_faces)[0]
    dirichlet = np.nonzero(bi.dirichlet_faces)[0]
    dfac = SumFunction([ConstantFunction(1.0), ScaledFunction(IndicatorFunction(CHANNEL), -0.9)])
    tensor = _field_tensor_function(jnp.asarray(_synthetic_model1_field()))
    vol = elliptic_cell_matrices(space, dfac, tensor)
    ib, bb = swipdg_face_blocks(space, dfac, tensor, interior, dirichlet)
    A = jbe.build_block_ell(space, vol, ib, bb, interior, dirichlet)
    b = force_cell_vectors(space, IndicatorFunction(_FORCES)).reshape(-1)
    A_s, b_s, _ = jbe.symmetric_diagonal_scaling(A, b)
    cell_agg = jx.aggregate_map_from_points(grid.cell_centroids, (0, 0), (5, 1), (100, 20))
    np.testing.assert_array_equal(
        pt.aggregate_map_from_points(grid.cell_centroids, (0, 0), (5, 1), (100, 20)), cell_agg)
    return (np.array(A_s.neighbors), np.array(A_s.blocks), np.array(b_s), np.array(cell_agg))


def _both(system, dtype=np.float64):
    neighbors, blocks, b, cell_agg = system
    blocks = blocks.astype(dtype)
    return (block_ell_from_numpy(neighbors, blocks, "cpu"),
            jbe.BlockEllMatrix(neighbors, jnp.asarray(blocks)))


def test_coarse_operator_matches(spe10_system):
    A_t, A_j = _both(spe10_system)
    cell_agg = spe10_system[3]
    E_j = np.asarray(jx.coarse_operator(A_j, cell_agg, 2000))
    E_t = pt.coarse_operator(A_t, cell_agg, 2000)
    assert E_t.dtype == torch.float64
    _close(E_t.numpy(), E_j, 1e-12)


def test_deflation_preconditioner_and_cg_match(spe10_system):
    A_t, A_j = _both(spe10_system)
    _, _, b, cell_agg = spe10_system
    M_j = jx.deflation_preconditioner(A_j, cell_agg, 2000)
    M_t = pt.deflation_preconditioner(A_t, cell_agg, 2000)
    r = np.random.default_rng(4).standard_normal(b.shape)
    y_j = np.asarray(M_j(jnp.asarray(r)))
    y_t = M_t(torch.as_tensor(r)).numpy()
    print(f"deflation apply: {np.abs(y_t - y_j).max() / np.abs(y_j).max():.3e} x max apart")
    _close(y_t, y_j, 5e-6)
    x_t, res_t, iters = tbe.block_cg(A_t, torch.as_tensor(b), tol=1e-8, maxiter=150, M=M_t)
    # the reference's block_cg reports no count: it has not converged 2
    # iterations earlier and has 2 iterations later
    _, res_before = jbe.block_cg(A_j, jnp.asarray(b), tol=1e-8, maxiter=iters - 2, M=M_j)
    x_j, res_j = jbe.block_cg(A_j, jnp.asarray(b), tol=1e-8, maxiter=iters + 2, M=M_j)
    print(f"block_cg with deflation: {iters} iterations, residual {float(res_t):.3e} "
          f"(reference {float(res_j):.3e})")
    assert float(res_t) <= 1e-8 and float(res_j) <= 1e-8 < float(res_before)
    print(f"x: {np.abs(x_t.numpy() - x_j).max() / np.abs(x_j).max():.3e} x max apart")
    _close(x_t.numpy(), np.asarray(x_j), 1e-10)


def test_refined_deflated_solve_gather_route_matches(spe10_system):
    """float32 operator and rhs, the default float64 coarse apply."""
    A_t, A_j = _both(spe10_system, np.float32)
    _, _, b, cell_agg = spe10_system
    b32 = b.astype(np.float32)
    x_j, rel_j = jx.refined_deflated_solve(A_j, jnp.asarray(b32), cell_agg, 2000, tol=1e-6,
                                           inner_iters=40, outer_max=10)
    x_t, rel_t, iters, sweeps = pt.refined_deflated_solve(A_t, torch.as_tensor(b32), cell_agg,
                                                          2000, tol=1e-6, inner_iters=40,
                                                          outer_max=10)
    print(f"gather route: {iters} inner iterations in {sweeps} sweeps, relres {rel_t:.3e} "
          f"(reference {float(rel_j):.3e})")
    assert x_t.dtype == torch.float64
    assert rel_t <= 1e-6 and float(rel_j) <= 1e-6
    # the reported residual is the true one
    A64 = block_ell_from_numpy(spe10_system[0], A_t.blocks.double().numpy(), "cpu")
    b64 = torch.as_tensor(b32).double()
    assert float((b64 - A64.matvec(x_t)).norm() / b64.norm()) == pytest.approx(rel_t, rel=1e-9)
    _close(x_t.numpy(), np.asarray(x_j), 1e-5)


@pytest.fixture(scope="module")
def structured2():
    """The deflation bench's float32 system at 2 bisections in structured
    order: (neighbors, blocks, b, perm, inv, port order, reference order)."""
    bench = build_spe10_bench(2, device="cpu", preconditioner="deflation")
    A, b, _ = bench.assemble(bench.field)
    assert A.blocks.dtype == torch.float32
    order_t = _bench_geometry(2, torch.device("cpu")).order
    order_j = structured_cell_order(alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20),
                                                  refinements=2), (0.0, 0.0), (5.0, 1.0))
    np.testing.assert_array_equal(order_t.perm, order_j.perm)
    st = tbe.StructuredBlockEll.from_block_ell(A, order_t)
    inv_flat = (np.asarray(order_t.inv)[:, None] * 3 + np.arange(3)).reshape(-1)
    return st.neighbors, st.blocks.numpy(), b.numpy()[inv_flat], order_t, order_j


def _structured_both(structured2):
    neighbors, blocks, _, order_t, order_j = structured2
    A_t = tbe.StructuredBlockEll(neighbors, torch.as_tensor(blocks), order_t.offsets)
    A_j = jbe.StructuredBlockEll(neighbors, jnp.asarray(blocks), order_j.offsets)
    return A_t, A_j


def test_structured_aggregation_bitwise(structured2):
    order_t, order_j = structured2[3], structured2[4]
    agg_t = pt.structured_aggregation(order_t, (100, 20))
    agg_j = jx.structured_aggregation(order_j, (100, 20))
    np.testing.assert_array_equal(agg_t[2], agg_j[2])
    rng = np.random.default_rng(5)
    r = rng.integers(-50, 50, order_t.num_cells * 3).astype(np.float32)
    np.testing.assert_array_equal(agg_t[0](torch.as_tensor(r), 3).numpy(),
                                  np.asarray(agg_j[0](jnp.asarray(r), 3)))
    yc = rng.standard_normal(2000).astype(np.float32)
    np.testing.assert_array_equal(agg_t[1](torch.as_tensor(yc), 3).numpy(),
                                  np.asarray(agg_j[1](jnp.asarray(yc), 3)))
    assert pt.structured_aggregation(order_t, (30, 20)) is None
    assert order_t.aggregate_plan((100, 20)) == order_j.aggregate_plan((100, 20)) == (1, 1)
    assert order_t.aggregate_plan((50, 10)) == (2, 2)


@pytest.mark.parametrize("variant", ["balanced", "additive"])
def test_structured_deflation_preconditioner_matches(structured2, variant):
    A_t, A_j = _structured_both(structured2)
    order_t, order_j = structured2[3], structured2[4]
    r = np.random.default_rng(6).standard_normal(order_t.num_cells * 3).astype(np.float32)
    with _jx_f32():
        M_j = jx.structured_deflation_preconditioner(A_j, order_j, (100, 20),
                                                     coarse_dtype=jnp.float32, variant=variant)
        y_j = np.asarray(M_j(jnp.asarray(r)))
    M_t = pt.structured_deflation_preconditioner(A_t, order_t, (100, 20),
                                                 coarse_dtype=torch.float32, variant=variant)
    _close(M_t(torch.as_tensor(r)).numpy(), y_j, 1e-5)
    with pytest.raises(ValueError, match=r"macro \(30, 20\)"):
        pt.structured_deflation_preconditioner(A_t, order_t, (30, 20))


def test_refined_deflated_solve_structured_route_matches(structured2):
    """As the deflation bench calls it: M built in float32, unroll 4."""
    A_t, A_j = _structured_both(structured2)
    b, order_t, order_j = structured2[2], structured2[3], structured2[4]
    with _jx_f32():
        M_j = jx.structured_deflation_preconditioner(A_j, order_j, (100, 20),
                                                     coarse_dtype=jnp.float32)
    x_j, rel_j = jx.refined_deflated_solve(A_j, jnp.asarray(b), None, 2000, tol=1e-6,
                                           inner_iters=150, M=M_j, unroll=4)
    M_t = pt.structured_deflation_preconditioner(A_t, order_t, (100, 20),
                                                 coarse_dtype=torch.float32)
    x_t, rel_t, iters, sweeps = pt.refined_deflated_solve(A_t, torch.as_tensor(b), None, 2000,
                                                          tol=1e-6, inner_iters=150, M=M_t,
                                                          unroll=4)
    print(f"structured route: {iters} inner iterations in {sweeps} sweeps, relres {rel_t:.3e} "
          f"(reference {float(rel_j):.3e})")
    assert iters % 4 == 0
    assert rel_t <= 1e-6 and float(rel_j) <= 1e-6
    _close(x_t.numpy(), np.asarray(x_j), 1e-5)
