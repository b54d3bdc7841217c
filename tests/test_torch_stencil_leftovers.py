"""The remaining pieces of the PyTorch port's la/stencil.py against the JAX
package's, on the bench's scaled SPE10 operators (float32):

* ``from_block_ell`` / ``from_structured`` planes, bitwise (2 bisections);
* ``estimate_lambda_max`` rel 1e-4 and ``chebyshev_smoother`` 1e-4 x max
  (2 bisections, the reference in its bench scope: x64 off);
* ``_coarse_E`` (scatter-add) bitwise against the reference's, and against
  ``_coarse_E_banded`` 1e-5 x max (each sums in its own order; both lie
  within 4.5e-6 x max of the float64 E);
* the factored BCR on the 4-bisection lattice with macro (100, 20)
  (fx = 2, mx = 100 padded to 128): ``_bands_to_blocktridiag`` 1e-6 x max,
  ``_factored_bcr_solve_from_blocks`` and ``_coarse_inverse_bcr_factored``
  with the residual in float32 (no refinement; the reference with x64 off)
  and in float64 (one defect correction; x64 on), each against the
  reference on the same blocks and against a float64 dense solve of E;
* one apply of the two-level preconditioner at 6 bisections with macro
  (200, 40), 8,000 aggregates: the branch above 4096 (bands -> block
  tridiagonal -> factored BCR, never dense) against the reference's apply.
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.grid.structured import alu_cube_grid as jx_grid  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order as jx_order  # noqa: E402
from dune_hdd_tpu.la import stencil as jx  # noqa: E402
from dune_hdd_tpu.la.block_ell import BlockEllMatrix as JxBlockEll  # noqa: E402
from dune_hdd_tpu.la.block_ell import StructuredBlockEll as JxStructured  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import _bench_geometry, build_spe10_bench  # noqa: E402
from dune_hdd_tpu_torch.convert import block_ell_from_numpy, stencil_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402
from dune_hdd_tpu_torch.la.block_ell import StructuredBlockEll  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@contextlib.contextmanager
def _jx_scope(x64):
    with jax.enable_x64(x64), jax.default_matmul_precision("highest"):
        yield


def _scaled(bisections):
    """(planes, B, s, plan) of the stencil2 bench's scaled system, numpy."""
    bench = build_spe10_bench(bisections, device="cpu")
    S, B, s = bench.assemble(bench.field)
    return S.planes.numpy(), B.numpy(), s.numpy(), S.plan


@pytest.fixture(scope="module")
def system2():
    return _scaled(2)


@pytest.fixture(scope="module")
def system4():
    return _scaled(4)


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


def _pairing(S, weight, stack):
    wnbr = S.neighbor_fields(weight)
    return stack([(weight[:, None] * S.planes[s] * wnbr[s][None, :]).sum((0, 1))
                  for s in range(4)])


def test_from_block_ell_and_from_structured_planes_bitwise():
    """The stencil branch's float32 block-ELL operator at 2 bisections into
    planes, both routes, against the reference on the same blocks."""
    bench = build_spe10_bench(2, device="cpu", preconditioner="stencil")
    A, _, _ = bench.assemble(bench.field)
    neighbors, blocks = np.asarray(A.neighbors), A.blocks.numpy()
    order_t = _bench_geometry(2, torch.device("cpu")).order
    order_j = jx_order(jx_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=2),
                       (0.0, 0.0), (5.0, 1.0))
    A_j = JxBlockEll(neighbors, jnp.asarray(blocks))
    S_j = jx.StencilBlockEll.from_block_ell(A_j, order_j)
    S_t = pt.StencilBlockEll.from_block_ell(block_ell_from_numpy(neighbors, blocks, "cpu"),
                                            order_t)
    assert S_t.plan == S_j.plan
    np.testing.assert_array_equal(S_t.planes.numpy(), np.asarray(S_j.planes))
    st_j = JxStructured.from_block_ell(A_j, order_j)
    st_t = StructuredBlockEll.from_block_ell(block_ell_from_numpy(neighbors, blocks, "cpu"),
                                             order_t)
    np.testing.assert_array_equal(st_t.neighbors, np.asarray(st_j.neighbors))
    S2_t = pt.StencilBlockEll.from_structured(st_t, order_t)
    np.testing.assert_array_equal(
        S2_t.planes.numpy(), np.asarray(jx.StencilBlockEll.from_structured(st_j, order_j).planes))
    assert S2_t.planes.data_ptr() == st_t.planes.data_ptr()  # a view, no copy


def test_lambda_max_and_chebyshev_smoother_match(system2):
    planes, B, _, plan = system2
    S_t = stencil_from_numpy(planes, plan, "cpu")
    S_j = jx.StencilBlockEll(jnp.asarray(planes), plan)
    R = np.random.default_rng(3).standard_normal(B.shape).astype(np.float32)
    with _jx_scope(False):
        lam_j = float(jx.estimate_lambda_max(S_j, jx.jacobi_smoother(S_j)))
        y_j = {deg: np.asarray(jx.chebyshev_smoother(S_j, degree=deg)(jnp.asarray(R)))
               for deg in (2, 3)}
    lam_t = pt.estimate_lambda_max(S_t, pt.jacobi_smoother(S_t))
    assert lam_t.dtype == torch.float32
    assert float(lam_t) == pytest.approx(lam_j, rel=1e-4)
    for deg, y in y_j.items():
        _close(pt.chebyshev_smoother(S_t, degree=deg)(torch.as_tensor(R)).numpy(), y, 1e-4)
    # an lmax given: the same polynomial without the estimate
    _close(pt.chebyshev_smoother(S_t, degree=2, lmax=torch.tensor(lam_j, dtype=torch.float32))(
        torch.as_tensor(R)).numpy(), y_j[2], 1e-4)


def test_coarse_E_scatter_matches(system2):
    planes, _, s, plan = system2
    S_t = stencil_from_numpy(planes, plan, "cpu")
    S_j = jx.StencilBlockEll(jnp.asarray(planes), plan)
    for macro in ((100, 20), (50, 10)):
        with _jx_scope(False):
            agg_j = jx._aggregation(S_j, macro)
            Pw = _pairing(S_j, jnp.asarray(1.0 / s), jnp.stack)
            E_j = np.asarray(jx._coarse_E(S_j, agg_j, Pw))
            E0_j = np.asarray(jx._coarse_E(S_j, agg_j))
        agg_t = pt._aggregation(S_t, macro)
        Pw_t = torch.as_tensor(np.array(Pw))
        E_t = pt._coarse_E(S_t, agg_t, Pw_t)
        np.testing.assert_array_equal(E_t.numpy(), E_j)
        np.testing.assert_array_equal(pt._coarse_E(S_t, agg_t).numpy(), E0_j)
        _close(E_t.numpy(), pt._coarse_E_banded(S_t, agg_t, Pw_t).numpy(), 1e-5)


@pytest.fixture(scope="module")
def bands4(system4):
    """The weighted coarse bands of the 4-bisection system on the (100, 20)
    macro lattice (fx = fy = 2), the reference's, as numpy."""
    planes, _, s, plan = system4
    S_j = jx.StencilBlockEll(jnp.asarray(planes), plan)
    with _jx_scope(False):
        agg = jx._aggregation(S_j, (100, 20))
        assert (agg.fx, agg.fy) == (2, 2)
        bands = jx._coarse_bands(S_j, agg, _pairing(S_j, jnp.asarray(1.0 / s), jnp.stack))
    return {k: np.array(v) for k, v in bands.items()}


def _tridiag_dense(B, C):
    """The float64 dense x-major symmetric block-tridiagonal operator of
    (B, C): block i couples to i + 1 by C_i and to i - 1 by C_{i-1}^T."""
    mx, my = B.shape[:2]
    E = np.zeros((mx * my, mx * my))
    for i in range(mx):
        E[i * my:(i + 1) * my, i * my:(i + 1) * my] = B[i]
        if i + 1 < mx:
            E[i * my:(i + 1) * my, (i + 1) * my:(i + 2) * my] = C[i]
            E[(i + 1) * my:(i + 2) * my, i * my:(i + 1) * my] = C[i].T
    return E


def test_bands_to_blocktridiag_matches(bands4, system4):
    planes, _, s, plan = system4
    S_t = stencil_from_numpy(planes, plan, "cpu")
    agg_t = pt._aggregation(S_t, (100, 20))
    Pw = _pairing(S_t, torch.as_tensor(1.0 / s), torch.stack)
    bands_t = pt._coarse_bands(S_t, agg_t, Pw)
    assert list(bands_t) == list(bands4)
    for key, vec in bands4.items():
        _close(bands_t[key].numpy(), vec, 1e-6)
    with _jx_scope(False):
        B_j, C_j = jx._bands_to_blocktridiag({k: jnp.asarray(v) for k, v in bands4.items()},
                                             100, 20)
    B_t, C_t = pt._bands_to_blocktridiag({k: torch.as_tensor(v) for k, v in bands4.items()},
                                         100, 20)
    np.testing.assert_array_equal(B_t.numpy(), np.asarray(B_j))
    np.testing.assert_array_equal(C_t.numpy(), np.asarray(C_j))
    with pytest.raises(ValueError, match="block-tridiagonal"):
        pt._bands_to_blocktridiag({(0, 2): bands_t[(0, 0)]}, 100, 20)


# (residual dtype of the port, x64 of the reference's scope, bar against the
# reference, bar of the relative residual in float64)
REFINE = [(torch.float32, False, 2e-5, 3e-6), (torch.float64, True, 2e-6, 1e-6)]


@pytest.mark.parametrize("residual_dtype,x64,bar,res_bar", REFINE)
def test_factored_bcr_solves_match(bands4, residual_dtype, x64, bar, res_bar):
    """Both factored solves on the same inputs as the reference (padding
    mx = 100 to 128), and their relative residual in float64 on the system
    they solve: the diagonally scaled symmetric block tridiagonal in float32
    (from the blocks, and from the dense E, which is that operator)."""
    rc = np.random.default_rng(7).standard_normal(2000).astype(np.float32)
    with _jx_scope(x64):
        B_j, C_j = jx._bands_to_blocktridiag({k: jnp.asarray(v) for k, v in bands4.items()},
                                             100, 20)
        B, C = np.array(B_j), np.array(C_j)
        E32 = _tridiag_dense(B, C).astype(np.float32)
        y_j = np.asarray(jx._factored_bcr_solve_from_blocks(B_j, C_j, 100, 20)(jnp.asarray(rc)))
        z_j = np.asarray(jx._coarse_inverse_bcr_factored(jnp.asarray(E32), 100, 20)(
            jnp.asarray(rc)))
    y_t = pt._factored_bcr_solve_from_blocks(torch.as_tensor(B), torch.as_tensor(C), 100, 20,
                                             residual_dtype=residual_dtype)(torch.as_tensor(rc))
    z_t = pt._coarse_inverse_bcr_factored(torch.as_tensor(E32), 100, 20,
                                          residual_dtype=residual_dtype)(torch.as_tensor(rc))
    assert y_t.dtype == z_t.dtype == torch.float32
    # the scaled systems in float32, as each function forms them
    d = np.sqrt(np.maximum(np.abs(np.einsum("nii->ni", B)), np.float32(1e-30)))
    d_next = np.concatenate([d[1:], np.ones_like(d[:1])])
    Es_blocks = _tridiag_dense(B / (d[:, :, None] * d[:, None, :]),
                               C / (d[:, :, None] * d_next[:, None, :]))
    df = d.reshape(-1)
    Es_dense = ((E32 / df[:, None]) / df[None, :]).astype(np.float64)
    for got, ref, Es in ((y_t.numpy(), y_j, Es_blocks), (z_t.numpy(), z_j, Es_dense)):
        rs = (rc / df).astype(np.float64)

        def rel_res(x):
            return np.linalg.norm(rs - Es @ (x * df).astype(np.float64)) / np.linalg.norm(rs)

        print(f"{residual_dtype}: scaled rel residual port {rel_res(got):.3e}, reference "
              f"{rel_res(ref):.3e}, max diff {np.abs(got - ref).max() / np.abs(ref).max():.3e}")
        _close(got, ref, bar)
        assert rel_res(got) <= res_bar


def test_two_level_above_4096_aggregates_matches():
    """One apply of the stencil2 bench's preconditioner at 6 bisections with
    macro (200, 40): two-level (fx = 2), 8,000 aggregates, so the factored
    BCR from the coarse bands with its float64 defect correction; against
    the reference's apply on the same planes, built with x64 off and applied
    with x64 on, as its bench does (measured 4.8e-5 x max apart; the
    float32 setting is held above at 4 bisections)."""
    bench = build_spe10_bench(6, device="cpu", macro=(200, 40))
    assert bench.mid_shape is None
    S, B, s = bench.assemble(bench.field)
    _, M = bench.precondition(S, s)
    R = np.random.default_rng(9).standard_normal(tuple(B.shape)).astype(np.float32)
    S_j = jx.StencilBlockEll(jnp.asarray(S.planes.numpy()), S.plan)
    with _jx_scope(False):
        M_j = jx.stencil_deflation_preconditioner(S_j, (200, 40), newton_schulz=2,
                                                  weight=jnp.asarray((1.0 / s).numpy()))
    with _jx_scope(True):  # the factored solve reads x64 when it is applied
        y_j = np.asarray(M_j(jnp.asarray(R)))
    _close(M(torch.as_tensor(R)).numpy(), y_j, 1e-4)
