"""The PyTorch port's geometric multigrid (la/multigrid.py) against the JAX
package's, on the reference's Laplace system (4 x 4 cube on [-1, 1]^2,
SWIPDG P1, float64, x64 on), each side on the same operator:

* the DG prolongation of bisected levels 2 -> 4 and 0 -> 2 (two and four
  children per parent): P_cell, prolong and restrict at 1e-14 x max;
* ``galerkin_rap`` blocks at 1e-12 x max and the neighbour table equal;
* the hierarchy over levels (2, 0): its per-level damping omega at rel
  1e-10 and one V-cycle at 1e-10 x max, with the dense coarsest solve and
  with the 30 coarse sweeps;
* block CG with ``mg_preconditioner`` over levels (4, 2, 0): the same
  iterations (the reference's count bracketed to exactly one), x within
  1e-10 x max.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.functions import ConstantFunction, constant_matrix  # noqa: E402
from dune_hdd_tpu.functions.esv2007 import Testcase1Force as _Force  # noqa: E402
from dune_hdd_tpu.grid import alu_cube_grid as jx_grid  # noqa: E402
from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info  # noqa: E402
from dune_hdd_tpu.la import block_ell as jbe  # noqa: E402
from dune_hdd_tpu.la import multigrid as jx  # noqa: E402
from dune_hdd_tpu.ops.assembly import elliptic_cell_matrices, force_cell_vectors  # noqa: E402
from dune_hdd_tpu.ops.spaces import dg_space as jx_dg_space  # noqa: E402
from dune_hdd_tpu.ops.swipdg import swipdg_face_blocks  # noqa: E402
from dune_hdd_tpu_torch.convert import block_ell_from_numpy, prolongation_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as pt_grid  # noqa: E402
from dune_hdd_tpu_torch.la import block_ell as tbe  # noqa: E402
from dune_hdd_tpu_torch.la import multigrid as pt  # noqa: E402
from dune_hdd_tpu_torch.ops.spaces import dg_space as pt_dg_space  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _grids(make, levels):
    return [make((-1, -1), (1, 1), (4, 4), refinements=b) for b in levels]


def _laplace_system(refinements):
    """The reference test's system: (neighbors, blocks, b) as numpy."""
    grid = jx_grid((-1, -1), (1, 1), (4, 4), refinements=refinements)
    bi = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    space = jx_dg_space(grid)
    interior = np.nonzero(grid.interior_faces)[0]
    dirichlet = np.nonzero(bi.dirichlet_faces)[0]
    lam, kap = ConstantFunction(1.0), constant_matrix(1.0)
    vol = elliptic_cell_matrices(space, lam, kap)
    ib, bb = swipdg_face_blocks(space, lam, kap, interior, dirichlet)
    A = jbe.build_block_ell(space, vol, ib, bb, interior, dirichlet)
    b = force_cell_vectors(space, _Force()).reshape(-1)
    return np.array(A.neighbors), np.array(A.blocks), np.array(b)


@pytest.fixture(scope="module")
def system2():
    return _laplace_system(2)


@pytest.fixture(scope="module")
def system4():
    return _laplace_system(4)


def _both(system):
    neighbors, blocks, b = system
    return (block_ell_from_numpy(neighbors, blocks, "cpu"),
            jbe.BlockEllMatrix(neighbors, jnp.asarray(blocks)), b)


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


@pytest.mark.parametrize("levels", [(2, 4), (0, 2)])
def test_prolongation_matches(levels):
    (cj, fj), (ct, ft) = _grids(jx_grid, levels), _grids(pt_grid, levels)
    prol_j = jx.build_dg_prolongation(cj, fj, jx_dg_space(fj))
    prol_t = pt.build_dg_prolongation(ct, ft, pt_dg_space(ft, device="cpu"))
    assert prol_t.children_per_parent == prol_j.children_per_parent == 2 ** (levels[1] - levels[0])
    np.testing.assert_array_equal(prol_t.parent, prol_j.parent)
    _close(prol_t.P_cell.numpy(), prol_j.P_cell, 1e-14)
    rng = np.random.default_rng(1)
    xc = rng.standard_normal(cj.num_cells * 3)
    rf = rng.standard_normal(fj.num_cells * 3)
    _close(prol_t.prolong(torch.as_tensor(xc)).numpy(), prol_j.prolong(jnp.asarray(xc)), 1e-14)
    _close(prol_t.restrict(torch.as_tensor(rf)).numpy(), prol_j.restrict(jnp.asarray(rf)), 1e-14)
    # the converter carries the reference's prolongation as it is
    prol_c = prolongation_from_numpy(np.asarray(prol_j.P_cell), prol_j.parent,
                                     prol_j.children_per_parent, "cpu")
    _close(prol_c.prolong(torch.as_tensor(xc)).numpy(), prol_j.prolong(jnp.asarray(xc)), 1e-15)


def test_galerkin_rap_matches(system2):
    A_t, A_j, _ = _both(system2)
    (cj, fj), (ct, ft) = _grids(jx_grid, (0, 2)), _grids(pt_grid, (0, 2))
    prol_j = jx.build_dg_prolongation(cj, fj, jx_dg_space(fj))
    prol_t = pt.build_dg_prolongation(ct, ft, pt_dg_space(ft, device="cpu"))
    Ac_j = jx.galerkin_rap(A_j, prol_j, jx_dg_space(cj))
    Ac_t = pt.galerkin_rap(A_t, prol_t, pt_dg_space(ct, device="cpu"))
    np.testing.assert_array_equal(Ac_t.neighbors, np.asarray(Ac_j.neighbors))
    _close(Ac_t.blocks.numpy(), Ac_j.blocks, 1e-12)
    _close(pt._block_ell_to_dense(Ac_t).numpy(), jx._block_ell_to_dense(Ac_j), 1e-12)


@pytest.mark.parametrize("dense_limit", [4096, 0])
def test_hierarchy_and_v_cycle_match(system2, dense_limit):
    A_t, A_j, b = _both(system2)
    h_j = jx.MultigridHierarchy(_grids(jx_grid, (2, 0)), A_j, coarse_dense_limit=dense_limit)
    h_t = pt.MultigridHierarchy(_grids(pt_grid, (2, 0)), A_t, coarse_dense_limit=dense_limit)
    assert (h_t.coarse_dense is None) == (h_j.coarse_dense is None) == (dense_limit == 0)
    for w_t, w_j in zip(h_t.omegas, h_j.omegas, strict=True):
        assert float(w_t) == pytest.approx(float(w_j), rel=1e-10)
    _close(h_t.v_cycle(torch.as_tensor(b)).numpy(), h_j.v_cycle(jnp.asarray(b)), 1e-10)


def test_block_cg_with_mg_preconditioner_matches(system4):
    A_t, A_j, b = _both(system4)
    M_j = jx.mg_preconditioner(jx.MultigridHierarchy(_grids(jx_grid, (4, 2, 0)), A_j))
    M_t = pt.mg_preconditioner(pt.MultigridHierarchy(_grids(pt_grid, (4, 2, 0)), A_t))
    x_t, res_t, iters = tbe.block_cg(A_t, torch.as_tensor(b), tol=1e-10, maxiter=25, M=M_t)
    _, res_before = jbe.block_cg(A_j, jnp.asarray(b), tol=1e-10, maxiter=iters - 1, M=M_j)
    x_j, res_j = jbe.block_cg(A_j, jnp.asarray(b), tol=1e-10, maxiter=iters, M=M_j)
    print(f"block_cg with the V-cycle: {iters} iterations, residual {float(res_t):.3e} "
          f"(reference {float(res_j):.3e})")
    assert float(res_t) <= 1e-10 and float(res_j) <= 1e-10 < float(res_before)
    _close(x_t.numpy(), x_j, 1e-10)
