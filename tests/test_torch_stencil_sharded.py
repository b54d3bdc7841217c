"""The x-slab sharded stencil solver of the PyTorch port
(la/stencil_sharded.py) against the JAX package's, on the same SPE10 system
at 2 bisections (the reference test's: 48,000 DoF, lattice 20 x 100).

The JAX side runs on 4 of conftest's 8 virtual CPU devices; the port on 4
CPU shards in one process.  Bitwise where only halos move: the port's
4-slab matvec equals its single-shard ``plane_spmv``.  The psum dots make
the solves agree with the JAX package's at the solve's tolerance: the
solutions within 1e-5 x max, the reference's own bar between two
converged solves of this system (the weighted and unweighted ones; they
were 2.3e-8 apart on the CPU), and each true residual to the reference's
bars.  The reference's HLO check ("collective-permute, no
all-gather" in the matvec) reads the collectives' call counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv  # noqa: E402
from dune_hdd_tpu_torch.la.stencil import StencilBlockEll as TStencil  # noqa: E402
from dune_hdd_tpu_torch.la.stencil_sharded import ShardedStencilSystem as TSharded  # noqa: E402
from dune_hdd_tpu_torch.parallel.sharded import Mesh as TMesh  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

MACRO = (100, 20)


@pytest.fixture(scope="module")
def system():
    """The reference test's fixture, built by the JAX package."""
    from dune_hdd_tpu.bench_harness import _FORCES, _field_tensor_function
    from dune_hdd_tpu.functions.base import (
        ConstantFunction, IndicatorFunction, ScaledFunction, SumFunction)
    from dune_hdd_tpu.functions.spe10 import _synthetic_model1_field
    from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info
    from dune_hdd_tpu.grid.structured import alu_cube_grid
    from dune_hdd_tpu.grid.structured_order import structured_cell_order
    from dune_hdd_tpu.la.block_ell import build_block_ell, symmetric_diagonal_scaling
    from dune_hdd_tpu.la.stencil import StencilBlockEll, soa_index_maps
    from dune_hdd_tpu.ops.assembly import elliptic_cell_matrices, force_cell_vectors
    from dune_hdd_tpu.ops.spaces import dg_space
    from dune_hdd_tpu.ops.swipdg import swipdg_face_blocks
    from dune_hdd_tpu.testcases._spe10_channel import CHANNEL

    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=2)
    bi = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    space = dg_space(grid)
    interior = np.nonzero(grid.interior_faces)[0]
    dirichlet = np.nonzero(bi.dirichlet_faces)[0]
    dfac = SumFunction(
        [ConstantFunction(1.0), ScaledFunction(IndicatorFunction(CHANNEL), -0.9)])
    tensor = _field_tensor_function(jnp.asarray(_synthetic_model1_field()))
    vol = elliptic_cell_matrices(space, dfac, tensor)
    ib, bb = swipdg_face_blocks(space, dfac, tensor, interior, dirichlet)
    A = build_block_ell(space, vol, ib, bb, interior, dirichlet)
    b = force_cell_vectors(space, IndicatorFunction(_FORCES)).reshape(-1)
    A_s, b_s, s = symmetric_diagonal_scaling(A, b)
    A32 = A_s.with_blocks(A_s.blocks.astype(jnp.float32))
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    S = StencilBlockEll.from_block_ell(A32, order)
    maps = soa_index_maps(order, 3)
    KY, KX = order.lattice
    B = b_s.astype(jnp.float32)[jnp.asarray(maps.to_soa)].reshape(3, 8, KY, KX)
    w = (1.0 / s.astype(jnp.float32))[jnp.asarray(maps.to_soa)].reshape(3, 8, KY, KX)
    return dict(S=S, B=B, w=w, A_s=A_s, b_s=b_s, maps=maps,
                planes=np.array(S.planes), B_np=np.array(B), w_np=np.array(w))


@pytest.fixture(scope="module")
def jmesh():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:4]), axis_names=("domain",))


@pytest.fixture(scope="module")
def tmesh():
    return TMesh([torch.device("cpu")] * 4, ("domain",))


@pytest.fixture(scope="module")
def port(system):
    """The same planes and rhs in the port."""
    S = TStencil(torch.as_tensor(system["planes"]), system["S"].plan)
    return S, torch.as_tensor(system["B_np"]), torch.as_tensor(system["w_np"])


def _true_residual(system, X):
    """The reference test's independent check, on the unsharded float64
    image of the stored float32 system."""
    A_s, b_s, maps = system["A_s"], system["b_s"], system["maps"]
    x = np.asarray(X).reshape(-1)[maps.from_soa]
    A64 = A_s.with_blocks(A_s.blocks.astype(jnp.float32).astype(jnp.float64))
    b64 = np.asarray(np.asarray(b_s, np.float32), dtype=np.float64)
    r = b64 - np.asarray(A64.matvec(jnp.asarray(x)))
    return np.linalg.norm(r) / np.linalg.norm(b64)


def _jax_solve(system, jmesh, weighted):
    from dune_hdd_tpu.la.stencil_sharded import ShardedStencilSystem

    sys4 = ShardedStencilSystem(system["S"], system["B"], jmesh, macro=MACRO,
                                weight=system["w"] if weighted else None)
    X, res = sys4.solve(tol=1e-6)
    return np.asarray(X), float(res)


def test_sharded_matvec_matches_single_device(system, jmesh, tmesh, port):
    """Bitwise the port's single-shard plane_spmv; the JAX package's
    sharded matvec within the reference's 3e-6 x max."""
    from jax.sharding import PartitionSpec as P

    from dune_hdd_tpu.la.stencil_sharded import ShardedStencilSystem

    S, B, _ = port
    rng = np.random.default_rng(0)
    X = rng.standard_normal(B.shape).astype(np.float32)
    sys4 = TSharded(S, B, tmesh)
    Xs = torch.as_tensor(X)
    y = torch.cat(sys4._matvec_local(sys4.planes, sys4._split(Xs)), dim=-1)
    assert torch.equal(y, plane_spmv(S.planes, Xs, S.plan))

    jsys = ShardedStencilSystem(system["S"], system["B"], jmesh)
    y_jax = np.asarray(jax.jit(jax.shard_map(
        jsys._matvec_local, mesh=jmesh,
        in_specs=(P(None, None, None, None, None, "domain"), P(None, None, None, "domain")),
        out_specs=P(None, None, None, "domain")))(jsys.planes, jnp.asarray(X)))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=0, atol=3e-6 * np.abs(y_jax).max())


def test_sharded_solve_true_residual(system, jmesh, tmesh, port):
    S, B, _ = port
    X, res = TSharded(S, B, tmesh, macro=MACRO).solve(tol=1e-6)
    assert float(res) <= 1e-6
    assert _true_residual(system, X.numpy()) <= 2e-6
    X_jax, res_jax = _jax_solve(system, jmesh, weighted=False)
    assert res_jax <= 1e-6
    np.testing.assert_allclose(X.numpy(), X_jax, rtol=0, atol=1e-5 * np.abs(X_jax).max())


def test_sharded_matvec_exchanges_by_ppermute(tmesh, port):
    """The per-iteration halo exchange is a ppermute ring; the matvec
    gathers nothing (the reference reads it from the HLO)."""
    S, B, _ = port
    sys4 = TSharded(S, B, tmesh, macro=MACRO)
    with recording() as rec:
        sys4._matvec_local(sys4.planes, sys4.B)
    assert rec.total("collective.ppermute") == 2
    assert rec.total("collective.all_gather") == 0
    X, _ = sys4.solve(tol=1e-2, inner_iters=5, outer_max=1)
    assert X.shape == B.shape and bool(torch.isfinite(X).all())


def test_sharded_weighted_deflation_solve(system, jmesh, tmesh, port):
    """The weighted deflation space: the same solution as the unweighted
    run (the reference's 1e-5 x max), and the JAX package's weighted solve
    at the solve's tolerance."""
    S, B, w = port
    Xw, res_w = TSharded(S, B, tmesh, macro=MACRO, weight=w).solve(tol=1e-6)
    assert float(res_w) <= 1e-6
    Xu, res_u = TSharded(S, B, tmesh, macro=MACRO).solve(tol=1e-6)
    np.testing.assert_allclose(Xw.numpy(), Xu.numpy(), rtol=0,
                               atol=1e-5 * Xu.abs().max().item())
    X_jax, res_jax = _jax_solve(system, jmesh, weighted=True)
    assert res_jax <= 1e-6
    np.testing.assert_allclose(Xw.numpy(), X_jax, rtol=0, atol=1e-5 * np.abs(X_jax).max())
