"""Subdomain-aligned halo-exchange sharding of the PyTorch port
(parallel/halo.py, BlockSWIPDG.as_sharded / subdomain_row_blocks) against
the JAX package's, on the reference tests' thermalblock 2x2 systems.

The JAX side runs on conftest's 8 virtual CPU devices, the port on 8 (or
2 x 4) CPU shards in one process.  Bitwise where only halos move: with the
same row split the halo CG equals the all-gather CG of parallel/sharded.py
(same recurrence, same slot order, same psum order).  The exchange plans
equal the JAX package's exactly; solves are held to the direct solve and
to the JAX package's at the reference's 1e-8.  The reference's HLO checks
("collective-permute, no all-gather") read the collectives' call counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.discretizations.block_swipdg import (  # noqa: E402
    BlockSWIPDGDiscretization as TB,
)
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.parallel import (  # noqa: E402
    HaloShardedSystem,
    ShardedAffineSystem,
    halo_exchange_spec,
    make_device_mesh,
)
from dune_hdd_tpu_torch.parallel.halo import _halo_cg, halo_parameter_sweep  # noqa: E402
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MU = [0.1, 1.0, 0.5, 2.0]
SWEEP = ([0.1, 1.0, 0.5, 2.0], [1.0, 0.2, 0.9, 0.4], [0.7, 0.7, 0.7, 0.7], [2.0, 0.1, 1.0, 0.3])
CPU8 = ["cpu"] * 8


def _mu(v):
    return {"diffusion_factor": np.asarray(v)}


def _jmu(v):
    return {"diffusion_factor": jnp.asarray(v)}


@pytest.fixture(scope="module")
def discs():
    from dune_hdd_tpu.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.problems import ThermalblockProblem

    jd = SWIPDGDiscretization(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2), BI,
                              ThermalblockProblem((2, 2)))
    td = TD(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu")
    return jd, td


@pytest.fixture(scope="module")
def mesh():
    return make_device_mesh(mu_axis=1, domain_axis=8, devices=CPU8)


@pytest.fixture(scope="module")
def halo_system(discs, mesh):
    _, td = discs
    return HaloShardedSystem(td.get_operator(), td.get_rhs(), mesh, dtype=torch.float64)


@pytest.fixture(scope="module")
def block_discs():
    """The [4 2] partition of the 8 x 8 grid, in both packages."""
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.problems import ThermalblockProblem

    jd = JB(alu_cube_grid((0, 0), (1, 1), (8, 8), refinements=0), BI,
            ThermalblockProblem((2, 2)), num_partitions=(4, 2), only_these_products=())
    td = TB(t_grid((0, 0), (1, 1), (8, 8), refinements=0), BI, TTB((2, 2)),
            num_partitions=(4, 2), device="cpu", only_these_products=())
    return jd, td


def test_halo_matches_all_gather_path_bitwise(discs, mesh, halo_system):
    """Same CG recurrence, same slot order -> bit-identical solutions."""
    _, td = discs
    sys_a = ShardedAffineSystem(td.get_operator(), td.get_rhs(), mesh, dtype=torch.float64)
    u_a = sys_a.solve(_mu(MU), tol=1e-12, maxiter=5000)
    u_h = halo_system.solve(_mu(MU), tol=1e-12, maxiter=5000)
    assert torch.equal(u_a, u_h)


def test_halo_matches_direct_solve(discs, halo_system):
    from dune_hdd_tpu.parallel import HaloShardedSystem as JH
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh

    jd, td = discs
    u_h = halo_system.solve(_mu(MU), tol=1e-12, maxiter=5000).numpy()
    np.testing.assert_allclose(u_h, td.solve(_mu(MU), options={"type": "direct"}).numpy(),
                               atol=1e-8)
    jsys = JH(jd.get_operator(), jd.get_rhs(), j_mesh(1, 8), dtype=jnp.float64)
    np.testing.assert_allclose(u_h, np.asarray(jsys.solve(_jmu(MU), tol=1e-12, maxiter=5000)),
                               atol=1e-8)


def test_comm_volume_is_o_halo_not_o_n(discs, mesh, halo_system):
    """The per-iteration exchange (the sum of the per-shift halo buffers)
    is far below N, and the plan is the JAX package's."""
    from dune_hdd_tpu.parallel import HaloShardedSystem as JH
    from dune_hdd_tpu.parallel import halo_exchange_spec as j_spec
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh

    spec = halo_exchange_spec(halo_system)
    n = halo_system.num_dofs
    assert spec["elements_per_spmv"] < n / 2, spec
    # the all_gather path moves (D-1)/D * N elements per shard per SpMV
    assert spec["elements_per_spmv"] < 7 / 8 * n
    jd, _ = discs
    jsys = JH(jd.get_operator(), jd.get_rhs(), j_mesh(1, 8), dtype=jnp.float64)
    assert spec == j_spec(jsys)
    np.testing.assert_array_equal(halo_system.plan.cols_ext, jsys.plan.cols_ext)
    for a, b in zip(halo_system.plan.send_idx, jsys.plan.send_idx):
        np.testing.assert_array_equal(a, b)


def test_cg_exchanges_by_ppermute_and_gathers_nothing(halo_system):
    """The halo CG's collectives: ppermute rings and psum dots, no
    all_gather (the reference reads this from the compiled HLO)."""
    th_op = halo_system.thetas(halo_system.op_coefficients, _mu(MU))
    th_rhs = halo_system.thetas(halo_system.rhs_coefficients, _mu(MU))
    vals, b = halo_system._frozen(0, th_op, th_rhs)
    with recording() as rec:
        _halo_cg([halo_system._matvec_body(0)], [vals], [halo_system.cols_ext[0]], [b], None,
                 1e-12, 5000)
    assert rec.total("collective.ppermute") > 0
    assert rec.total("collective.all_gather") == 0


def test_block_swipdg_as_sharded_subdomain_aligned(mesh, block_discs):
    """as_sharded rides whole-subdomain row blocks (the JAX package's) and
    reproduces the unsharded block solve."""
    jd, td = block_discs
    system = td.as_sharded(mesh=mesh, dtype=torch.float64)
    assert isinstance(system, HaloShardedSystem)
    blocks = td.subdomain_row_blocks(8)
    assert len(blocks) == 8
    for a, b in zip(blocks, jd.subdomain_row_blocks(8)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(np.concatenate(blocks)), np.arange(td.space.num_dofs))
    u = system.solve(_mu(MU), tol=1e-12, maxiter=5000)
    np.testing.assert_allclose(u.numpy(), td.solve(_mu(MU), options={"type": "direct"}).numpy(),
                               atol=1e-8)


def test_halo_parameter_sweep_mu_x_domain(discs):
    """(2 mu x 4 domain): the parameter batch through the ppermute halo
    path matches per-mu direct solves and the JAX package's sweep."""
    from dune_hdd_tpu.parallel import HaloShardedSystem as JH
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh
    from dune_hdd_tpu.parallel.halo import halo_parameter_sweep as j_sweep

    jd, td = discs
    system = HaloShardedSystem(td.get_operator(), td.get_rhs(),
                               make_device_mesh(2, 4, devices=CPU8), dtype=torch.float64)
    th_op = torch.stack([system.thetas(system.op_coefficients, _mu(v)) for v in SWEEP])
    th_rhs = torch.stack([system.thetas(system.rhs_coefficients, _mu(v)) for v in SWEEP])
    U = halo_parameter_sweep(system, th_op, th_rhs, tol=1e-12, maxiter=5000)
    assert U.shape == (4, td.space.num_dofs)
    for i, v in enumerate(SWEEP):
        np.testing.assert_allclose(U[i].numpy(),
                                   td.solve(_mu(v), options={"type": "direct"}).numpy(),
                                   atol=1e-8)
    jsys = JH(jd.get_operator(), jd.get_rhs(), j_mesh(2, 4), dtype=jnp.float64)
    U_jax = j_sweep(jsys, jnp.asarray(th_op.numpy()), jnp.asarray(th_rhs.numpy()), tol=1e-12,
                    maxiter=5000)
    np.testing.assert_allclose(U.numpy(), np.asarray(U_jax), atol=1e-8)


def test_halo_sweep_syncs_trip_counts_without_gathers(discs):
    """The sweep's CG: ppermute rings, the trip count pmax-synchronised
    over "mu", no all_gather."""
    _, td = discs
    system = HaloShardedSystem(td.get_operator(), td.get_rhs(),
                               make_device_mesh(2, 4, devices=CPU8), dtype=torch.float64)
    frozen = [system._frozen(m, system.thetas(system.op_coefficients, _mu(v)),
                             system.thetas(system.rhs_coefficients, _mu(v)))
              for m, v in enumerate(SWEEP[:2])]
    with recording() as rec:
        xs = _halo_cg([system._matvec_body(m) for m in range(2)], [f[0] for f in frozen],
                      system.cols_ext, [f[1] for f in frozen], None, 1e-12, 5000,
                      sync_axes=("mu",))
    assert rec.total("collective.ppermute") > 0
    assert rec.total("collective.pmax") > 0
    assert rec.total("collective.all_gather") == 0
    for x, v in zip(xs, SWEEP[:2]):
        np.testing.assert_allclose(system._global(x).numpy(),
                                   td.solve(_mu(v), options={"type": "direct"}).numpy(),
                                   atol=1e-8)


def test_subdomain_row_blocks_skewed_sizes():
    """Skewed subdomain DoF sizes must not push split bounds past S-1 (the
    reference's repro: sizes [1]*7 + [1000] with 8 shards); the blocks are
    the JAX package's."""
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB

    sizes = [1] * 7 + [1000]
    offsets = np.concatenate([[0], np.cumsum(sizes)])

    class Stub:
        def num_subdomains(self):
            return len(sizes)

        def _local_dof_map(self, ss):
            return np.arange(offsets[ss], offsets[ss + 1])

    blocks = TB.subdomain_row_blocks(Stub(), 8)
    assert len(blocks) == 8
    assert all(len(b) > 0 for b in blocks)
    np.testing.assert_array_equal(np.sort(np.concatenate(blocks)), np.arange(sum(sizes)))
    for a, b in zip(blocks, JB.subdomain_row_blocks(Stub(), 8)):
        np.testing.assert_array_equal(a, b)


def test_subdomain_row_blocks_whole_subdomains():
    td = TB(t_grid((0, 0), (1, 1), (8, 8), refinements=0), BI, TTB((2, 2)),
            num_partitions=(4, 4), device="cpu", only_these_products=())
    blocks = td.subdomain_row_blocks(8)
    # 16 subdomains over 8 shards: each shard owns whole subdomains
    sub_rows = [set(map(int, td._local_dof_map(ss))) for ss in range(td.num_subdomains())]
    for blk in blocks:
        s = set(map(int, blk))
        covered = [ss for ss in range(16) if sub_rows[ss] <= s]
        assert sum(len(sub_rows[ss]) for ss in covered) == len(s)
