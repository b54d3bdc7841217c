"""Per-shard assembly of the BlockSWIPDG operator values in the PyTorch port
(parallel/sharded_assembly.py) against the host assembly and the JAX
package's, on the reference test's thermalblock 2x2 system (8 x 8 cubes at
2 bisections, [4 2] partition, 8 shards).

Bitwise where only the assembly's split moves: each shard's values equal
the port's host assembly's rows (the same addends per slot through the
same row of the pattern's segment table).  Against the JAX package's
per-device values: 1e-12 relative, the float64 assembly bar of the port's
SWIPDG tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu_torch.discretizations.block_swipdg import (  # noqa: E402
    BlockSWIPDGDiscretization as TB,
)
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.parallel import make_device_mesh  # noqa: E402
from dune_hdd_tpu_torch.parallel.sharded_assembly import sharded_operator_values  # noqa: E402
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def disc():
    return TB(t_grid((0, 0), (1, 1), (8, 8), refinements=2), BI, TTB((2, 2)),
              num_partitions=(4, 2), device="cpu", only_these_products=())


@pytest.fixture(scope="module")
def mesh():
    return make_device_mesh(mu_axis=1, domain_axis=8, devices=CPU8)


@pytest.fixture(scope="module")
def jax_values():
    """The JAX package's per-device values [Q, D, L, K] of the same system."""
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh
    from dune_hdd_tpu.parallel.sharded_assembly import sharded_operator_values as j_values
    from dune_hdd_tpu.problems import ThermalblockProblem

    jd = JB(alu_cube_grid((0, 0), (1, 1), (8, 8), refinements=2), BI,
            ThermalblockProblem((2, 2)), num_partitions=(4, 2), only_these_products=())
    return np.asarray(j_values(jd._global, j_mesh(1, 8), jd.subdomain_row_blocks(8),
                               dtype=jnp.float64))


def test_device_assembly_bitwise_equals_host(disc, mesh, jax_values):
    row_blocks = disc.subdomain_row_blocks(8)
    vals_dev = sharded_operator_values(disc._global, mesh, row_blocks, dtype=torch.float64)
    host = disc.as_sharded(mesh=mesh, dtype=torch.float64).ell_vals[0]
    assert len(vals_dev) == len(host) == 8
    for h, d in zip(host, vals_dev):
        assert torch.equal(h, d)
    dev = torch.stack(vals_dev, dim=1).numpy()  # [Q, D, L, K] as the reference's
    np.testing.assert_allclose(dev, jax_values, rtol=0, atol=1e-12 * np.abs(jax_values).max())


def test_as_sharded_on_device_solves(disc, mesh):
    system = disc.as_sharded(mesh=mesh, dtype=torch.float64, assemble_on_device=True)
    mu = {"diffusion_factor": np.array([0.1, 1.0, 0.5, 2.0])}
    u = system.solve(mu, tol=1e-12, maxiter=5000)
    u_host = disc.as_sharded(mesh=mesh, dtype=torch.float64).solve(mu, tol=1e-12, maxiter=5000)
    assert torch.equal(u, u_host)
    np.testing.assert_allclose(u.numpy(), disc.solve(mu, options={"type": "direct"}).numpy(),
                               atol=1e-8)


def test_device_assembly_parametric_consistency(disc, mesh):
    """The theta contraction of the per-shard components equals the frozen
    host operator at a nontrivial mu."""
    row_blocks = disc.subdomain_row_blocks(8)
    vals_dev = torch.stack(sharded_operator_values(disc._global, mesh, row_blocks,
                                                   dtype=torch.float64), dim=1).numpy()
    op = disc.get_operator().with_expanded_affine_part()
    mu = disc.problem.parse_parameter({"diffusion_factor": np.array([0.3, 0.9, 0.6, 1.4])})
    th = np.asarray([float(c(mu)) for c in op.coefficients])
    frozen = disc.freeze_operator(mu)
    ell_host = frozen.pattern.ell_values(frozen.values).numpy()
    dev = np.einsum("q,qdlk->dlk", th, vals_dev)
    for d, rows in enumerate(row_blocks):
        np.testing.assert_allclose(dev[d, : len(rows)], ell_host[rows], rtol=1e-12, atol=1e-12)
