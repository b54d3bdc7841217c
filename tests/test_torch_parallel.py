"""The row-split sharded layer of the PyTorch port (parallel/sharded.py)
against the JAX package's, on the thermalblock 2x2 SWIPDG system at 2
bisections (384 DoF, the reference test's).

The JAX side runs on conftest's 8 virtual CPU devices, the port on 8 CPU
shards in one process (a mesh's devices may repeat).  Each sharded solve
is held to the direct solve at the reference's 1e-8, and to the JAX
package's sharded solve of the same system at the same 1e-8 (both run CG
to 1e-12; the psum dots sum in another order).
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
    make_device_mesh,
    sharded_parameter_sweep,
)
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MUS = ([1.0, 1.0, 1.0, 1.0], [0.1, 1.0, 0.5, 2.0], [2.0, 0.3, 1.0, 0.7], [0.5, 0.5, 0.5, 0.5])
CPU8 = ["cpu"] * 8


def _mu(v):
    return {"diffusion_factor": np.asarray(v)}


@pytest.fixture(scope="module")
def discs():
    from dune_hdd_tpu.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.problems import ThermalblockProblem

    jd = SWIPDGDiscretization(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2), BI,
                              ThermalblockProblem((2, 2)))
    td = TD(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu")
    return jd, td


def test_mesh_of_repeated_devices_and_default():
    """Eight CPU shards in one process stand where the reference has eight
    virtual devices; with no devices the mesh takes the cards and raises
    without one."""
    mesh = make_device_mesh(mu_axis=2, domain_axis=4, devices=CPU8)
    assert mesh.shape == {"mu": 2, "domain": 4}
    assert len(jax.devices()) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_device_mesh()


def test_sharded_solve_matches_single_device(discs):
    from dune_hdd_tpu.parallel import ShardedAffineSystem as JS
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh

    jd, td = discs
    system = ShardedAffineSystem(td.get_operator(), td.get_rhs(),
                                 make_device_mesh(1, 8, devices=CPU8), dtype=torch.float64)
    mu = _mu(MUS[1])
    u = system.solve(mu, tol=1e-12, maxiter=5000)
    np.testing.assert_allclose(u.numpy(), td.solve(mu, options={"type": "direct"}).numpy(),
                               atol=1e-8)
    jsys = JS(jd.get_operator(), jd.get_rhs(), j_mesh(1, 8), dtype=jnp.float64)
    u_jax = np.asarray(jsys.solve({"diffusion_factor": jnp.asarray(MUS[1])}, tol=1e-12,
                                  maxiter=5000))
    np.testing.assert_allclose(u.numpy(), u_jax, atol=1e-8)


def test_sharded_parameter_sweep(discs):
    """2 x 4 mesh: the mu batch over "mu", each solve over "domain"."""
    from dune_hdd_tpu.parallel import ShardedAffineSystem as JS
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh
    from dune_hdd_tpu.parallel import sharded_parameter_sweep as j_sweep

    jd, td = discs
    system = ShardedAffineSystem(td.get_operator(), td.get_rhs(),
                                 make_device_mesh(2, 4, devices=CPU8), dtype=torch.float64)
    th_op = torch.stack([system.thetas(system.op_coefficients, _mu(v)) for v in MUS])
    th_rhs = torch.stack([system.thetas(system.rhs_coefficients, _mu(v)) for v in MUS])
    out = sharded_parameter_sweep(system, th_op, th_rhs, tol=1e-12, maxiter=5000)
    assert out.shape == (4, system.n_pad)
    jsys = JS(jd.get_operator(), jd.get_rhs(), j_mesh(2, 4), dtype=jnp.float64)
    j_out = np.asarray(j_sweep(jsys, jnp.asarray(th_op.numpy()), jnp.asarray(th_rhs.numpy()),
                               tol=1e-12, maxiter=5000))
    for i, v in enumerate(MUS):
        u_ref = td.solve(_mu(v), options={"type": "direct"}).numpy()
        np.testing.assert_allclose(out[i, : system.num_dofs].numpy(), u_ref, atol=1e-8)
    np.testing.assert_allclose(out.numpy(), j_out, atol=1e-8)


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_device_mesh(mu_axis=3, domain_axis=3, devices=CPU8)


def test_block_swipdg_as_sharded():
    """BlockSWIPDG -> mesh bridge: the [2 2] system on 8 shards (halo
    layout) matches the sequential solve, and the JAX package's."""
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh
    from dune_hdd_tpu.problems import ThermalblockProblem

    d = TB(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)),
           num_partitions=(2, 2), device="cpu", only_these_products=())
    system = d.as_sharded(make_device_mesh(1, 8, devices=CPU8), dtype=torch.float64)
    assert isinstance(system, HaloShardedSystem)
    mu = _mu([0.5, 1.5, 1.0, 0.2])
    u = system.solve(mu, tol=1e-12, maxiter=5000)
    np.testing.assert_allclose(u.numpy(), d.solve(mu, options={"type": "direct"}).numpy(),
                               atol=1e-8)
    jd = JB(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2), BI,
            ThermalblockProblem((2, 2)), num_partitions=(2, 2), only_these_products=())
    u_jax = jd.as_sharded(j_mesh(1, 8), dtype=jnp.float64).solve(
        {"diffusion_factor": jnp.asarray([0.5, 1.5, 1.0, 0.2])}, tol=1e-12, maxiter=5000)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_jax), atol=1e-8)
