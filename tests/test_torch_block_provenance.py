"""The bench's block provenance check of the PyTorch port, against the JAX
package's block side (x64, CPU), on the synthetic permeability field:

* ``block_provenance_check(bisections=2, device="cpu")`` (48,000 DoF, 80
  subdomains) passes its gate;
* its block side (the 80 local operators and functionals plus the pairwise
  couplings, ``bench_harness.block_system``) applies the reference block
  side's operator to 1e-12, and sums to the global rhs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import bench_harness as jbench  # noqa: E402
from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.problems.default import DefaultProblem as JDefaultProblem  # noqa: E402
from dune_hdd_tpu.testcases._spe10_channel import CHANNEL  # noqa: E402
from dune_hdd_tpu_torch import bench_harness as tbench  # noqa: E402
from dune_hdd_tpu_torch.functions.spe10 import _synthetic_model1_field  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _close(a, b, rel):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


def test_block_provenance_check_at_two_bisections():
    r = tbench.block_provenance_check(bisections=2, device="cpu")
    assert r["artifact"] == "block-swipdg" and r["partitioning"] == [20, 4, 1]
    assert (r["num_subdomains"], r["checked_dofs"], r["bisections"]) == (80, 48000, 2)
    # the float32 bench operator against the float64 block system
    assert 0 < r["rel_op"] <= 1e-6 and 0 < r["rel_rhs"] <= 1e-6


def test_block_side_matches_reference():
    """The port's block side (80 locals + couplings) applies the same
    operator as the reference's, assembled the same way, to 1e-12."""
    grid = t_grid((0, 0), (5, 1), (100, 20), refinements=2)
    field = _synthetic_model1_field()
    bdisc = tbench.spe10_block_discretization(
        grid, torch.as_tensor(field, dtype=torch.float32), device="cpu")
    matvec, rhs = tbench.block_system(bdisc)

    jfield = jnp.asarray(field, dtype=jnp.float32)
    jproblem = JDefaultProblem(
        diffusion_factor=jf.nonparametric(jf.SumFunction(
            [jf.ConstantFunction(1.0),
             jf.ScaledFunction(jf.IndicatorFunction(CHANNEL, name="channel"), -0.9)],
            name="diffusion_factor")),
        diffusion_tensor=jf.nonparametric(jbench._field_tensor_function(jfield)),
        force=jf.nonparametric(jf.IndicatorFunction(jbench._FORCES, name="force")))
    jd = JB(j_grid((0, 0), (5, 1), (100, 20), refinements=2),
            {"type": "stuff.grid.boundaryinfo.alldirichlet"}, jproblem, num_partitions=(20, 4),
            only_these_products=())
    x = np.random.default_rng(0).standard_normal(jd.space.num_dofs)
    y = np.zeros_like(x)
    maps = [np.asarray(jd._local_dof_map(ss)) for ss in range(80)]
    for ss, dofs in enumerate(maps):
        y[dofs] += np.asarray(jd.get_local_operator(ss).freeze({}).matvec(jnp.asarray(x[dofs])))
        for nn in jd.neighbouring_subdomains(ss):
            if nn <= ss:
                continue
            c = jd.get_coupling_operator(ss, int(nn)).freeze({})
            dn = maps[int(nn)]
            xs, xn = jnp.asarray(x[dofs]), jnp.asarray(x[dn])
            y[dofs] += np.asarray(c.in_in.matvec(xs)) + np.asarray(c.in_out.matvec(xn))
            y[dn] += np.asarray(c.out_in.matvec(xs)) + np.asarray(c.out_out.matvec(xn))
    _close(matvec(torch.as_tensor(x)), y, 1e-12)
    _close(rhs, bdisc.freeze_rhs({}), 1e-12)
