"""Stage pipelining in the PyTorch port (parallel/pipeline.py): the GPipe
schedule of assemble -> solve -> estimate over a "stage" axis of 3-5 CPU
shards in one process, on the reference test's thermalblock 2x2 system (384
DoF, 5 parameters).

The pipeline equals the same stage functions run in sequence (the
reference's 1e-12), and the sequence equals the JAX package's (1e-10: both
run 400 fixed-trip float64 CG steps; the estimators, the reference's
ESV2007 kernels, at 1e-10 relative).  The affine stacks are split over the
assembly stages.  The reference's HLO check (the payload moves by
collective-permute) reads the collectives' call counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.parallel.pipeline import (  # noqa: E402
    EstimatorStage,
    _ell_stacks,
    make_stage_mesh,
    pipeline_parameter_stages,
    sequential_parameter_stages,
)
from dune_hdd_tpu_torch.parallel.sharded import Mesh  # noqa: E402
from dune_hdd_tpu_torch.problems import ThermalblockProblem as TTB  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
MUS = ([1.0, 1.0, 1.0, 1.0], [0.1, 1.0, 0.5, 2.0],
       [2.0, 0.3, 1.0, 0.7], [0.5, 0.5, 0.5, 0.5], [1.5, 0.2, 0.8, 1.1])
CPU = ["cpu"] * 5


@pytest.fixture(scope="module")
def setup():
    d = TD(t_grid((0, 0), (1, 1), (4, 4), refinements=2), BI, TTB((2, 2)), device="cpu")
    op, rhs = d.get_operator(), d.get_rhs()
    mus = [d.problem.parse_parameter({"diffusion_factor": np.asarray(v)}) for v in MUS]
    th_op = torch.stack([op.with_expanded_affine_part().thetas(m) for m in mus])
    th_rhs = torch.stack([rhs.with_expanded_affine_part().thetas(m) for m in mus])
    return d, op, rhs, th_op, th_rhs


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's discretization of the same system."""
    from dune_hdd_tpu.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.problems import ThermalblockProblem

    return SWIPDGDiscretization(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2), BI,
                                ThermalblockProblem((2, 2)))


@pytest.mark.parametrize("num_stages", [3, 5])
def test_pipeline_matches_sequential(setup, jax_side, num_stages):
    from dune_hdd_tpu.parallel.pipeline import sequential_parameter_stages as j_seq

    d, op, rhs, th_op, th_rhs = setup
    mesh = make_stage_mesh(CPU, num_stages=num_stages)
    u_pp, est_pp = pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=mesh, cg_iters=400,
                                             dtype=torch.float64)
    u_seq, est_seq = sequential_parameter_stages(op, rhs, th_op, th_rhs, cg_iters=400,
                                                 dtype=torch.float64)
    np.testing.assert_allclose(u_pp.numpy(), u_seq.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(est_pp.numpy(), est_seq.numpy(), rtol=0, atol=1e-12)
    u_jax, est_jax = j_seq(jax_side.get_operator(), jax_side.get_rhs(),
                           jnp.asarray(th_op.numpy()), jnp.asarray(th_rhs.numpy()),
                           cg_iters=400, dtype=jnp.float64)
    np.testing.assert_allclose(u_seq.numpy(), np.asarray(u_jax), rtol=0, atol=1e-10)
    np.testing.assert_allclose(est_seq.numpy(), np.asarray(est_jax), rtol=1e-10, atol=1e-12)


def test_pipeline_estimate_stage_equals_host_frontend(setup, jax_side):
    """The ESV2007 estimators (Oswald eta_NC, RT0 eta_DF, eta_R_*) run in
    the estimate stage at each item's mu and equal the public front-end
    ``SWIPDGEstimators.estimate`` (the sequential baseline's), and the JAX
    package's."""
    from dune_hdd_tpu.parallel.pipeline import EstimatorStage as JEst
    from dune_hdd_tpu.parallel.pipeline import sequential_parameter_stages as j_seq

    d, op, rhs, th_op, th_rhs = setup
    est = EstimatorStage(d.space, d.boundary_info, d.problem,
                         [{"diffusion_factor": np.asarray(v)} for v in MUS])
    mesh = make_stage_mesh(CPU, num_stages=4)
    u_pp, est_pp = pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=mesh, cg_iters=800,
                                             dtype=torch.float64, estimator=est)
    u_seq, est_seq = sequential_parameter_stages(op, rhs, th_op, th_rhs, cg_iters=800,
                                                 dtype=torch.float64, estimator=est)
    assert est_pp.shape == (len(MUS), 2 + len(est.types))
    np.testing.assert_allclose(est_pp.numpy(), est_seq.numpy(), rtol=0, atol=1e-12)
    # the estimator columns are real (nonzero) for the parametric items
    assert bool((est_pp[1:, 2] > 0).all())
    jest = JEst(jax_side.space, jax_side.boundary_info, jax_side.problem,
                [{"diffusion_factor": jnp.asarray(v)} for v in MUS])
    _, est_jax = j_seq(jax_side.get_operator(), jax_side.get_rhs(), jnp.asarray(th_op.numpy()),
                       jnp.asarray(th_rhs.numpy()), cg_iters=800, dtype=jnp.float64,
                       estimator=jest)
    np.testing.assert_allclose(est_seq.numpy(), np.asarray(est_jax), rtol=1e-10, atol=1e-12)


def test_pipeline_weight_shards_live_on_assembly_stages(setup):
    """With S stages and A = S - 2 assembly stages, each stage holds a
    ceil(Q / A)-component part of the affine stacks, the solve and estimate
    stages only zeros, and the assembly stages together the full stack."""
    d, op, rhs, th_op, th_rhs = setup
    S = 5
    Q, A = th_op.shape[1], S - 2
    out = pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=make_stage_mesh(CPU, S),
                                    cg_iters=50, dtype=torch.float64, _return_stacks=True)
    vals_parts, _ = out[-1]
    Qc = -(-Q // A)
    assert len(vals_parts) == S
    for s_idx, part in enumerate(vals_parts):
        assert part.shape[0] == Qc  # per-stage footprint Q / A, not Q
        if s_idx >= A:
            assert not bool(part.any())
    ell_vals, _, _, _, _ = _ell_stacks(op, rhs, torch.float64)
    assert torch.equal(torch.cat(vals_parts[:A])[:Q], ell_vals)


def test_pipeline_solutions_are_solutions(setup):
    """The piped solves converge: tiny relative residuals from the estimate
    stage, and the direct solver's solutions."""
    d, op, rhs, th_op, th_rhs = setup
    u_pp, est_pp = pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=make_stage_mesh(CPU),
                                             cg_iters=2000, dtype=torch.float64)
    assert bool((est_pp[:, 0] < 1e-8).all())  # relative residuals
    assert bool((est_pp[:, 1] > 0).all())  # energy norms
    for i, v in enumerate(MUS):
        u_ref = d.solve({"diffusion_factor": np.asarray(v)}, options={"type": "direct"})
        np.testing.assert_allclose(u_pp[i].numpy(), u_ref.numpy(), atol=1e-7)


def test_pipeline_hands_payloads_by_ppermute(setup):
    """The stage-to-stage transfer is a ppermute (point to point), and a
    psum replicates the last stage's results."""
    d, op, rhs, th_op, th_rhs = setup
    with recording() as rec:
        pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=make_stage_mesh(CPU),
                                  cg_iters=10, dtype=torch.float64)
    B, S = th_op.shape[0], 3
    assert rec.total("collective.ppermute") == 3 * (B + S - 1)
    assert rec.total("collective.psum") == 2
    assert rec.total("collective.all_gather") == 0


def test_pipeline_rejects_bad_mesh(setup):
    d, op, rhs, th_op, th_rhs = setup
    with pytest.raises(ValueError):
        make_stage_mesh(CPU, num_stages=2)
    bad = Mesh(np.asarray([torch.device("cpu")] * 2, dtype=object), ("stage",))
    with pytest.raises(ValueError):
        pipeline_parameter_stages(op, rhs, th_op, th_rhs, mesh=bad)
