"""The whole slice: the PyTorch port's SPE10 SWIPDG bench against the JAX
package's ``build_spe10_bench(preconditioner="stencil2", tol=1e-6)`` on the
CPU, at 2 bisections (dense-LU coarse solve) and 4 bisections (the BCR
coarse solve of the 768k-DoF bench), and the three-level path of the
3.07M/12.29M-DoF bench cut to 4 bisections (exact level (25, 5), middle
level (100, 20)).  Both reach a true 1e-6 relative residual, the total
inner PCG iterations lie within max(6, 15%) of each other, and the
solutions agree (see ``test_slice_matches_reference`` for the bars).  The
bench's size-dependent choices (middle levels, solver settings) equal the
reference's up to 12 bisections.

The other branches at 2 bisections against the reference's function with
its BENCH_SMOOTHER / BENCH_PC2 switches (``test_branch_matches_reference``):
``deflation`` and ``stencil`` (float32 block-ELL assembly), ``stencil2`` with
``smoother="cheb2"`` and with ``pc2="mg"`` to a true 1e-6, rechecked in
float64 with the plain gather SpMV; ``mg`` (float64 assembly, as the
reference's promotes under x64) with block CG to its recurrence residual
1e-5.  The solutions agree within 1e-4 x max, under the floor of 1.7e-4 by
which the converged solution moves when the field moves by 1e-6.  Where
the reference falls back to another route (a macro that does not tile the
lattice), the port raises ValueError."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu import bench_harness as jx_bench  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import (  # noqa: E402
    _select_mid_level,
    _solver_settings,
    build_spe10_bench,
    run_spe10_bench,
)
from dune_hdd_tpu_torch.convert import block_ell_from_numpy, stencil_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv_reference  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs), for the module's fixtures
    too."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield


def _reference_solve(bisections, macro=(100, 20), mid=None):
    """The reference's stencil2 path called step by step with the bench's
    settings (up to 6 bisections) and the preconditioner's exact level
    ``macro`` and middle level ``mid``, because its bench function returns
    only (u, residual): the scaled system (planes, plan, B, s), the
    solution, its residual and the total inner iterations."""
    from dune_hdd_tpu.functions.base import (
        ConstantFunction, IndicatorFunction, ScaledFunction, SumFunction)
    from dune_hdd_tpu.functions.spe10 import _synthetic_model1_field
    from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info
    from dune_hdd_tpu.grid.structured import alu_cube_grid
    from dune_hdd_tpu.grid.structured_order import structured_cell_order
    from dune_hdd_tpu.la import stencil, stencil_assembly as sa
    from dune_hdd_tpu.testcases._spe10_channel import CHANNEL

    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=bisections)
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    splan = sa.build_structured_assembly(
        grid, order, make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}))
    dfac = SumFunction([ConstantFunction(1.0), ScaledFunction(IndicatorFunction(CHANNEL), -0.9)])
    pre = sa.precompute_coefficient(splan, dfac)
    _, from_soa = sa.geometric_soa_maps(order, splan)
    KY, KX = order.lattice
    field = _synthetic_model1_field().astype(np.float32)
    cf = np.broadcast_to(field.T[:, None, :, None],
                         (20, KY // 20, 100, KX // 100)).reshape(KY, KX)
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        S0 = sa.assemble_structured_spe10(
            splan, pre, jnp.broadcast_to(jnp.asarray(cf)[None], (8, KY, KX)))
        B0 = sa.structured_rhs(splan, IndicatorFunction(jx_bench._FORCES))
        S, B, s = sa.scale_planes(S0, B0)
        M = stencil.stencil_deflation_preconditioner(S, macro, newton_schulz=2,
                                                     mid_shape=mid, mid_cheb=2,
                                                     weight=1.0 / s)
    X, res, iters = stencil.stencil_refined_solve(S, B, M, tol=1e-6, inner_iters=150,
                                                  inner_rtol=1e-1, outer_max=120, unroll=2)
    u = np.asarray((X * s.astype(X.dtype)).reshape(-1))[np.asarray(from_soa)]
    return {"u": u, "residual": float(res), "iterations": int(iters),
            "planes": np.asarray(S.planes), "plan": S.plan,
            "B": np.asarray(B), "s": np.asarray(s)}


@pytest.mark.parametrize("bisections,u_bar", [(2, 1e-4), (4, 5e-4)])
def test_slice_matches_reference(bisections, u_bar):
    """Solution bars: each side assembles its own float32 operator, and on
    this 1e6-contrast system float32 assembly rounding moves the solution in
    max norm by ~1e-4 (2 bisections) to ~2e-4 (4 bisections) — the
    reference's own solution moves by 1.7e-4 and 2.2e-4 when its field is
    scaled by 1 + 1e-6 — so at 4 bisections the whole-slice bar is 5e-4.
    The port's solver on the reference's own scaled system is held to 1e-4
    at both sizes."""
    fn_j, field_j, n_j = jx_bench.build_spe10_bench(bisections=bisections, tol=1e-6,
                                                    preconditioner="stencil2")
    u_j, res_j = fn_j(field_j)
    u_j, res_j = np.asarray(u_j), float(res_j)
    ref = _reference_solve(bisections)
    assert ref["residual"] <= 1e-6  # the step-by-step call is the reference bench's path

    r = run_spe10_bench(bisections=bisections, repeats=1, device="cpu")
    print(f"bisections {bisections}: inner iterations port {r['inner_iterations']} "
          f"({r['outer_sweeps']} sweeps), reference {ref['iterations']}; residual "
          f"port {r['residual']:.3e}, reference {res_j:.3e}")
    assert r["num_dofs"] == n_j == r["u"].numel()
    assert res_j <= 1e-6 and r["residual"] <= 1e-6
    assert abs(r["inner_iterations"] - ref["iterations"]) <= max(6, 0.15 * ref["iterations"])

    # the residual the port reports is the true one: recompute it in float64
    # from the port's own assembly with the plain SpMV
    bench = r["bench"]
    S, B, s = bench.assemble(r["field"])
    X = r["u"][bench.to_soa].reshape(B.shape) / s.double()
    R = B.double() - plane_spmv_reference(S.planes.double(), X, S.plan)
    assert float(R.norm() / B.double().norm()) <= 1.01e-6

    # whole slice, each side on its own operator (same field)
    sol = bench.fn(bench.field)
    np.testing.assert_allclose(sol.u.numpy(), u_j, rtol=0, atol=u_bar * np.abs(u_j).max())
    # the port's preconditioner and refined solve on the reference's system
    S_j = stencil_from_numpy(ref["planes"], ref["plan"], "cpu")
    sol = bench.solve(S_j, torch.as_tensor(ref["B"]), torch.as_tensor(ref["s"]))
    assert sol.residual <= 1e-6
    np.testing.assert_allclose(sol.u.numpy(), ref["u"], rtol=0,
                               atol=1e-4 * np.abs(ref["u"]).max())


def test_three_level_slice_matches_reference():
    """The three-level path at 4 bisections against the reference's step by
    step, at the bars of ``test_slice_matches_reference`` at this size."""
    ref = _reference_solve(4, macro=(25, 5), mid=(100, 20))
    assert ref["residual"] <= 1e-6
    bench = build_spe10_bench(4, macro=(25, 5), device="cpu")
    assert bench.mid_shape == (100, 20)
    sol = bench.fn(bench.field)
    print(f"three-level: inner iterations port {sol.iterations} ({sol.sweeps} sweeps), "
          f"reference {ref['iterations']}; residual port {sol.residual:.3e}, "
          f"reference {ref['residual']:.3e}")
    assert sol.residual <= 1e-6
    assert abs(sol.iterations - ref["iterations"]) <= max(6, 0.15 * ref["iterations"])
    np.testing.assert_allclose(sol.u.numpy(), ref["u"], rtol=0,
                               atol=5e-4 * np.abs(ref["u"]).max())
    # the port's preconditioner and refined solve on the reference's system
    S_j = stencil_from_numpy(ref["planes"], ref["plan"], "cpu")
    sol = bench.solve(S_j, torch.as_tensor(ref["B"]), torch.as_tensor(ref["s"]))
    assert sol.residual <= 1e-6
    np.testing.assert_allclose(sol.u.numpy(), ref["u"], rtol=0,
                               atol=1e-4 * np.abs(ref["u"]).max())


def test_stencil_from_numpy_round_trips_reference_planes():
    ref = _reference_solve(2)
    S = stencil_from_numpy(ref["planes"], ref["plan"], "cpu")
    assert S.plan == ref["plan"] and S.planes.dtype == torch.float32
    np.testing.assert_array_equal(S.planes.numpy(), ref["planes"])
    X = np.random.default_rng(0).standard_normal(ref["B"].shape).astype(np.float32)
    from dune_hdd_tpu.la.stencil import StencilBlockEll

    y_j = np.asarray(StencilBlockEll(jnp.asarray(ref["planes"]), ref["plan"])
                     .matvec(jnp.asarray(X)))
    y = S.matvec(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


def test_mid_level_selection_matches_reference():
    for KY, KX in [(20, 100), (40, 200), (80, 400), (160, 800), (320, 1600), (640, 3200)]:
        assert _select_mid_level(KY, KX, (100, 20)) == \
            jx_bench._select_mid_level(KY, KX, (100, 20))[0]
    for bisections in range(2, 13, 2):
        KY, KX = 10 << (bisections // 2), 50 << (bisections // 2)
        assert _select_mid_level(KY, KX, (100, 20)) == \
            jx_bench._select_mid_level(KY, KX, (100, 20))[0]
    assert _select_mid_level(80, 400, (100, 20)) is None
    assert _select_mid_level(160, 800, (100, 20)) == (400, 80)
    assert _select_mid_level(320, 1600, (100, 20)) == (400, 80)
    assert _select_mid_level(640, 3200, (100, 20)) == [(1600, 320), (400, 80)]
    assert _select_mid_level(40, 200, (25, 5)) == (100, 20)
    with pytest.raises(ValueError):
        build_spe10_bench(bisections=3, device="cpu")


@pytest.mark.parametrize("bisections", range(2, 13, 2))
def test_solver_settings_match_reference(bisections):
    """The reference bench's size-dependent defaults
    (dune_hdd_tpu/bench_harness.py:130-176, 391-402)."""
    lattice = (10 << (bisections // 2), 50 << (bisections // 2))
    st = _solver_settings(bisections, lattice)
    inner_rtol = {2: 1e-1, 4: 1e-1, 6: 1e-1, 8: 3e-1, 10: 7e-1, 12: 7e-1}[bisections]
    assert st.inner_iters == (300 if bisections >= 8 else 150)
    assert st.inner_rtol == inner_rtol
    assert st.outer_max == (500 if inner_rtol >= 3e-1 else 120)
    assert (st.unroll, st.newton_schulz, st.mid_cheb) == (2, 2, 2)
    assert st.symmetric == (bisections >= 8) == (lattice[0] * lattice[1] >= 128000)


# (branch, the port's switches, the reference's environment)
BRANCHES = [("deflation", {}, {}), ("stencil", {}, {}), ("mg", {}, {}),
            ("stencil2", {"smoother": "cheb2"}, {"BENCH_SMOOTHER": "cheb2"}),
            ("stencil2", {"pc2": "mg"}, {"BENCH_PC2": "mg"})]


@pytest.mark.parametrize("preconditioner,options,env", BRANCHES,
                         ids=["deflation", "stencil", "mg", "stencil2-cheb2", "stencil2-pc2-mg"])
def test_branch_matches_reference(preconditioner, options, env, monkeypatch):
    tol = 1e-5 if preconditioner == "mg" else 1e-6  # mg: the reference function's default
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    fn_j, field_j, n_j = jx_bench.build_spe10_bench(bisections=2, tol=tol,
                                                    preconditioner=preconditioner)
    u_j, res_j = fn_j(field_j)
    u_j = np.asarray(u_j)
    bench = build_spe10_bench(2, tol=tol, device="cpu", preconditioner=preconditioner, **options)
    assert bench.num_dofs == n_j and bench.preconditioner == preconditioner
    A, b, s = bench.assemble(bench.field)
    sol = bench.solve(A, b, s)
    print(f"{preconditioner} {options}: iterations {sol.iterations} ({sol.sweeps} sweeps), "
          f"residual {sol.residual:.3e} (reference {float(res_j):.3e}), u "
          f"{np.abs(sol.u.numpy() - u_j).max() / np.abs(u_j).max():.3e} x max apart")
    assert sol.residual <= tol and float(res_j) <= tol
    if preconditioner == "mg":
        # the reference's mg branch runs in float64: its block_cg residual's dtype
        assert A.blocks.dtype == torch.float64 and np.asarray(res_j).dtype == np.float64
    elif preconditioner != "stencil2":
        assert A.blocks.dtype == torch.float32
        # the reported residual is the true one: float64, plain gather SpMV
        A64 = block_ell_from_numpy(A.neighbors, A.blocks.double().numpy(), "cpu")
        x = sol.u / s.double()
        assert float((b.double() - A64.matvec(x)).norm() / b.double().norm()) <= 1.01e-6
    np.testing.assert_allclose(sol.u.numpy(), u_j, rtol=0, atol=1e-4 * np.abs(u_j).max())


@pytest.mark.parametrize("preconditioner", ["deflation", "stencil", "stencil2"])
def test_fallback_routes_raise(preconditioner):
    """The reference logs a warning and falls back (the gather route, or
    block Jacobi) where the macro does not tile the lattice; the port
    raises, naming the macro.  The gather route stays reachable through
    ``refined_deflated_solve`` with a ``cell_agg`` (test_torch_deflation)."""
    with pytest.raises(ValueError, match=r"macro \(30, 20\)"):
        build_spe10_bench(2, device="cpu", preconditioner=preconditioner, macro=(30, 20))


def test_switches_are_checked():
    for kw in ({"preconditioner": "block_jacobi"}, {"smoother": "cheb2x"},
               {"preconditioner": "deflation", "smoother": "cheb2"},
               {"preconditioner": "stencil", "pc2": "mg"}, {"pc2": "amg"}):
        with pytest.raises(ValueError):
            build_spe10_bench(2, device="cpu", **kw)
