"""Direct-to-planes assembly of the PyTorch port (la/stencil_assembly.py)
equals the JAX package's on the SPE10 system at 2 bisections: planes, rhs
and diagonal scaling at 1e-12 x max in float64 and 1e-5 x max in float32
(the float32 side of the reference runs as the bench runs it: x64 off,
highest matmul precision), the precomputed coefficient and the synthetic
permeability field bitwise; at 6 bisections the float32 rhs bitwise."""
import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.bench_harness import _FORCES as JX_FORCES  # noqa: E402
from dune_hdd_tpu.functions import base as jx_fn  # noqa: E402
from dune_hdd_tpu.functions.spe10 import _synthetic_model1_field as jx_field  # noqa: E402
from dune_hdd_tpu.grid.boundaryinfo import make_boundary_info as jx_binfo  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as jx_grid  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order as jx_order  # noqa: E402
from dune_hdd_tpu.la import stencil_assembly as jx_sa  # noqa: E402
from dune_hdd_tpu.testcases._spe10_channel import CHANNEL as JX_CHANNEL  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import _FORCES  # noqa: E402
from dune_hdd_tpu_torch.convert import assembly_plan_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.functions.base import (  # noqa: E402
    ConstantFunction,
    IndicatorFunction,
    ScaledFunction,
    SumFunction,
)
from dune_hdd_tpu_torch.functions.spe10 import _synthetic_model1_field  # noqa: E402
from dune_hdd_tpu_torch.la.stencil_assembly import (  # noqa: E402
    assemble_structured_spe10,
    assembly_tensors,
    precompute_coefficient,
    scale_planes,
    structured_rhs,
)
from dune_hdd_tpu_torch.testcases._spe10_channel import CHANNEL  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BISECTIONS = 2


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs), for the module's fixtures
    too."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield


@pytest.fixture(scope="module")
def reference():
    grid = jx_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=BISECTIONS)
    order = jx_order(grid, (0.0, 0.0), (5.0, 1.0))
    splan = jx_sa.build_structured_assembly(
        grid, order, jx_binfo(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}))
    KY, KX = order.lattice
    field = jx_field()
    fy, fx = KY // field.shape[1], KX // field.shape[0]
    cf = np.broadcast_to(
        np.broadcast_to(field.T[:, None, :, None],
                        (field.shape[1], fy, field.shape[0], fx)).reshape(KY, KX)[None],
        (8, KY, KX))
    return splan, np.ascontiguousarray(cf)


def _jx_dfac():
    return jx_fn.SumFunction([jx_fn.ConstantFunction(1.0),
                              jx_fn.ScaledFunction(jx_fn.IndicatorFunction(JX_CHANNEL), -0.9)])


def _dfac():
    return SumFunction([ConstantFunction(1.0),
                        ScaledFunction(IndicatorFunction(CHANNEL), -0.9)])


def _jx_scope(stack, dtype):
    """The reference's float32 scope in the bench: x64 off, highest matmuls."""
    if dtype == np.float32:
        stack.enter_context(jax.enable_x64(False))
        stack.enter_context(jax.default_matmul_precision("highest"))


def test_synthetic_field_and_data_bitwise():
    np.testing.assert_array_equal(_synthetic_model1_field(), jx_field())
    assert CHANNEL == JX_CHANNEL and _FORCES == JX_FORCES


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_precomputed_coefficient_bitwise(reference, dtype):
    splan, _ = reference
    pre_j = jx_sa.precompute_coefficient(splan, _jx_dfac(), dtype=dtype)
    pre_t = precompute_coefficient(assembly_plan_from_numpy(splan), _dfac(), dtype=dtype)
    for a, b in zip(pre_t, pre_j, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_planes_rhs_scaling_match(reference, dtype, rel):
    splan, cf = reference
    pre_j = jx_sa.precompute_coefficient(splan, _jx_dfac(), dtype=dtype)
    with contextlib.ExitStack() as stack:
        _jx_scope(stack, dtype)
        S0_j = jx_sa.assemble_structured_spe10(splan, pre_j, jnp.asarray(cf, dtype=dtype),
                                               dtype=dtype)
        B0_j = jx_sa.structured_rhs(splan, jx_fn.IndicatorFunction(JX_FORCES), dtype=dtype)
        S_j, B_j, s_j = jx_sa.scale_planes(S0_j, B0_j)
        ref = [np.asarray(a) for a in (S0_j.planes, B0_j, S_j.planes, B_j, s_j)]

    tdt = torch.float64 if dtype == np.float64 else torch.float32
    plan = assembly_plan_from_numpy(splan)
    T = assembly_tensors(plan, precompute_coefficient(plan, _dfac(), dtype=dtype), "cpu", tdt)
    S0 = assemble_structured_spe10(T, torch.as_tensor(cf, dtype=tdt))
    B0 = structured_rhs(T, IndicatorFunction(_FORCES))
    S, B, s = scale_planes(S0, B0)
    assert S0.plan == tuple(splan.plan)
    for name, got, want in zip(("planes", "rhs", "scaled planes", "scaled rhs", "s"),
                               (S0.planes, B0, S.planes, B, s), ref):
        assert got.dtype == tdt and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max(), err_msg=name)


def test_float32_rhs_bitwise_at_768k():
    """At 6 bisections (768,000 DoF) the float32 rhs equals the reference's
    bitwise, and both lie 4.768e-8 (relative, 2-norm) from the float64 rhs:
    the rel_rhs of the bench's block provenance check on the card, so the
    reference's 1.407e-8 there is the TPU's own float32 rounding."""
    grid = jx_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=6)
    order = jx_order(grid, (0.0, 0.0), (5.0, 1.0))
    splan = jx_sa.build_structured_assembly(
        grid, order, jx_binfo(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}))
    plan = assembly_plan_from_numpy(splan)
    rhs = {}
    for dtype in (np.float64, np.float32):
        with contextlib.ExitStack() as stack:
            _jx_scope(stack, dtype)
            ref = np.asarray(jx_sa.structured_rhs(splan, jx_fn.IndicatorFunction(JX_FORCES),
                                                  dtype=dtype))
        tdt = torch.float64 if dtype == np.float64 else torch.float32

        def t(a, tdt=tdt):
            return torch.as_tensor(np.asarray(a), dtype=tdt)

        # the fields of AssemblyTensors that structured_rhs reads
        T = SimpleNamespace(qp_x=t(plan.vol_qp[..., 0]), qp_y=t(plan.vol_qp[..., 1]),
                            vol_wvals=t(plan.vol_wvals))
        got = structured_rhs(T, IndicatorFunction(_FORCES)).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape == (3, 8, 80, 400)
        rhs[dtype] = (got, ref)
    got32, ref32 = rhs[np.float32]
    np.testing.assert_array_equal(got32, ref32)
    b64 = rhs[np.float64][1]
    np.testing.assert_allclose(rhs[np.float64][0], b64, rtol=0, atol=1e-14 * np.abs(b64).max())
    for b32 in (got32, ref32):
        rel = np.linalg.norm(b32.astype(np.float64) - b64) / np.linalg.norm(b64)
        assert f"{rel:.3e}" == "4.768e-08", rel
