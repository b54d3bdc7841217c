"""Solver pieces of the PyTorch port (la/stencil.py) against the JAX
package's, on the same scaled SPE10 operator at 2 bisections (float32, the
reference in its bench scope: x64 off, highest matmul precision):

* block-Jacobi smoother, rtol 3e-5;
* weighted coarse bands and dense E, 1e-5 x max;
* the BCR (macro 50 x 10, fx = 2) and dense-LU (macro 100 x 20, fx = 1)
  coarse solves, 2e-5 x max;
* the weighted two-level deflation apply, 2e-4 x max;
* PCG: iteration counts within max(4, 10%), X within 1e-4 x max.

On the card (``cuda``; the file imports JAX only in the fixture ``ref``, so
it runs there without it): the PCG loop replayed as CUDA graphs against the
same loop run op by op (reached through an M that syncs, which cannot be
captured), bitwise, with its launch counts, one capture per refined solve,
and the fallback's counts and spans.
"""
import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.bench_harness import build_spe10_bench  # noqa: E402
from dune_hdd_tpu_torch.convert import stencil_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import host_read, recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BISECTIONS = 2
MACROS = [(100, 20), (50, 10)]  # fx = 1 (dense LU) and fx = 2 (BCR) at 2 bisections


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs), for the module's fixtures
    too."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield


@pytest.fixture(scope="module")
def ref():
    """The JAX package's stencil module and ``jax.numpy`` (skips where JAX
    is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dune_hdd_tpu.la import stencil

    return SimpleNamespace(jx=stencil, jnp=jnp)


@contextlib.contextmanager
def _jx_f32():
    import jax

    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def system():
    """(planes, B, s, plan) of the bench's scaled system, as numpy."""
    bench = build_spe10_bench(BISECTIONS, device="cpu")
    S, B, s = bench.assemble(bench.field)
    return S.planes.numpy(), B.numpy(), s.numpy(), S.plan


def _both(system, ref):
    planes, B, s, plan = system
    return (stencil_from_numpy(planes, plan, "cpu"),
            ref.jx.StencilBlockEll(ref.jnp.asarray(planes), plan))


def _r(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_operator_accessors_match(system, ref):
    """neighbor_fields, row_sums, diagonal_blocks and astype: bitwise except
    the row sums (reduction order), which hold at 1e-6 x max."""
    S_t, S_j = _both(system, ref)
    jnp = ref.jnp
    X = _r(system[1].shape, 5)
    for f_t, f_j in zip(S_t.neighbor_fields(torch.as_tensor(X)),
                        S_j.neighbor_fields(jnp.asarray(X)), strict=True):
        np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(S_t.diagonal_blocks().numpy(), np.asarray(S_j.diagonal_blocks()))
    rs_j = np.asarray(S_j.row_sums())
    np.testing.assert_allclose(S_t.row_sums().numpy(), rs_j, rtol=0, atol=1e-6 * np.abs(rs_j).max())
    S64 = S_t.astype(torch.float64)
    assert S64.planes.dtype == torch.float64 and S64.plan == S_t.plan and S64.spmv is S_t.spmv
    np.testing.assert_array_equal(S64.planes.numpy(), np.asarray(S_j.astype(jnp.float64).planes))


def test_jacobi_smoother_matches(system, ref):
    S_t, S_j = _both(system, ref)
    jx, jnp = ref.jx, ref.jnp
    R = _r(system[1].shape, 1)
    with _jx_f32():
        z_ref = np.asarray(jx.jacobi_smoother(S_j)(jnp.asarray(R)))
    z = pt.jacobi_smoother(S_t)(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=3e-5)


def _weighted_pairing(S, weight, stack):
    wnbr = S.neighbor_fields(weight)
    return stack([(weight[:, None] * S.planes[s] * wnbr[s][None, :]).sum((0, 1))
                  for s in range(4)])


@pytest.mark.parametrize("macro", MACROS)
def test_coarse_bands_dense_E_and_solves_match(system, ref, macro):
    S_t, S_j = _both(system, ref)
    jx, jnp = ref.jx, ref.jnp
    w = 1.0 / system[2]
    with _jx_f32():
        agg_j = jx._aggregation(S_j, macro)
        Pw_j = _weighted_pairing(S_j, jnp.asarray(w), jnp.stack)
        bands_j = jx._coarse_bands(S_j, agg_j, Pw_j)
        E_j = np.asarray(jx._coarse_E_banded(S_j, agg_j, Pw_j))
    agg_t = pt._aggregation(S_t, macro)
    Pw_t = _weighted_pairing(S_t, torch.as_tensor(w), torch.stack)
    bands_t = pt._coarse_bands(S_t, agg_t, Pw_t)
    E_t = pt._coarse_E_banded(S_t, agg_t, Pw_t)

    assert sorted(bands_t) == sorted(bands_j)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in bands_j.values())
    for key, vec in bands_j.items():
        np.testing.assert_allclose(bands_t[key].numpy(), np.asarray(vec), rtol=0,
                                   atol=1e-5 * scale, err_msg=str(key))
    np.testing.assert_allclose(E_t.numpy(), E_j, rtol=0, atol=1e-5 * np.abs(E_j).max())

    # the coarse solve the preconditioner picks for this aggregation factor
    r = _r(E_j.shape[0], 3)
    with _jx_f32():
        if agg_j.fx >= 2:
            y_ref = jx._coarse_inverse_bcr(jnp.asarray(E_j), agg_j.mx, agg_j.my, 2)(jnp.asarray(r))
        else:
            y_ref = jx._coarse_inverse(jnp.asarray(E_j), 2)(jnp.asarray(r))
        y_ref = np.asarray(y_ref)
    E = torch.as_tensor(np.array(E_j))
    if agg_t.fx >= 2:
        y = pt._coarse_inverse_bcr(E, agg_t.mx, agg_t.my, 2)(torch.as_tensor(r))
    else:
        y = pt._coarse_inverse(E, 2)(torch.as_tensor(r))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("macro", MACROS)
def test_weighted_deflation_apply_matches(system, ref, macro):
    S_t, S_j = _both(system, ref)
    jx, jnp = ref.jx, ref.jnp
    w = 1.0 / system[2]
    R = _r(system[1].shape, 4)
    with _jx_f32():
        M_j = jx.stencil_deflation_preconditioner(S_j, macro, newton_schulz=2,
                                                  weight=jnp.asarray(w))
        z_ref = np.asarray(M_j(jnp.asarray(R)))
    M_t = pt.stencil_deflation_preconditioner(S_t, macro, weight=torch.as_tensor(w),
                                              newton_schulz=2)
    z = M_t(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=2e-4 * np.abs(z_ref).max())


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-4), (np.float32, 1e-3)])
def test_pcg_matches(system, ref, dtype, rel):
    """Both PCGs apply the reference's preconditioner, so the comparison is
    of the PCG alone (the two dense float32 coarse inverses, LAPACK's LU and
    XLA's, of the cond ~1e6 coarse operator differ by ~6e-5 themselves).
    The float32 bar is 1e-3: on this 1e6-contrast system the reference's
    own float32 iterates move by 3.3e-4 x max when B is perturbed by 1e-7
    relative, so no float32 PCG that rounds differently can agree closer."""
    jx, jnp = ref.jx, ref.jnp
    planes, B, s, plan = system
    S_t = stencil_from_numpy(planes.astype(dtype), plan, "cpu")
    S_j = jx.StencilBlockEll(jnp.asarray(planes.astype(dtype)), plan)
    B = (B / np.linalg.norm(B.astype(np.float64))).astype(dtype)
    w = (1.0 / s).astype(dtype)
    scope = _jx_f32 if dtype == np.float32 else contextlib.nullcontext
    with scope():
        M_j = jx.stencil_deflation_preconditioner(S_j, (100, 20), newton_schulz=2,
                                                  weight=jnp.asarray(w))
        X_j, it_j = jx.stencil_pcg(S_j, jnp.asarray(B), M_j, rtol=1e-5, maxiter=2000,
                                   unroll=2)
        X_j, it_j = np.asarray(X_j), int(it_j)

    def M_t(R):
        with scope():
            return torch.as_tensor(np.array(M_j(jnp.asarray(R.numpy()))))

    X_t, it_t = pt.stencil_pcg(S_t, torch.as_tensor(B), M_t, rtol=1e-5, maxiter=2000,
                               unroll=2)
    print(f"PCG iterations ({dtype.__name__}): port {it_t}, reference {it_j}")
    assert X_t.dtype == S_t.planes.dtype
    assert it_t % 2 == 0 and abs(it_t - it_j) <= max(4, 0.1 * it_j)
    np.testing.assert_allclose(X_t.numpy(), X_j, rtol=0, atol=rel * np.abs(X_j).max())


# -- on the card: the PCG replayed as CUDA graphs ------------------------------

GRAPH_BISECTIONS = 4


@pytest.fixture(scope="module")
def card_systems():
    """{case: (A, B with ||B|| = 1, M, dtype, unroll)} on the card: the
    stencil2 bench's operator (``plane_spmv``) with its deflation M in
    float32, and its symmetric form (``sym_plane_spmv``) in float64 with
    the block-Jacobi M."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = build_spe10_bench(GRAPH_BISECTIONS, device="cuda")
    S, B, s = bench.assemble(bench.field)
    S, M = bench.precondition(S, s)
    S64 = S.symmetrized().astype(torch.float64)
    B64 = B.to(torch.float64)
    return {"deflation_f32": (S, B / torch.linalg.norm(B), M, torch.float32, 2),
            "jacobi_f64": (S64, B64 / torch.linalg.norm(B64), pt.jacobi_smoother(S64),
                           torch.float64, 4)}


def _syncing(M):
    """M with a read of a device value first: it adds a host sync and
    nothing else, and a CUDA graph capture cannot hold it."""

    def apply(R):
        host_read(R.reshape(-1)[0])
        return M(R)

    return apply


def _uncaptured(A, B, M, unroll, rtol=1e-5):
    """The PCG loop run op by op on the card: an M that syncs cannot be
    captured, so the loop runs its bodies directly on its buffers."""
    return pt.stencil_pcg(A, B, _syncing(M), rtol=rtol, maxiter=2000, unroll=unroll)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deflation_f32", "jacobi_f64"])
def test_graphed_pcg_bitwise_equals_eager_on_card(card_systems, case):
    A, B, M, dtype, unroll = card_systems[case]
    X_e, k_e = _uncaptured(A, B, M, unroll)
    with recording() as rec:
        X_g, k_g = pt.stencil_pcg(A, B, M, rtol=1e-5, maxiter=2000, unroll=unroll)
    assert k_g == k_e > 0 and k_g % unroll == 0
    assert X_g.dtype == dtype and torch.equal(X_g, X_e)
    assert rec.total("pcg.graph.captures") == 2 and rec.total("pcg.graph.eager_fallbacks") == 0
    assert rec.total("pcg.graph.replays") == k_g + 1 == rec.total("pcg.iterations") + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deflation_f32", "jacobi_f64"])
def test_graphed_pcg_counts_the_eager_launches_on_card(card_systems, case):
    """The launches counted while capturing count again at each replay, so
    the kernels' counters read as the loop's run op by op."""
    A, B, M, dtype, unroll = card_systems[case]
    with recording() as eager:
        _, k_e = _uncaptured(A, B, M, unroll)
    with recording() as graphed:
        _, k_g = pt.stencil_pcg(A, B, M, rtol=1e-5, maxiter=2000, unroll=unroll)
    kernel = "sym_plane_spmv" if A.sym else "plane_spmv"
    assert k_g == k_e and eager.total("kernel." + kernel) == k_e
    assert graphed.totals_under("kernel.") == eager.totals_under("kernel.")


@pytest.mark.cuda
def test_refined_solve_captures_once_on_card(card_systems):
    """Every sweep of one refined solve replays the graphs of the first."""
    A, B, M, _, _ = card_systems["deflation_f32"]
    with recording() as rec:
        X, res, iters, sweeps = pt.stencil_refined_solve(A, B, M, tol=1e-6, inner_iters=150,
                                                          inner_rtol=1e-3, unroll=2)
    assert sweeps >= 2 and res <= 1e-6 and X.dtype == torch.float64
    assert rec.total("pcg.graph.captures") == 2 and rec.total("pcg.graph.eager_fallbacks") == 0
    assert rec.total("pcg.iterations") == iters
    assert rec.total("pcg.graph.replays") == iters + sweeps
    assert len(rec.seconds("pcg.graph.capture")) == 1


@pytest.mark.cuda
def test_pcg_falls_back_for_a_preconditioner_that_syncs_on_card(card_systems):
    """An M that reads a device value cannot be captured: the loop runs its
    bodies op by op, to the replayed loop's iterates, and counts the case."""
    A, B, M, dtype, unroll = card_systems["jacobi_f64"]
    X_g, k_g = pt.stencil_pcg(A, B, M, rtol=1e-5, maxiter=2000, unroll=unroll)
    with recording() as rec:
        X_f, k_f = _uncaptured(A, B, M, unroll)
    assert k_f == k_g and torch.equal(X_f, X_g)
    assert rec.total("pcg.graph.eager_fallbacks") == 1
    assert rec.total("pcg.graph.captures") == 0 and rec.total("pcg.graph.replays") == 0
    assert len(rec.seconds("precond.apply")) == k_f + 1
    assert len(rec.seconds("matvec")) == k_f
