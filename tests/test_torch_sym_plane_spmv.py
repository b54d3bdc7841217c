"""The half-storage symmetric plane SpMV of the PyTorch port
(kernels/sym_plane_spmv.py) and the symmetric operator of la/stencil.py.

On the CPU: the plain version equals the JAX package's
``StencilBlockEll(planes, plan, sym=True).matvec`` (its ``_matvec_sym``) on
the SPE10 plan of a 2-bisection order, on random planes at nd = 3 / 6 / 10,
within 1e-6 x max|y| in float32 and 1e-13 x max|y| in float64 (both add in
one order; XLA may contract a multiply and an add into one rounding); it is
the materialized symmetric planes' full SpMV summed in another order; the
schedule covers every (subclass, slot) once in the reference's order;
``symmetrized()`` keeps the one plane array and swaps the SpMV for the
half-storage one of its family (the plain version for the plain version),
and ``with_planes``, ``astype`` and ``scale_planes`` keep it; ``stencil_refined_solve``
with the symmetric operator reaches a true 1e-6 like the JAX package's at 2
and 4 bisections, its float64 residual the half-storage operator's.  The
``cuda`` test holds the kernel bitwise to its plain version at every nd and
dtype on the card (it needs no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_sym_plane_spmv.py``).
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference  # noqa: E402
from dune_hdd_tpu_torch.kernels.sym_plane_spmv import (  # noqa: E402
    sym_forward_edges,
    sym_geometry,
    sym_plane_bytes,
    sym_plane_spmv,
    sym_plane_spmv_reference,
    sym_schedule,
)
from dune_hdd_tpu_torch.la.stencil import stencil_plan, symmetric_planes  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
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
def plan_lattice():
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=BISECTIONS)
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    return stencil_plan(order), order.lattice


@pytest.fixture(scope="module")
def jx():
    """The JAX package's stencil module (skips where JAX is absent)."""
    pytest.importorskip("jax")
    from dune_hdd_tpu.la import stencil

    return stencil


def _f32_scope(dtype):
    if dtype != np.float32:
        return contextlib.nullcontext()
    import jax

    return jax.enable_x64(False)


def _random(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(actual, desired, rel):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


RELS = {np.float32: 1e-6, np.float64: 1e-13}


@pytest.mark.parametrize("nd", [3, 6, 10])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_jax_matvec_sym(jx, plan_lattice, nd, dtype):
    import jax.numpy as jnp

    plan, (KY, KX) = plan_lattice
    W = _random((4, nd, nd, 8, KY, KX), nd, dtype)
    X = _random((nd, 8, KY, KX), nd + 1, dtype)
    with _f32_scope(dtype):
        y_j = np.asarray(jx.StencilBlockEll(jnp.asarray(W), plan, sym=True).matvec(jnp.asarray(X)))
    y = sym_plane_spmv_reference(torch.as_tensor(W), torch.as_tensor(X), plan)
    assert y.dtype == torch.from_numpy(W).dtype and tuple(y.shape) == X.shape
    _close(y.numpy(), y_j, RELS[dtype])


@pytest.fixture(scope="module")
def bench_system():
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    bench = build_spe10_bench(BISECTIONS, device="cpu")
    return bench.assemble(bench.field)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
def test_equals_full_spmv_on_symmetric_planes(bench_system, dtype, rel):
    """The same operator as the full SpMV of the materialized planes,
    summed in another order."""
    S, B, _ = bench_system
    S = S.astype(dtype)
    X = torch.as_tensor(_random(tuple(B.shape), 6, np.float64)).to(dtype)
    _close(sym_plane_spmv_reference(S.planes, X, S.plan).numpy(),
           plane_spmv_reference(symmetric_planes(S), X, S.plan).numpy(), rel)


def test_schedule_covers_every_slot_once_in_edge_order(plan_lattice):
    plan, (KY, KX) = plan_lattice
    edges = sym_forward_edges(plan)
    assert len(edges) == 12
    order = {edge[0]: n for n, edge in enumerate(edges)}
    for k, terms in enumerate(sym_schedule(plan)):
        assert sorted(slot for _, _, slot in terms) == [0, 1, 2]
        # each term's forward edge, in the reference's order
        keys = [order[(k, s)] if fwd else order[(plan[k][slot][0], s)] for fwd, s, slot in terms]
        assert keys == sorted(keys)
        for fwd, s, slot in terms:
            ks, dy, dx = plan[k][slot]
            if not fwd:  # the reverse of the forward edge (ks, s)
                assert plan[ks][s] == (k, -dy, -dx)
    g = sym_geometry((KY, KX), plan)
    assert (g.KY, g.KX) == (KY, KX)
    for k in range(8):
        for m, (fwd, s, slot) in enumerate(sym_schedule(plan)[k]):
            ks, dy, dx = plan[k][slot]
            assert list(g.terms[k][m]) == [fwd, s, ks, dy % KY, dx % KX]
    # 19.5 plane values per cell at nd 3, plus X and Y
    assert sym_plane_bytes(3, (KY, KX), 4) == (19.5 + 6) * 8 * KY * KX * 4


def test_wrapper_rejects_what_the_kernel_does_not_take(plan_lattice):
    plan, (KY, KX) = plan_lattice
    W = torch.zeros((4, 4, 4, 8, KY, KX))
    with pytest.raises(ValueError):
        sym_plane_spmv(W, torch.zeros((4, 8, KY, KX)), plan)  # nd 4
    W3 = torch.zeros((4, 3, 3, 8, KY, KX))
    with pytest.raises(TypeError):
        sym_plane_spmv(W3, torch.zeros((3, 8, KY, KX), dtype=torch.float64), plan)
    one_way = tuple(tuple(((k + 1) % 8, 0, 1) for _ in range(3)) for k in range(8))
    with pytest.raises(ValueError, match="no reverse edge"):
        sym_plane_spmv(W3, torch.zeros((3, 8, KY, KX)), one_way)
    with pytest.raises(ValueError):
        sym_geometry((70000, 4), plan)


def test_cpu_routes_to_plain_version_uncounted(plan_lattice):
    plan, (KY, KX) = plan_lattice
    W = torch.as_tensor(_random((4, 6, 6, 8, KY, KX), 7, np.float64))
    X = torch.as_tensor(_random((6, 8, KY, KX), 8, np.float64))
    with recording() as rec:
        y = sym_plane_spmv(W, X, plan)
    assert rec.total("kernel.sym_plane_spmv") == 0
    assert torch.equal(y, sym_plane_spmv_reference(W, X, plan))


def test_symmetrized_keeps_one_plane_array(bench_system):
    S, B, _ = bench_system
    Ssym = S.symmetrized()
    assert Ssym.spmv is sym_plane_spmv and S.spmv is plane_spmv
    assert Ssym.sym and not S.sym and Ssym.planes is S.planes
    tensors = [v for v in vars(Ssym).values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == 1 and tensors[0] is S.planes
    X = torch.as_tensor(_random(tuple(B.shape), 9, np.float32))
    assert torch.equal(Ssym.matvec(X), sym_plane_spmv_reference(S.planes, X, S.plan))


def test_with_planes_astype_and_scale_planes_keep_sym(bench_system):
    from dune_hdd_tpu_torch.la.stencil_assembly import scale_planes

    S, B, _ = bench_system
    Ssym = S.symmetrized()
    assert Ssym.with_planes(S.planes * 2).spmv is sym_plane_spmv
    S64 = Ssym.astype(torch.float64)
    assert S64.spmv is sym_plane_spmv and S64.sym
    assert S64.planes.dtype == torch.float64 and S64.plan == S.plan
    assert torch.equal(S64.planes, S.planes.double())
    scaled, _, _ = scale_planes(Ssym, B)
    assert scaled.spmv is sym_plane_spmv
    assert S.astype(torch.float64).spmv is plane_spmv and not S.astype(torch.float64).sym


def test_symmetrized_plain_version_stays_plain(plan_lattice, monkeypatch):
    """An operator on the plain SpMV, symmetrized, applies the plain
    half-storage SpMV and never the kernel's wrapper, also after
    ``with_planes`` and ``astype``: a substituted plain version reaches the
    half-storage path (the bench's from 8 bisections)."""
    from dune_hdd_tpu_torch.kernels import sym_plane_spmv as sym
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll

    plan, (KY, KX) = plan_lattice
    calls = {"kernel": 0, "plain": 0}

    def spy(name, f):
        def counted(*args):
            calls[name] += 1
            return f(*args)

        return counted

    plain = spy("plain", sym.sym_plane_spmv_reference)
    monkeypatch.setattr(sym, "sym_plane_spmv", spy("kernel", sym.sym_plane_spmv))
    monkeypatch.setattr(sym, "sym_plane_spmv_reference", plain)
    W = torch.as_tensor(_random((4, 3, 3, 8, KY, KX), 10, np.float32))
    X = torch.as_tensor(_random((3, 8, KY, KX), 11, np.float32))
    S = StencilBlockEll(W, plan, spmv=plane_spmv_reference).symmetrized()
    for op in (S, S.with_planes(2 * W), S.astype(torch.float64)):
        assert op.spmv is plain and op.sym
        x = X.to(op.planes.dtype)
        assert torch.equal(op.matvec(x), sym_plane_spmv_reference(op.planes, x, plan))
    assert calls == {"kernel": 0, "plain": 3}


@pytest.mark.parametrize("bisections,u_bar", [(2, 1e-4), (4, 5e-4)])
def test_refined_solve_symmetric_matches_jax(jx, bisections, u_bar):
    """Both packages' refined solves with the symmetric operator and the
    two-level weighted deflation (macro (100, 20)) on the port's scaled
    bench system: a true 1e-6 each, iterations within max(6, 15%), the
    solutions within the bars of ``test_torch_bench_harness``; the port's
    float64 residual is the half-storage operator's."""
    import jax
    import jax.numpy as jnp

    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.la import stencil as pt

    bench = build_spe10_bench(bisections, device="cpu")
    S, B, s = bench.assemble(bench.field)
    Ssym = S.symmetrized()
    kw = dict(tol=1e-6, inner_iters=150, inner_rtol=1e-1, outer_max=120, unroll=2)
    M = pt.stencil_deflation_preconditioner(Ssym, (100, 20), weight=1.0 / s, newton_schulz=2)
    X, res, iters, _ = pt.stencil_refined_solve(Ssym, B, M, **kw)
    assert res <= 1e-6
    B64 = B.double()
    R = B64 - sym_plane_spmv_reference(S.planes.double(), X, S.plan)
    assert float(R.norm() / B64.norm()) <= 1.01e-6

    S_j = jx.StencilBlockEll(jnp.asarray(S.planes.numpy()), S.plan, sym=True)
    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        M_j = jx.stencil_deflation_preconditioner(S_j, (100, 20), newton_schulz=2,
                                                  weight=jnp.asarray((1.0 / s).numpy()))
    X_j, res_j, iters_j = jx.stencil_refined_solve(S_j, jnp.asarray(B.numpy()), M_j, **kw)
    assert float(res_j) <= 1e-6
    assert abs(iters - int(iters_j)) <= max(6, 0.15 * int(iters_j))
    _close(X.numpy(), np.asarray(X_j), u_bar)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [3, 6, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lattice", [(2, 3), (4, 4), (20, 100), (12, 44)])
def test_kernel_bitwise_equals_plain_on_card(cuda_device, plan_lattice, lattice, dtype, nd):
    plan, _ = plan_lattice
    gen = torch.Generator(device=cuda_device).manual_seed(nd)
    W = torch.randn((4, nd, nd, 8) + lattice, generator=gen, device=cuda_device, dtype=dtype)
    X = torch.randn((nd, 8) + lattice, generator=gen, device=cuda_device, dtype=dtype)
    with recording() as rec:
        y = sym_plane_spmv(W, X, plan)
    assert rec.total("kernel.sym_plane_spmv") == 1
    assert torch.equal(y, sym_plane_spmv_reference(W, X, plan))
