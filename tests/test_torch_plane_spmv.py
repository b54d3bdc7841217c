"""The plane SpMV of the PyTorch port (kernels/plane_spmv.py).

On the CPU: the plain version equals the JAX package's
StencilBlockEll.matvec on the assembled SPE10 operator (1e-12 x max in
float64, 1e-5 x max in float32) and, on a random operator whose wrapped
blocks are zero, also the Pallas TPU kernel run in interpret mode; the
wrapper validates its inputs and routes CPU tensors to the plain version
without counting a launch.  The ``cuda`` test holds the CUDA kernel to the
plain version on the card (it needs no JAX: run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_plane_spmv.py``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.grid.boundaryinfo import make_boundary_info  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import (  # noqa: E402
    plane_spmv,
    plane_spmv_reference,
)
from dune_hdd_tpu_torch.la.stencil_assembly import build_structured_assembly  # noqa: E402

BISECTIONS = 2


@pytest.fixture(autouse=True, scope="module")
def _reference_defaults():
    """The reference's defaults (no BENCH_* knobs) for the module's fixtures
    too, and one torch thread: the suite runs one worker process per core,
    and torch's intra-op pool on top of that oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(key)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's stencil modules (skips where JAX is absent)."""
    pytest.importorskip("jax")
    from dune_hdd_tpu.la import stencil, stencil_assembly

    return stencil, stencil_assembly


@pytest.fixture(scope="module")
def setup():
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=BISECTIONS)
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    splan = build_structured_assembly(
        grid, order, make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}))
    return order, splan


def _assembled_planes(dtype):
    """The bench's unscaled operator at BISECTIONS, built by the port."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    bench = build_spe10_bench(BISECTIONS)
    S, _, _ = bench.assemble(bench.field)
    return S.planes.to(dtype), S.plan


def _random_planes(plan, lattice, seed, dtype):
    """Random planes with every block whose neighbour read wraps around a
    lattice axis set to zero (as in every assembled operator)."""
    KY, KX = lattice
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((4, 3, 3, 8, KY, KX))
    iy, ix = np.arange(KY)[:, None], np.arange(KX)[None, :]
    for k in range(8):
        for s in range(3):
            _, dy, dx = plan[k][s]
            wraps = (iy + dy < 0) | (iy + dy >= KY) | (ix + dx < 0) | (ix + dx >= KX)
            W[s + 1, :, :, k][:, :, wraps] = 0.0
    return torch.as_tensor(W, dtype=dtype)


def _x(lattice, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((3, 8) + tuple(lattice)), dtype=dtype)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_plain_matches_jax_matvec_on_assembled_operator(jx, setup, dtype, rel):
    stencil, _ = jx
    W, plan = _assembled_planes(dtype)
    X = _x(W.shape[-2:], 0, dtype)
    y_ref = np.asarray(stencil.StencilBlockEll(W.numpy(), plan).matvec(X.numpy()))
    y = plane_spmv_reference(W, X, plan).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rel * np.abs(y_ref).max())


def test_plain_matches_jax_and_pallas_on_random_operator(jx, setup):
    """Zeroed wrapped blocks make the per-axis wrap (StencilBlockEll, the
    port) and the flat wrap of the Pallas kernel agree.  The Pallas kernel
    wraps modulo the cell count padded to a multiple of 1024, so the lattice
    here (the bench's stencil plan on 16 x 64) has 8192 cells: on a lattice
    with padding, reads across the subclass-7 -> 0 boundary land in the
    padding."""
    stencil, _ = jx
    from dune_hdd_tpu.la.block_ell import StructuredBlockEll
    from dune_hdd_tpu.la.pallas_spmv import build_structured_pallas_matvec

    _, splan = setup
    plan, (KY, KX) = splan.plan, (16, 64)
    W = _random_planes(plan, (KY, KX), 1, torch.float32)
    X = _x((KY, KX), 2, torch.float32)
    y = plane_spmv_reference(W, X, plan).numpy()
    y_ref = np.asarray(stencil.StencilBlockEll(W.numpy(), plan).matvec(X.numpy()))
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * np.abs(y_ref).max())

    L = KY * KX
    nc = 8 * L
    offsets = [[(ks - k) * L + dy * KX + dx for ks, dy, dx in plan[k]] for k in range(8)]
    blocks = np.moveaxis(W.numpy(), (0, 1, 2), (3, 4, 5)).reshape(nc, 4, 3, 3)
    A_st = StructuredBlockEll(np.zeros((nc, 4), np.int32), blocks, offsets)
    mv, bplanes = build_structured_pallas_matvec(A_st, interpret=True)
    x_flat = X.numpy().reshape(3, nc).T.reshape(-1)
    y_pallas = np.asarray(mv(bplanes, x_flat)).reshape(nc, 3).T.reshape(y.shape)
    np.testing.assert_allclose(y, y_pallas, rtol=0, atol=1e-5 * np.abs(y_pallas).max())


def test_wrapper_rejects_bad_inputs(setup):
    _, splan = setup
    W = _random_planes(splan.plan, splan.lattice, 3, torch.float32)
    X = _x(splan.lattice, 4, torch.float32)
    with pytest.raises(ValueError):
        plane_spmv(W[:3], X, splan.plan)          # wrong plane count
    with pytest.raises(ValueError):
        plane_spmv(W, X[:, :, :-1], splan.plan)    # lattice mismatch
    with pytest.raises(TypeError):
        plane_spmv(W, X.double(), splan.plan)      # mixed dtypes
    with pytest.raises(TypeError):
        plane_spmv(W.half(), X.half(), splan.plan)  # unsupported dtype
    with pytest.raises(ValueError):
        plane_spmv(W, X.transpose(2, 3).contiguous().transpose(2, 3), splan.plan)


def test_cpu_routes_to_plain_version_uncounted(setup):
    _, splan = setup
    W = _random_planes(splan.plan, splan.lattice, 5, torch.float64)
    X = _x(splan.lattice, 6, torch.float64)
    before = plane_spmv.launches
    y = plane_spmv(W, X, splan.plan)
    assert plane_spmv.launches == before
    assert torch.equal(y, plane_spmv_reference(W, X, splan.plan))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card(cuda_device, setup, dtype, rel):
    _, splan = setup
    for W in (_assembled_planes(dtype)[0],
              _random_planes(splan.plan, splan.lattice, 7, dtype)):
        W = W.to(cuda_device)
        X = _x(splan.lattice, 8, dtype).to(cuda_device)
        before = plane_spmv.launches
        y = plane_spmv(W, X, splan.plan)
        torch.cuda.synchronize()
        assert plane_spmv.launches == before + 1
        y_ref = plane_spmv_reference(W, X, splan.plan)
        err = (y - y_ref).abs().max().item()
        assert err <= rel * y_ref.abs().max().item(), err
