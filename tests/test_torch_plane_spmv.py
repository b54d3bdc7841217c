"""The plane SpMV of the PyTorch port (kernels/plane_spmv.py).

On the CPU: the plain version equals the JAX package's
StencilBlockEll.matvec on the assembled SPE10 operator (1e-12 x max in
float64, 1e-5 x max in float32) and, on a random operator whose wrapped
blocks are zero, also the Pallas TPU kernel run in interpret mode; the
wrapper validates its inputs and routes CPU tensors to the plain version
without counting a launch, and takes nd in {3, 6, 10} DoF per cell (DG
P1-P3) and no other.  The kernel's launch geometry (``plane_geometry``:
tiles, the X halo taken from the plan, the ring, the grid and the shared
memory) is checked on the CPU for every lattice the driven paths give the
kernel, at every nd and dtype.  The ``cuda`` tests hold the CUDA kernel to
the plain version on the card: at nd = 3 on the assembled and random
operators, and bitwise at every nd and dtype on random planes whose wrapped
blocks are nonzero, on small lattices and on lattices the tile does not
divide (they need no JAX: run them there with
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
    SMEM_PER_BLOCK,
    TILES,
    plane_geometry,
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

    bench = build_spe10_bench(BISECTIONS, device="cpu")
    S, _, _ = bench.assemble(bench.field)
    return S.planes.to(dtype), S.plan


def _random_planes(plan, lattice, seed, dtype, nd=3):
    """Random planes with every block whose neighbour read wraps around a
    lattice axis set to zero (as in every assembled operator)."""
    KY, KX = lattice
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((4, nd, nd, 8, KY, KX))
    iy, ix = np.arange(KY)[:, None], np.arange(KX)[None, :]
    for k in range(8):
        for s in range(3):
            _, dy, dx = plan[k][s]
            wraps = (iy + dy < 0) | (iy + dy >= KY) | (ix + dx < 0) | (ix + dx >= KX)
            W[s + 1, :, :, k][:, :, wraps] = 0.0
    return torch.as_tensor(W, dtype=dtype)


def _dense_planes(lattice, seed, dtype, nd):
    """Random planes, the blocks whose neighbour read wraps included."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((4, nd, nd, 8) + tuple(lattice)), dtype=dtype)


def _x(lattice, seed, dtype, nd=3):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((nd, 8) + tuple(lattice)), dtype=dtype)


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


@pytest.mark.parametrize("nd", [6, 10])
def test_wrapper_takes_higher_nd_and_rejects_others(setup, nd):
    """The P2 / P3 widths route to the plain version on the CPU, uncounted;
    nd = 4 (which no structured space produces) raises."""
    _, splan = setup
    W = _random_planes(splan.plan, splan.lattice, nd, torch.float64, nd)
    X = _x(splan.lattice, nd + 1, torch.float64, nd)
    before = plane_spmv.launches
    y = plane_spmv(W, X, splan.plan)
    assert plane_spmv.launches == before and y.shape == X.shape
    assert torch.equal(y, plane_spmv_reference(W, X, splan.plan))
    with pytest.raises(ValueError):
        plane_spmv(W[:, :4, :4].contiguous(), X[:4].contiguous(), splan.plan)


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


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [6, 10])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card_at_higher_nd(cuda_device, setup, nd, dtype, rel):
    _, splan = setup
    W = _random_planes(splan.plan, splan.lattice, 9, dtype, nd).to(cuda_device)
    X = _x(splan.lattice, 10, dtype, nd).to(cuda_device)
    before = dict(plane_spmv.case_launches)
    y = plane_spmv(W, X, splan.plan)
    torch.cuda.synchronize()
    case = f"nd{nd}_{'f32' if dtype == torch.float32 else 'f64'}"
    assert plane_spmv.case_launches[case] == before.get(case, 0) + 1
    y_ref = plane_spmv_reference(W, X, splan.plan)
    err = (y - y_ref).abs().max().item()
    assert err <= rel * y_ref.abs().max().item(), err


# -- the kernel's launch geometry, on the CPU ---------------------------------

# the lattices of the driven paths (ESV levels 0 and 1, the bench at 2, 6, 8
# and 10 bisections, P3 level 5, ESV / thermalblock level 6) and one that no
# tile divides
LATTICES = [(4, 4), (8, 8), (20, 100), (80, 400), (160, 800), (320, 1600), (128, 128),
            (256, 256), (12, 44)]
# per (nd, bytes per value) of the kernel's instantiations
INSTANTIATIONS = sorted(TILES)
# a plan whose shifts reach two rows and columns on every side
WIDE_PLAN = tuple(tuple(((k + 3 * s + 1) % 8, (k % 5) - 2, ((k + s) % 5) - 2) for s in range(3))
                  for k in range(8))


def _geometry(nd_size, lattice, plan):
    nd, itemsize = nd_size
    return plane_geometry(nd, itemsize, lattice, plan)


@pytest.mark.parametrize("nd_size", INSTANTIATIONS)
@pytest.mark.parametrize("lattice", LATTICES)
def test_tiles_cover_every_site_once(setup, lattice, nd_size):
    g = _geometry(nd_size, lattice, setup[1].plan)
    KY, KX = lattice
    assert (g.grid_y - 1) * g.TY < KY <= g.grid_y * g.TY
    assert (g.grid_x - 1) * g.TX < KX <= g.grid_x * g.TX
    assert g.TX == 1 << g.lx and (g.TY, g.TX) == TILES[nd_size][:2]
    hits = np.zeros((g.grid_y * g.TY, g.grid_x * g.TX), dtype=np.int64)
    for by in range(g.grid_y):
        for bx in range(g.grid_x):
            hits[by * g.TY:(by + 1) * g.TY, bx * g.TX:(bx + 1) * g.TX] += 1
    assert (hits == 1).all()


def _check_reads_in_halo(g, plan):
    """Every (k, s) read of every site, through the kernel's offsets into the
    staged box [8, BY, BX] of its tile, lands inside the box and on the X
    value that the wrap on each axis names."""
    KY, KX = g.KY, g.KX
    gy, gx = np.meshgrid(np.arange(KY), np.arange(KX), indexing="ij")
    y0, x0 = (gy // g.TY) * g.TY, (gx // g.TX) * g.TX
    local = (gy - y0) * g.BX + (gx - x0)
    box = g.BY * g.BX
    for k in range(8):
        for s in range(4):
            ks, dy, dx = (k, 0, 0) if s == 0 else plan[k][s - 1]
            off = g.xoff[k][s] + local
            assert (off // box == ks).all()
            r, c = (off % box) // g.BX, off % g.BX
            assert (r - (gy - y0) == g.hy + dy).all() and (c - (gx - x0) == g.hx + dx).all()
            assert ((0 <= r) & (r < g.BY) & (0 <= c) & (c < g.BX)).all()
            # the staged row / column holds X's wrapped row / column
            assert ((y0 - g.hy + r) % KY == (gy + dy) % KY).all()
            assert ((x0 - g.hx + c) % KX == (gx + dx) % KX).all()


@pytest.mark.parametrize("nd_size", INSTANTIATIONS)
@pytest.mark.parametrize("lattice", LATTICES)
def test_shifted_reads_land_in_the_halo(setup, lattice, nd_size):
    plan = setup[1].plan
    g = _geometry(nd_size, lattice, plan)
    assert (g.hy, g.BY - g.TY - g.hy, g.hx, g.BX - g.TX - g.hx) == (1, 1, 1, 1)
    _check_reads_in_halo(g, plan)


@pytest.mark.parametrize("nd_size", INSTANTIATIONS)
@pytest.mark.parametrize("lattice", LATTICES)
def test_ring_and_staged_x_fit(setup, lattice, nd_size):
    """Ring (2-8 stages) + staged X + wrap tables + mbarriers = the dynamic
    shared memory, within 227 KB; two blocks fit on an SM at the stencil
    plan's halo of one."""
    nd, itemsize = nd_size
    g = _geometry(nd_size, lattice, setup[1].plan)
    stage = 8 * TILES[nd_size][2] * g.TY * g.TX * itemsize
    x_box = 8 * nd * g.BY * g.BX * itemsize
    assert 2 <= g.stages <= 8
    assert g.smem_bytes == 128 + g.stages * stage + x_box + 4 * (g.BY + g.BX)
    assert g.smem_bytes <= SMEM_PER_BLOCK
    assert 2 * (g.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("nd_size", INSTANTIATIONS)
def test_geometry_follows_a_wider_plan(nd_size):
    """Shifts of two on every side widen the halo to two; the reads still
    land in it, and the ring still fits (with one block per SM if needed)."""
    for lattice in ((4, 4), (20, 100), (12, 44)):
        g = _geometry(nd_size, lattice, WIDE_PLAN)
        assert (g.hy, g.BY - g.TY - g.hy, g.hx, g.BX - g.TX - g.hx) == (2, 2, 2, 2)
        assert 2 <= g.stages and g.smem_bytes <= SMEM_PER_BLOCK
        _check_reads_in_halo(g, WIDE_PLAN)


def test_geometry_rejects_what_the_kernel_does_not_take(setup):
    plan = setup[1].plan
    with pytest.raises(ValueError):
        plane_geometry(3, 4, (20, 102), plan)   # KX not a multiple of 4
    with pytest.raises(ValueError):
        plane_geometry(4, 8, (20, 100), plan)   # no nd = 4 kernel
    with pytest.raises(ValueError):
        plane_geometry(3, 2, (20, 100), plan)   # no 2-byte kernel
    far = tuple(tuple((ks, 12 * dy, 12 * dx) for ks, dy, dx in row) for row in plan)
    with pytest.raises(ValueError):
        plane_geometry(10, 8, (64, 64), far)    # a halo of 12 leaves no room for the ring


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [3, 6, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lattice", [(4, 4), (8, 8), (20, 100), (12, 44)])
def test_kernel_bitwise_equals_plain_on_wrapped_planes(cuda_device, setup, lattice, dtype, nd):
    """Nonzero wrapped blocks, lattices smaller than a tile and tiles that
    do not divide the lattice, under the stencil plan and the wider one."""
    for seed, plan in enumerate((setup[1].plan, WIDE_PLAN)):
        W = _dense_planes(lattice, 20 + seed, dtype, nd).to(cuda_device)
        X = _x(lattice, 30 + seed, dtype, nd).to(cuda_device)
        key = f"nd{nd}_{'f32' if dtype == torch.float32 else 'f64'} {lattice[0]}x{lattice[1]}"
        before = plane_spmv.lattice_launches[key]
        y = plane_spmv(W, X, plan)
        torch.cuda.synchronize()
        assert plane_spmv.lattice_launches[key] == before + 1
        assert torch.equal(y, plane_spmv_reference(W, X, plan))


@pytest.mark.cuda
def test_kernel_rejects_unaligned_lattice_on_card(cuda_device, setup):
    W = _dense_planes((8, 6), 40, torch.float32, 3).to(cuda_device)
    X = _x((8, 6), 41, torch.float32).to(cuda_device)
    with pytest.raises(ValueError):
        plane_spmv(W, X, setup[1].plan)
