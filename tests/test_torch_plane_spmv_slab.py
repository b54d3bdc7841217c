"""The slab mode of the plane SpMV (kernels/plane_spmv.py): the x-slab
matvec of the sharded stencil solver (la/stencil_sharded.py).

On the CPU: the plain version ``plane_spmv_slab_reference`` on each of D
slabs, with the ring neighbours' two columns attached, is bitwise the
unsliced ``plane_spmv_reference`` on those columns, at nd = 3, 6, 10 and
D = 1, 2, 4, on planes whose wrapped blocks are nonzero (the ring reproduces
the roll's wrap); the slab geometry reads only inside X_ext.  The ``cuda``
tests hold the kernel's slab mode bitwise to the unsliced kernel and to the
plain version on the card, at every nd and dtype (they need no JAX: run
them there with ``python -m pytest --noconftest -m cuda
tests/test_torch_plane_spmv_slab.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import (  # noqa: E402
    SLAB_HALO,
    TILES,
    plane_geometry,
    plane_spmv,
    plane_spmv_reference,
    plane_spmv_slab,
    plane_spmv_slab_reference,
)
from dune_hdd_tpu_torch.la.stencil import stencil_plan  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def plan():
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=2)
    return stencil_plan(structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0)))


def _planes(lattice, seed, dtype, nd):
    """Random planes, the blocks whose neighbour read wraps included."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((4, nd, nd, 8) + tuple(lattice)), dtype=dtype)


def _x(lattice, seed, dtype, nd):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((nd, 8) + tuple(lattice)), dtype=dtype)


def _slab(X, d, D):
    """Slab d of D of X with SLAB_HALO columns of each ring neighbour."""
    KX = X.shape[-1]
    Wd = KX // D
    cols = torch.arange(d * Wd - SLAB_HALO, (d + 1) * Wd + SLAB_HALO) % KX
    return X[..., cols.to(X.device)].contiguous()


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("nd", [3, 6, 10])
def test_slab_plain_bitwise_equals_unsliced_plain(plan, nd, D):
    lattice = (20, 100)
    W = _planes(lattice, nd, torch.float64, nd)
    X = _x(lattice, 10 + nd, torch.float64, nd)
    y = plane_spmv_reference(W, X, plan)
    Wd = lattice[1] // D
    for d in range(D):
        Wl = W[..., d * Wd:(d + 1) * Wd].contiguous()
        y_slab = plane_spmv_slab_reference(Wl, _slab(X, d, D), plan)
        assert torch.equal(y_slab, y[..., d * Wd:(d + 1) * Wd])


def test_slab_cpu_route_is_plain_and_uncounted(plan):
    W = _planes((8, 12), 1, torch.float32, 3)
    X = _x((8, 24), 2, torch.float32, 3)
    with recording() as rec:
        y = plane_spmv_slab(W, _slab(X, 0, 2), plan)
    assert rec.total("kernel.plane_spmv_slab") == 0
    assert torch.equal(y, plane_spmv_slab_reference(W, _slab(X, 0, 2), plan))
    with pytest.raises(ValueError):  # no halo columns
        plane_spmv_slab(W, X[..., :12].contiguous(), plan)


@pytest.mark.parametrize("nd_size", sorted(TILES))
@pytest.mark.parametrize("lattice", [(20, 100), (80, 100), (320, 400), (8, 4)])
def test_slab_geometry_reads_inside_x_ext(plan, nd_size, lattice):
    """Every staged column of a stored site lies inside X_ext's Wd + 4
    columns without a wrap; the unsliced geometry keeps its wrap."""
    nd, itemsize = nd_size
    g = plane_geometry(nd, itemsize, lattice, plan, True)
    assert (g.xrow, g.xcol, g.xwrap) == (lattice[1] + 2 * SLAB_HALO, SLAB_HALO, 0)
    for x in range(lattice[1]):
        x0 = (x // g.TX) * g.TX
        for dx in range(-g.hx, g.BX - g.TX - g.hx + 1):
            c = x - x0 + g.hx + dx  # box column of the read
            assert 0 <= c < g.BX
            assert 0 <= x0 - g.hx + c + g.xcol < g.xrow  # the kernel's column, never clamped
    u = plane_geometry(nd, itemsize, lattice, plan)
    assert (u.xrow, u.xcol, u.xwrap) == (lattice[1], 0, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [3, 6, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lattice,D", [((20, 128), 4), ((12, 48), 4), ((8, 16), 4),
                                       ((80, 400), 4), ((20, 100), 1)])
def test_slab_kernel_bitwise_on_card(cuda_device, plan, lattice, D, dtype, nd):
    """Each slab's kernel launch equals the unsliced kernel on its columns
    and the slab plain version, bitwise."""
    W = _planes(lattice, 50 + nd, dtype, nd).to(cuda_device)
    X = _x(lattice, 60 + nd, dtype, nd).to(cuda_device)
    y = plane_spmv(W, X, plan)
    Wd = lattice[1] // D
    case = f"nd{nd}_{'f32' if dtype == torch.float32 else 'f64'}"
    for d in range(D):
        Wl = W[..., d * Wd:(d + 1) * Wd].contiguous()
        X_ext = _slab(X, d, D)
        with recording() as rec:
            y_slab = plane_spmv_slab(Wl, X_ext, plan)
        assert rec.total(f"kernel.plane_spmv_slab.{case} {lattice[0]}x{Wd}") == 1
        assert torch.equal(y_slab, y[..., d * Wd:(d + 1) * Wd])
        assert torch.equal(y_slab, plane_spmv_slab_reference(Wl, X_ext, plan))


@pytest.mark.cuda
def test_slab_kernel_rejects_unaligned_width_on_card(cuda_device, plan):
    W = _planes((8, 6), 70, torch.float32, 3).to(cuda_device)
    X = _x((8, 12), 71, torch.float32, 3).to(cuda_device)
    with pytest.raises(ValueError):
        plane_spmv_slab(W, _slab(X, 0, 2), plan)
