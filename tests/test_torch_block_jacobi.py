"""The block-Jacobi apply of the PyTorch port (kernels/block_jacobi.py) and
``jacobi_smoother`` on it (la/stencil.py).

On the CPU: ``block_jacobi_reference`` on a contiguous Dinv is bitwise the
loop that ``jacobi_smoother`` ran before the kernel, on the strided view of
the inverse blocks, at nd 3 / 6 / 10 in float32 and float64; the smoother's
apply is bitwise that loop on assembled operators (the thermalblock SWIPDG
in float64, the SPE10 bench in float32) and on random blocks at nd 6 and
10; the wrapper sends CPU tensors to the plain version and launches
nothing; it refuses inputs the kernel does not take.  The ``cuda`` tests
hold the kernel to its plain version bitwise on the card, on the 16-byte
path and on the one-value path, count its launches, and hold the captured
PCG with the Jacobi M to the loop run op by op and to the loop on the
strided apply (``python -m pytest --noconftest -m cuda
tests/test_torch_block_jacobi.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.kernels import block_jacobi as mod  # noqa: E402
from dune_hdd_tpu_torch.kernels.block_jacobi import (  # noqa: E402
    block_jacobi,
    block_jacobi_reference,
)
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402
from dune_hdd_tpu_torch.la.block_ell import inv3x3  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import host_read, recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

DTYPES = [torch.float32, torch.float64]
NDS = [3, 6, 10]
PLAN = tuple(((k, 0, 0),) * 3 for k in range(8))  # the smoother reads only the self blocks


def _strided_inverse(D):
    """[nd, nd, 8, KY, KX] view of the blocks' inverse, as the smoother held
    it before the kernel: each (i, j) plane nd^2 elements apart."""
    nd = D.shape[-1]
    return torch.movedim(inv3x3(D) if nd == 3 else torch.linalg.inv(D), (-2, -1), (0, 1))


def _strided_apply(Dinv, R):
    """The smoother's apply before the kernel: ``jacobi_smoother``'s loop."""
    nd = Dinv.shape[0]
    out = []
    for i in range(nd):
        t = Dinv[i, 0] * R[0]
        for j in range(1, nd):
            t = torch.addcmul(t, Dinv[i, j], R[j])
        out.append(t)
    return torch.stack(out)


def _blocks(nd, lattice, dtype, seed):
    """Random well-conditioned diagonal blocks [8, KY, KX, nd, nd]."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((8,) + tuple(lattice) + (nd, nd)) + 2 * nd * np.eye(nd)
    return torch.as_tensor(D, dtype=dtype)


def _field(nd, lattice, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((nd, 8) + tuple(lattice)), dtype=dtype)


def _planes(D):
    """Planes [4, nd, nd, 8, KY, KX] with D's blocks in slot 0."""
    self_planes = torch.movedim(D, (-2, -1), (0, 1))
    return torch.cat([self_planes[None], torch.zeros((3,) + self_planes.shape,
                                                     dtype=D.dtype)])


@pytest.mark.parametrize("lattice", [(2, 3), (4, 6)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nd", NDS)
def test_reference_on_contiguous_dinv_is_the_strided_loop_bitwise(nd, dtype, lattice):
    Dinv = _strided_inverse(_blocks(nd, lattice, dtype, nd))
    assert not Dinv.is_contiguous()
    R = _field(nd, lattice, dtype, 7)
    Z = _strided_apply(Dinv, R)
    assert torch.equal(block_jacobi_reference(Dinv.contiguous(), R), Z)
    assert torch.equal(block_jacobi(Dinv.contiguous(), R), Z)


def _thermalblock_system():
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.parameters import parse_parameter
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    grid = alu_cube_grid((0.0, 0.0), (1.0, 1.0), (4, 4), refinements=4)
    disc = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                ThermalblockProblem((2, 2)), only_these_products=(),
                                device="cpu")
    system = disc.stencil_system(parse_parameter(np.array([0.1, 0.5, 1.0, 0.3]),
                                                 disc.parameter_type))
    return system.S, system.B


def _spe10_system():
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    bench = build_spe10_bench(2, device="cpu")
    S, B, _ = bench.assemble(bench.field)
    return S, B


def _random_system(nd):
    lattice = (4, 6)
    D = _blocks(nd, lattice, torch.float64, 11 * nd)
    return pt.StencilBlockEll(_planes(D), PLAN), _field(nd, lattice, torch.float64, 13)


@pytest.mark.parametrize("case", ["thermalblock_p1_f64", "spe10_p1_f32", "random_nd6",
                                  "random_nd10"])
def test_jacobi_smoother_apply_is_the_strided_loop_bitwise(case):
    S, B = {"thermalblock_p1_f64": _thermalblock_system, "spe10_p1_f32": _spe10_system,
            "random_nd6": lambda: _random_system(6),
            "random_nd10": lambda: _random_system(10)}[case]()
    D = torch.movedim(S.diagonal_blocks(), (0, 1), (-2, -1))
    R = B * torch.linspace(0.5, 1.5, B.numel(), dtype=B.dtype).reshape(B.shape)
    Z = pt.jacobi_smoother(S)(R)
    assert Z.shape == R.shape and Z.dtype == R.dtype
    assert torch.equal(Z, _strided_apply(_strided_inverse(D), R))


@pytest.mark.parametrize("nd", NDS)
def test_wrapper_sends_cpu_tensors_to_the_plain_version(nd, monkeypatch):
    def no_launch(*args):
        raise AssertionError("the kernel was launched for CPU tensors")

    monkeypatch.setattr(mod, "_launch", no_launch)
    Dinv = _strided_inverse(_blocks(nd, (2, 3), torch.float64, 3)).contiguous()
    R = _field(nd, (2, 3), torch.float64, 4)
    with recording() as rec:
        Z = block_jacobi(Dinv, R)
    assert rec.totals_under("kernel.") == {}
    assert torch.equal(Z, block_jacobi_reference(Dinv, R))


@pytest.mark.parametrize("fault", ["nd4", "dtype", "float16", "strided_dinv", "strided_r",
                                   "lattice", "nd_of_r", "subclasses", "devices"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    lattice = (2, 3)
    Dinv = _strided_inverse(_blocks(3, lattice, torch.float64, 5))
    C, R = Dinv.contiguous(), _field(3, lattice, torch.float64, 6)
    D4 = _strided_inverse(_blocks(4, lattice, torch.float64, 5)).contiguous()
    args = {"nd4": (D4, _field(4, lattice, torch.float64, 6)),
            "dtype": (C, R.float()),
            "float16": (C.half(), R.half()),
            "strided_dinv": (Dinv, R),
            "strided_r": (C, torch.cat([R, R], dim=-1)[..., ::2]),
            "lattice": (C, R[..., :-1].contiguous()),
            "nd_of_r": (C, R[:2].contiguous()),
            "subclasses": (C[:, :, :4].contiguous(), R[:, :4].contiguous()),
            "devices": (C, torch.empty(R.shape, dtype=R.dtype, device="meta"))}[fault]
    with pytest.raises((TypeError, ValueError)):
        block_jacobi(*args)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _on_card(nd, lattice, dtype, device, seed=1):
    """(contiguous Dinv, R, the strided Dinv) on the card."""
    Dinv = _strided_inverse(_blocks(nd, lattice, dtype, seed).to(device))
    return Dinv.contiguous(), _field(nd, lattice, dtype, seed + 1).to(device), Dinv


@pytest.mark.cuda
@pytest.mark.parametrize("lattice, dtype", [((256, 256), torch.float64),
                                            ((160, 800), torch.float32)])
def test_kernel_is_the_plain_version_bitwise_at_the_cells_shapes(cuda_device, lattice, dtype):
    Dinv, R, strided = _on_card(3, lattice, dtype, cuda_device)
    with recording() as rec:
        Z = block_jacobi(Dinv, R)
    torch.cuda.synchronize()
    assert rec.total("kernel.block_jacobi") == 1 and rec.total("kernel.block_jacobi.scalar") == 0
    assert rec.total(f"kernel.block_jacobi.nd3_{mod._DTYPES[dtype]} {lattice[0]}x{lattice[1]}") == 1
    assert Z.dtype == dtype and Z.shape == R.shape
    assert torch.equal(Z, block_jacobi_reference(Dinv, R))
    assert torch.equal(Z, _strided_apply(strided, R))  # the apply before the kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nd", NDS)
def test_kernel_is_the_plain_version_bitwise_at_every_nd(cuda_device, nd, dtype):
    for lattice in [(2, 3), (16, 24), (33, 17)]:
        Dinv, R, _ = _on_card(nd, lattice, dtype, cuda_device, seed=nd)
        assert torch.equal(block_jacobi(Dinv, R), block_jacobi_reference(Dinv, R))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nd", [3, 10])
def test_kernel_takes_unaligned_inputs_one_value_a_thread(cuda_device, nd, dtype):
    """R at an offset of one value from the allocator's alignment: the
    one-value path, bitwise too."""
    Dinv, R, _ = _on_card(nd, (16, 24), dtype, cuda_device, seed=2)
    shifted = torch.empty(R.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(R.shape)
    shifted.copy_(R)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with recording() as rec:
        Z = block_jacobi(Dinv, shifted)
    assert rec.total("kernel.block_jacobi.scalar") == 1
    assert torch.equal(Z, block_jacobi_reference(Dinv, R))


@pytest.fixture(scope="module")
def card_system():
    """(A, B with ||B|| = 1) of the thermalblock SWIPDG at 8 bisections
    (lattice 64 x 64), float64, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.parameters import parse_parameter
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    grid = alu_cube_grid((0.0, 0.0), (1.0, 1.0), (4, 4), refinements=8)
    disc = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                ThermalblockProblem((2, 2)), only_these_products=(),
                                device="cuda")
    system = disc.stencil_system(parse_parameter(np.array([0.1, 0.5, 1.0, 0.3]),
                                                 disc.parameter_type))
    return system.S, system.B / torch.linalg.norm(system.B)


@pytest.mark.cuda
def test_captured_pcg_on_the_kernel_is_the_strided_loop_bitwise(card_system):
    """The PCG with the Jacobi M, replayed as CUDA graphs, against the same
    loop run op by op (an M that syncs cannot be captured) and against the
    loop on the apply before the kernel: the same iterates and count."""
    A, B = card_system
    M = pt.jacobi_smoother(A)
    D = torch.movedim(A.diagonal_blocks(), (0, 1), (-2, -1))
    strided = _strided_inverse(D)

    def syncing(R):
        host_read(R.reshape(-1)[0])
        return M(R)

    with recording() as rec:
        X_g, k_g = pt.stencil_pcg(A, B, M, rtol=1e-8, maxiter=4000)
    X_e, k_e = pt.stencil_pcg(A, B, syncing, rtol=1e-8, maxiter=4000)
    X_s, k_s = pt.stencil_pcg(A, B, lambda R: _strided_apply(strided, R), rtol=1e-8,
                              maxiter=4000)
    assert rec.total("pcg.graph.captures") == 2 and rec.total("pcg.graph.eager_fallbacks") == 0
    assert k_g == k_e == k_s > 0
    assert torch.equal(X_g, X_e) and torch.equal(X_g, X_s)
    # one apply in the init and one an iteration, counted again at each replay
    assert rec.total("kernel.block_jacobi") == k_g + 1
