"""The structured-numbering block SpMV of the PyTorch port
(kernels/structured_spmv.py, la/block_ell.StructuredBlockEll).

On the CPU, at 1e-5 x max in float32:

* the plain version equals the reference's Pallas kernel (interpret mode)
  on random blocks with random offsets at nc = 4096, a multiple of 1024;
* at an nc that is not a multiple of 1024 it equals the reference's
  StructuredBlockEll.matvec (reads modulo nc), while the Pallas kernel,
  which reads modulo the 1024-padded count, differs there;
* on the 2-bisection assembled SPE10 operator, repacked from the plane
  layout with the structured order's offsets, it equals plane_spmv's plain
  version.

The wrapper takes nd in {3, 6, 10} DoF per cell (DG P1-P3) and no other.
The ``cuda`` tests hold the CUDA kernel to the plain version on the card, at
nd = 3, 6 and 10 (they need no JAX: run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_structured_spmv.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.convert import structured_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv_reference  # noqa: E402
from dune_hdd_tpu_torch.kernels.structured_spmv import (  # noqa: E402
    structured_spmv,
    structured_spmv_reference,
)
from dune_hdd_tpu_torch.la.block_ell import StructuredBlockEll  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def jx():
    """The JAX package's block-ELL and Pallas modules (skips where JAX is
    absent)."""
    pytest.importorskip("jax")
    from dune_hdd_tpu.la import block_ell, pallas_spmv

    return block_ell, pallas_spmv


def _random(nc, seed, nd=3):
    """(neighbors, blocks [nc, 4, nd, nd], offsets 8 x 3, x [nc * nd]) with
    random offsets, as in the reference's Pallas test."""
    rng = np.random.default_rng(seed)
    offsets = tuple(tuple(int(o) for o in row)
                    for row in rng.integers(-nc // 2, nc // 2, size=(8, 3)))
    blocks = rng.normal(size=(nc, 4, nd, nd)).astype(np.float32)
    x = rng.normal(size=nc * nd).astype(np.float32)
    return np.zeros((nc, 4), np.int32), blocks, offsets, x


def _jax_structured(jx, neighbors, blocks, offsets):
    block_ell, _ = jx
    return block_ell.StructuredBlockEll(neighbors, blocks, offsets)


def _close(actual, desired, rel=1e-5):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=0,
                               atol=rel * np.abs(desired).max())


def test_plain_matches_pallas_interpret(jx):
    _, pallas_spmv = jx
    neighbors, blocks, offsets, x = _random(4096, 0)
    A = structured_from_numpy(neighbors, blocks, offsets, "cpu")
    A_j = _jax_structured(jx, neighbors, blocks, offsets)
    mv, bplanes = pallas_spmv.build_structured_pallas_matvec(A_j, interpret=True)
    y_pallas = np.asarray(mv(bplanes, x))
    _close(A.matvec(torch.as_tensor(x)).numpy(), y_pallas)


def test_plain_wraps_modulo_nc_where_pallas_reads_padding(jx):
    """nc = 4000 is not a multiple of 1024: the port follows the reference's
    StructuredBlockEll.matvec; the Pallas kernel's reads past nc land in
    its zero padding (the reference kernel's fault)."""
    _, pallas_spmv = jx
    neighbors, blocks, offsets, x = _random(4000, 1)
    A_j = _jax_structured(jx, neighbors, blocks, offsets)
    y_ref = np.asarray(A_j.matvec(x))
    y = structured_from_numpy(neighbors, blocks, offsets, "cpu").matvec(torch.as_tensor(x))
    _close(y.numpy(), y_ref)
    mv, bplanes = pallas_spmv.build_structured_pallas_matvec(A_j, interpret=True)
    y_pallas = np.asarray(mv(bplanes, x))
    assert np.abs(y_pallas - y_ref).max() > 0.1 * np.abs(y_ref).max()


def test_structured_accessors_match_reference(jx):
    neighbors, blocks, offsets, x = _random(4000, 2)
    A = structured_from_numpy(neighbors, blocks, offsets, "cpu")
    A_j = _jax_structured(jx, neighbors, blocks, offsets)
    assert (A.num_cells, A.nd, A.offsets) == (A_j.num_cells, A_j.nd, A_j.offsets)
    np.testing.assert_array_equal(A.diagonal_blocks().numpy(), np.asarray(A_j.diagonal_blocks()))
    xc = x.reshape(-1, 3)
    np.testing.assert_array_equal(A.neighbor_fields(torch.as_tensor(xc)).numpy(),
                                  np.asarray(A_j.neighbor_fields(xc)))
    A2 = A.with_blocks(2 * A.blocks)
    assert A2.offsets == A.offsets and A2.neighbors is A.neighbors
    _close(A2.matvec(torch.as_tensor(x)).numpy(), 2 * A.matvec(torch.as_tensor(x)).numpy())


def test_flat_plain_matches_plane_plain_on_assembled_operator():
    """The same assembled operator in the two layouts: the planes' cells in
    subclass-major lattice order are the structured numbering."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    bench = build_spe10_bench(2, device="cpu")
    S, B, _ = bench.assemble(bench.field)
    nc = S.num_cells
    A = StructuredBlockEll(None, S.planes.reshape(4, 3, 3, nc).permute(3, 0, 1, 2),
                           bench.offsets)
    assert A.planes.data_ptr() == S.planes.data_ptr()  # the repack is a view
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(B.shape)),
                        dtype=torch.float32)
    y_plane = plane_spmv_reference(S.planes, X, S.plan)
    y = A.matvec(X.reshape(3, nc).t().reshape(-1))
    _close(y.reshape(nc, 3).t().reshape(B.shape).numpy(), y_plane.numpy())


def test_wrapper_rejects_bad_inputs():
    neighbors, blocks, offsets, x = _random(4000, 4)
    P = torch.as_tensor(np.moveaxis(blocks, 0, -1).copy())
    X = torch.as_tensor(x)
    with pytest.raises(ValueError):
        structured_spmv(P[:3], X, offsets)               # wrong slot count
    with pytest.raises(ValueError):
        structured_spmv(P[:, :2, :2], X[:8000], offsets)  # nd the kernel is not built for
    with pytest.raises(ValueError):
        structured_spmv(P, X[:-3], offsets)              # length mismatch
    with pytest.raises(ValueError):
        structured_spmv(P[..., :3996], X[:11988], offsets)  # not 8 subclasses
    with pytest.raises(TypeError):
        structured_spmv(P.double(), X.double(), offsets)  # float32 only
    with pytest.raises(ValueError):
        structured_spmv(torch.as_tensor(np.moveaxis(blocks, 0, -1)), X, offsets)  # strided


@pytest.mark.parametrize("nd", [6, 10])
def test_wrapper_takes_higher_nd(nd):
    """The P2 / P3 widths route to the plain version on the CPU, uncounted,
    and equal the plane layout's plain SpMV on the same random blocks."""
    neighbors, blocks, offsets, x = _random(4096, nd, nd)
    A = structured_from_numpy(neighbors, blocks, offsets, "cpu")
    with recording() as rec:
        y = A.matvec(torch.as_tensor(x))
    assert rec.total("kernel.structured_spmv") == 0
    assert torch.equal(y, structured_spmv_reference(A.planes, torch.as_tensor(x), A.offsets))


def test_cpu_routes_to_plain_version_uncounted():
    neighbors, blocks, offsets, x = _random(4000, 5)
    P = torch.as_tensor(np.moveaxis(blocks, 0, -1).copy())
    with recording() as rec:
        y = structured_spmv(P, torch.as_tensor(x), offsets)
    assert rec.total("kernel.structured_spmv") == 0
    assert torch.equal(y, structured_spmv_reference(P, torch.as_tensor(x), offsets))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nc,nd", [(4096, 3), (4000, 3), (4000, 6), (4000, 10)])
def test_kernel_matches_plain_on_card(cuda_device, nc, nd):
    neighbors, blocks, offsets, x = _random(nc, 6, nd)
    A = structured_from_numpy(neighbors, blocks, offsets, cuda_device)
    X = torch.as_tensor(x).to(cuda_device)
    with recording() as rec:
        y = A.matvec(X)
    assert rec.total("kernel.structured_spmv") == 1
    y_ref = structured_spmv_reference(A.planes, X, A.offsets)
    assert (y - y_ref).abs().max().item() <= 1e-5 * y_ref.abs().max().item()

