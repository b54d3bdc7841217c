"""The scalar-ELL SpMV of the PyTorch port (kernels/ell_spmv.py) and
``SparseMatrix.matvec`` / ``matmat`` on it (la/sparse.py).

On the CPU: ``ell_spmv_reference`` is bitwise the gather, product and row
sum that ``SparseMatrix.matvec`` computed before the kernel, with int64
columns, on random patterns (square and rectangular, K = 1, an empty row,
padded slots, N = 0) in float32 and float64, and ``SparseMatrix.matvec`` is
bitwise that; the wrapper sends CPU tensors to the plain version and
launches nothing; it refuses inputs the kernel does not take;
``SparseMatrix.matvec`` matches the JAX package's on the 3D Q1 thermalblock
operator at 4^3 cells to 1e-14 relative; the device index holds int32
columns and ``matmat`` still equals its einsum formula; the launch geometry
keeps every tile 16-byte aligned inside one block's shared memory.  The
``cuda`` test holds the kernel to its plain version on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_ell_spmv.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.kernels import ell_spmv as mod  # noqa: E402
from dune_hdd_tpu_torch.kernels.ell_spmv import (  # noqa: E402
    HEADER_BYTES,
    SMEM_PER_BLOCK,
    ell_geometry,
    ell_spmv,
    ell_spmv_reference,
)
from dune_hdd_tpu_torch.la.sparse import SparseMatrix, build_pattern  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

DTYPES = [torch.float32, torch.float64]
H100_SMS = 132


def _random_matrix(case, dtype, seed=0):
    """(SparseMatrix, x) of a random pattern of the named kind, with
    duplicate raw entries, so that slots sum several contributions."""
    rng = np.random.default_rng(seed)
    n, m, per_row = {"square": (40, 40, 6), "rectangular": (30, 55, 5), "k1": (25, 25, 1),
                     "empty_row": (20, 20, 4), "padded": (35, 35, 9), "n0": (0, 7, 0)}[case]
    rows = np.repeat(np.arange(n), per_row)
    if case == "k1":  # one slot a row: the diagonal
        cols = rows.copy()
    else:
        cols = rng.integers(0, m, rows.size)
    if case == "empty_row":
        keep = rows != 7
        rows, cols = rows[keep], cols[keep]
    if case == "padded":  # rows of 1 to per_row slots, most of them padded
        keep = rng.random(rows.size) < rng.random(n)[rows]
        keep[::per_row] = True
        rows, cols = rows[keep], cols[keep]
    rows, cols = np.concatenate([rows, rows[: rows.size // 3]]), np.concatenate(
        [cols, cols[: cols.size // 3]])
    p = build_pattern(rows, cols, (n, m))
    raw = torch.as_tensor(rng.standard_normal(rows.size), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(m), dtype=dtype)
    return SparseMatrix(p, p.assemble(raw)), x


def _formula(A, x):
    """SparseMatrix.matvec as it was before the kernel: int64 columns."""
    cols = torch.as_tensor(np.asarray(A.pattern.ell_cols, dtype=np.int64))
    return (A.ell * x[cols]).sum(dim=1)


CASES = ["square", "rectangular", "k1", "empty_row", "padded", "n0"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_reference_and_matvec_equal_the_formula_bitwise(case, dtype):
    A, x = _random_matrix(case, dtype)
    cols = A.pattern.on(x.device).ell_cols
    if case == "empty_row":
        assert A.pattern.ell_mask[7].sum() == 0
    if case == "padded":
        assert 0 < (~A.pattern.ell_mask).sum() and A.pattern.ell_mask.sum(1).min() == 1
    if case == "k1":
        assert A.pattern.ell_width == 1
    y = _formula(A, x)
    assert y.shape == (A.shape[0],) and y.dtype == dtype
    assert torch.equal(ell_spmv_reference(A.ell, cols, x), y)
    assert torch.equal(A.matvec(x), y)
    assert torch.equal(A @ x, y)


@pytest.mark.parametrize("case", ["square", "rectangular", "n0"])
def test_wrapper_sends_cpu_tensors_to_the_plain_version(case, monkeypatch):
    A, x = _random_matrix(case, torch.float64)

    def no_launch(*args):
        raise AssertionError("the kernel was launched for CPU tensors")

    monkeypatch.setattr(mod, "_launch", no_launch)
    cols = A.pattern.on(x.device).ell_cols
    with recording() as rec:
        y = ell_spmv(A.ell, cols, x)
    assert rec.total("kernel.ell_spmv") == 0
    assert torch.equal(y, ell_spmv_reference(A.ell, cols, x))


@pytest.mark.parametrize("fault", ["dtype_x", "int64_cols", "strided_x", "matrix_x",
                                   "shape", "float16"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    A, x = _random_matrix("square", torch.float64)
    vals, cols = A.ell, A.pattern.on(x.device).ell_cols
    args = {"dtype_x": (vals, cols, x.float()),
            "int64_cols": (vals, cols.long(), x),
            "strided_x": (vals, cols, torch.stack([x, x], 1)[:, 0]),
            "matrix_x": (vals, cols, x[:, None]),
            "shape": (vals, cols[:, :-1].contiguous(), x),
            "float16": (vals.half(), cols, x.half())}[fault]
    with pytest.raises((TypeError, ValueError)):
        ell_spmv(*args)


@pytest.mark.parametrize("case", ["square", "rectangular", "padded"])
def test_device_columns_are_int32_and_matmat_keeps_its_formula(case):
    A, x = _random_matrix(case, torch.float64, seed=3)
    idx = A.pattern.on(x.device)
    assert idx.ell_cols.dtype == torch.int32
    assert idx.seg_table.dtype == torch.int64 and idx.slot_ell_pos.dtype == torch.int64
    X = torch.as_tensor(np.random.default_rng(4).standard_normal((A.shape[1], 3)))
    cols = torch.as_tensor(np.asarray(A.pattern.ell_cols, dtype=np.int64))
    assert torch.equal(A.matmat(X), torch.einsum("nk,nkK->nK", A.ell, X[cols]))


def test_matvec_matches_the_jax_package_on_the_3d_q1_operator():
    pytest.importorskip("jax")
    from dune_hdd_tpu.discretizations.tensor_cg import TensorCGDiscretization as JTCG
    from dune_hdd_tpu.grid.tensor import tensor_grid as jtensor_grid
    from dune_hdd_tpu.problems.thermalblock import ThermalblockProblem as JTB
    from dune_hdd_tpu_torch.discretizations.tensor_cg import TensorCGDiscretization as TTCG
    from dune_hdd_tpu_torch.grid.tensor import tensor_grid
    from dune_hdd_tpu_torch.problems.thermalblock import ThermalblockProblem

    mu = {"diffusion_factor": np.array([0.1, 1.0, 0.5, 2.0, 1.0, 0.3, 4.0, 1.0])}
    t = TTCG(tensor_grid((0.0,) * 3, (1.0,) * 3, (4, 4, 4)), None,
             ThermalblockProblem((2, 2, 2)), only_these_products=(), device="cpu")
    j = JTCG(jtensor_grid((0.0,) * 3, (1.0,) * 3, (4, 4, 4)), None, JTB((2, 2, 2)),
             only_these_products=())
    A, Aj = t.freeze_operator(mu), j.freeze_operator(mu)
    assert A.shape == (125, 125) and A.pattern.ell_width == 27
    x = np.random.default_rng(5).standard_normal(125)
    y = A.matvec(torch.as_tensor(x)).numpy()
    yj = np.asarray(Aj.matvec(x))
    assert np.abs(y - yj).max() <= 1e-14 * np.abs(yj).max()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n, K", [(2_146_689, 27), (1_572_864, 12), (10 ** 6, 1), (1000, 1),
                                  (7, 3), (50_000, 80), (3, 400), (100_000, 2000)])
def test_geometry_keeps_tiles_aligned_in_one_block(n, K, itemsize):
    R, threads, smem = ell_geometry(n, K, itemsize, H100_SMS)
    stage = R * K * (itemsize + 4)
    assert R >= 4 and R % 4 == 0 and 32 <= threads <= mod.MAX_THREADS and threads % 32 == 0
    assert (R * K * itemsize) % 16 == 0 and stage % 16 == 0  # tile starts and regions
    assert smem == HEADER_BYTES + mod.STAGES * stage <= SMEM_PER_BLOCK
    assert R % threads == 0 or R < threads  # whole rows a thread
    assert -(-n // R) >= H100_SMS or R < -(-n // H100_SMS) + 4  # small ones spread
    expected = {(2_146_689, 27, 8): (352, 352),  # the 3D Q1 operator: 2 x 114 KB
                (1_572_864, 12, 4): (512, 512),  # SWIPDG P1: the most rows in flight
                (10 ** 6, 1, 8): (4096, 512),    # short rows: 8 a thread, 48 KB a stage
                (1000, 1, 8): (8, 32),           # spread over the SMs
                (100_000, 2000, 8): (4, 32)}     # long rows: 4 a stage
    if (n, K, itemsize) in expected:
        assert (R, threads) == expected[n, K, itemsize]


def test_geometry_refuses_rows_too_long_for_two_stages():
    with pytest.raises(ValueError):
        ell_geometry(1000, 5000, 8, H100_SMS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    A, x = _random_matrix(case, dtype)
    A, x = SparseMatrix(A.pattern, A.values.to(cuda_device)), x.to(cuda_device)
    cols = A.pattern.on(cuda_device).ell_cols
    with recording() as rec:
        y = ell_spmv(A.ell, cols, x)
        y2 = ell_spmv(A.ell, cols, x)
    assert rec.total("kernel.ell_spmv") == (2 if A.shape[0] else 0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)  # a fixed order of the sums
    ref = ell_spmv_reference(A.ell, cols, x)
    assert y.shape == ref.shape and y.dtype == dtype
    if y.numel():
        rel = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
        assert (y - ref).abs().max().item() <= rel * ref.abs().max().item()
