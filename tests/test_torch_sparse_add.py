"""``SparseMatrix.__add__`` of the PyTorch port sums slot by slot only over
one pattern, or over patterns with the same shape and the same slots; two
matrices of equal shape whose slots differ are refused.  Every sum the port
makes (affine freezing of operators, products and coupling operators, the
reference's blocks carried across by ``convert``) still works, and empty
patterns (no slots) assemble, freeze and apply."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.problems import ParametricESV2007Problem as JOS  # noqa: E402
from dune_hdd_tpu_torch.affine import AffineDecomposition  # noqa: E402
from dune_hdd_tpu_torch.convert import coupling_from_numpy  # noqa: E402
from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization as TB  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.la.sparse import SparseMatrix, build_pattern  # noqa: E402
from dune_hdd_tpu_torch.problems import ParametricESV2007Problem as TOS  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
BLOCKS = ("in_in", "in_out", "out_in", "out_out")


def _matrix(rows, cols, shape, values=None):
    p = build_pattern(np.asarray(rows), np.asarray(cols), shape)
    raw = torch.arange(1.0, len(rows) + 1.0, dtype=torch.float64) if values is None else values
    return SparseMatrix(p, p.assemble(raw))


def test_equal_shape_different_slots_refused():
    a = _matrix([0, 1, 2], [0, 1, 2], (3, 3))
    b = _matrix([0, 1, 2], [1, 2, 0], (3, 3))
    assert a.shape == b.shape and a.pattern.nnz == b.pattern.nnz
    with pytest.raises(ValueError, match="different patterns"):
        a + b
    with pytest.raises(ValueError, match="different patterns"):
        a + _matrix([0, 1], [0, 1], (3, 3))
    with pytest.raises(ValueError, match="different patterns"):
        a + _matrix([0, 1, 2], [0, 1, 2], (3, 4))


def test_same_pattern_and_same_slots_sum():
    a = _matrix([0, 1, 2, 2], [0, 1, 2, 0], (3, 3))
    assert torch.equal((a + a * 2.0).values, 3.0 * a.values)
    # another pattern object with the same slots (raw entries duplicated and
    # in another order)
    b = _matrix([2, 0, 2, 1, 1], [0, 0, 2, 1, 1], (3, 3))
    assert b.pattern is not a.pattern
    s = a + b
    assert s.pattern is a.pattern
    assert torch.equal(s.to_dense(), a.to_dense() + b.to_dense())


def test_empty_pattern_assembles_and_applies():
    empty = np.zeros(0, dtype=np.int64)
    p = build_pattern(empty, empty, (4, 6))
    m = SparseMatrix(p, p.assemble(torch.zeros(0, dtype=torch.float64)))
    assert p.nnz == 0 and m.values.shape == (0,)
    assert torch.equal(m.matvec(torch.ones(6, dtype=torch.float64)),
                       torch.zeros(4, dtype=torch.float64))
    assert torch.equal((m + m * 3.0).to_dense(), torch.zeros(4, 6, dtype=torch.float64))


@pytest.mark.parametrize("scheme", ["reference", "penalty_mu"])
def test_existing_sums_still_work(scheme):
    """Operators, products and coupling operators freeze (a sum over affine
    components sharing patterns) to the reference's values, and the
    reference's coupling blocks carried across freeze to the port's."""
    jd = JB(j_grid((-1, -1), (1, 1), (4, 4), refinements=2), BI, JOS(), num_partitions=(2, 2),
            scheme=scheme, only_these_products=("l2", "energy", "elliptic"))
    td = TB(t_grid((-1, -1), (1, 1), (4, 4), refinements=2), BI, TOS(), num_partitions=(2, 2),
            scheme=scheme, only_these_products=("l2", "energy", "elliptic"), device="cpu")
    for m in (0.3, 1.0):
        jmu, tmu = {"mu": jnp.asarray([m])}, {"mu": torch.tensor([m], dtype=torch.float64)}
        for t, j in ((td.freeze_operator(tmu), jd.freeze_operator(jmu)),
                     (td.product_matrix("elliptic", tmu), jd.product_matrix("elliptic", jmu)),
                     (td.product_matrix("energy", tmu), jd.product_matrix("energy", jmu))):
            np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                                       rtol=0, atol=1e-12 * float(np.abs(j.to_dense()).max()))
        jc = jd.get_coupling_operator(0, 1)
        patterns: dict = {}
        carried = AffineDecomposition(
            [coupling_from_numpy(c, "cpu", patterns) for c in jc.components],
            list(td.get_coupling_operator(0, 1).coefficients),
            coupling_from_numpy(jc.affine_part, "cpu", patterns))
        own = td.get_coupling_operator(0, 1).freeze(tmu)
        frozen = carried.freeze(tmu)
        for name in BLOCKS:
            ref = getattr(own, name).to_dense()
            np.testing.assert_allclose(getattr(frozen, name).to_dense().numpy(), ref.numpy(),
                                       rtol=0, atol=1e-12 * float(ref.abs().max()))


def test_coupling_blocks_of_another_pair_refused():
    """Two pairs' in_in blocks of equal shape but other slots do not sum."""
    td = TB(t_grid((-1, -1), (1, 1), (4, 4), refinements=2), BI, TOS(), num_partitions=(2, 2),
            device="cpu")
    a = td.get_coupling_operator(0, 1).affine_part
    b = td.get_coupling_operator(0, 2).affine_part
    assert a.in_in.shape == b.in_in.shape
    assert not np.array_equal(a.in_in.pattern.slot_rows, b.in_in.pattern.slot_rows) or \
        not np.array_equal(a.in_in.pattern.slot_cols, b.in_in.pattern.slot_cols)
    with pytest.raises(ValueError, match="different patterns"):
        a + b
