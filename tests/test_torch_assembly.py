"""Assembly and sparse algebra of the PyTorch port against the JAX package's
(x64, CPU) on an ESV2007-type grid (4x4 cube, 4 bisections) with a
non-constant diffusion and Dirichlet data:

* sparsity patterns (slots, sort order, ELL layout) and the block-ELL and
  plane-layout index maps: bitwise;
* cell, face and boundary blocks, rhs functionals and ``error_norms``:
  1e-12 x max (the same float64 sums, in another order);
* SparseMatrix / BlockEllMatrix products, scaling, block-Jacobi and
  block_cg against the reference's: 1e-12 x max (block_cg: 1e-10, the
  solves stop at 1e-12 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.functions import base as jf  # noqa: E402
from dune_hdd_tpu.functions.esv2007 import Testcase1ExactSolution as JExact  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.grid.structured_order import structured_cell_order as j_order  # noqa: E402
from dune_hdd_tpu.la import block_ell as jbe  # noqa: E402
from dune_hdd_tpu.la import stencil as jst  # noqa: E402
from dune_hdd_tpu.ops import assembly as ja  # noqa: E402
from dune_hdd_tpu.ops import norms as jn  # noqa: E402
from dune_hdd_tpu.ops import spaces as jsp  # noqa: E402
from dune_hdd_tpu.ops import swipdg as jsw  # noqa: E402
from dune_hdd_tpu_torch.functions import base as tf  # noqa: E402
from dune_hdd_tpu_torch.functions.esv2007 import Testcase1ExactSolution as TExact  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order as t_order  # noqa: E402
from dune_hdd_tpu_torch.la import block_ell as tbe  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as tst  # noqa: E402
from dune_hdd_tpu_torch.ops import assembly as ta  # noqa: E402
from dune_hdd_tpu_torch.ops import norms as tn  # noqa: E402
from dune_hdd_tpu_torch.ops import spaces as tsp  # noqa: E402
from dune_hdd_tpu_torch.ops import swipdg as tsw  # noqa: E402

REL = 1e-12
DIFFUSION = "1 + 0.5*sin(2*x[0])*cos(3*x[1])"
DIRICHLET = "0.25*x[0]*x[1]"
PATTERN_FIELDS = ("perm", "seg_ids", "slot_rows", "slot_cols", "ell_cols", "ell_mask",
                  "slot_ell_pos", "diag_slot")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def env():
    tg, jg = t_grid((-1, -1), (1, 1), (4, 4), refinements=4), j_grid((-1, -1), (1, 1), (4, 4),
                                                                     refinements=4)
    space_t, space_j = tsp.dg_space(tg, device="cpu"), jsp.dg_space(jg)
    interior = np.nonzero(jg.interior_faces)[0]
    boundary = np.nonzero(jg.boundary_faces)[0]
    return dict(tg=tg, jg=jg, t=space_t, j=space_j, interior=interior, boundary=boundary,
                lam=(tf.ExpressionFunction(DIFFUSION, order=3),
                     jf.ExpressionFunction(DIFFUSION, order=3)),
                kap=(tf.constant_matrix(1.0), jf.constant_matrix(1.0)),
                g=(tf.ExpressionFunction(DIRICHLET), jf.ExpressionFunction(DIRICHLET)),
                w=(tf.ConstantFunction(2.0), jf.ConstantFunction(2.0)))


def _close(a, b, rel=REL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


def test_patterns_bitwise(env):
    for pt_pat, jx_pat in [
        (tsw.swipdg_pattern(env["t"], env["interior"], env["boundary"]),
         jsw.swipdg_pattern(env["j"], env["interior"], env["boundary"])),
        (ta.volume_pattern(env["t"]), ja.volume_pattern(env["j"])),
    ]:
        assert (pt_pat.shape, pt_pat.nnz, pt_pat.ell_width) == (
            jx_pat.shape, jx_pat.nnz, jx_pat.ell_width)
        for name in PATTERN_FIELDS:
            np.testing.assert_array_equal(getattr(pt_pat, name), getattr(jx_pat, name))
    np.testing.assert_array_equal(env["t"].cell_dofs, env["j"].cell_dofs)


@pytest.mark.parametrize("kind", ["elliptic", "l2", "l2_weighted", "force"])
def test_cell_kernels(env, kind):
    t, j = env["t"], env["j"]
    if kind == "elliptic":
        got = ta.elliptic_cell_matrices(t, env["lam"][0], env["kap"][0])
        want = ja.elliptic_cell_matrices(j, env["lam"][1], env["kap"][1])
    elif kind == "l2":
        got, want = ta.l2_cell_matrices(t), ja.l2_cell_matrices(j)
    elif kind == "l2_weighted":
        got, want = ta.l2_cell_matrices(t, env["lam"][0]), ja.l2_cell_matrices(j, env["lam"][1])
    else:
        got, want = ta.force_cell_vectors(t, env["lam"][0]), ja.force_cell_vectors(j, env["lam"][1])
    _close(got, want)


@pytest.mark.parametrize("variant", ["full", "penalty_only", "flux_only_weighted"])
def test_face_blocks(env, variant):
    t, j = env["t"], env["j"]
    kw_t = dict(interior_faces=env["interior"], dirichlet_faces=env["boundary"])
    kw_j = dict(kw_t)
    if variant == "penalty_only":
        kw_t["penalty_only"] = kw_j["penalty_only"] = True
    elif variant == "flux_only_weighted":
        kw_t.update(flux_only=True, weight_lam_fn=env["w"][0], weight_kap_fn=env["kap"][0])
        kw_j.update(flux_only=True, weight_lam_fn=env["w"][1], weight_kap_fn=env["kap"][1])
    ib, bb = tsw.swipdg_face_blocks(t, env["lam"][0], env["kap"][0], **kw_t)
    jib, jbb = jsw.swipdg_face_blocks(j, env["lam"][1], env["kap"][1], **kw_j)
    _close(ib, jib)
    _close(bb, jbb)


@pytest.mark.parametrize("part", ["both", "flux", "penalty"])
def test_dirichlet_rhs(env, part):
    got = tsw.swipdg_dirichlet_rhs(env["t"], env["g"][0], env["boundary"], lam_fn=env["lam"][0],
                                   kap_fn=env["kap"][0], weight_lam_fn=env["w"][0],
                                   weight_kap_fn=env["kap"][0], part=part)
    want = jsw.swipdg_dirichlet_rhs(env["j"], env["g"][1], env["boundary"], lam_fn=env["lam"][1],
                                    kap_fn=env["kap"][1], weight_lam_fn=env["w"][1],
                                    weight_kap_fn=env["kap"][1], part=part)
    _close(got, want)


def test_boundary_functionals_and_jumps(env):
    t, j = env["t"], env["j"]
    _close(ta.boundary_face_functional(t, env["g"][0], env["boundary"]),
           ja.boundary_face_functional(j, env["g"][1], env["boundary"]))
    _close(ta.boundary_face_l2_matrices(t, env["boundary"]),
           ja.boundary_face_l2_matrices(j, env["boundary"]))
    _close(tsw.dg_face_jump_blocks(t, env["interior"]),
           jsw.dg_face_jump_blocks(j, env["interior"]))


def test_error_norms(env):
    u = np.random.default_rng(0).standard_normal(env["t"].num_dofs)
    got = tn.error_norms(env["t"], torch.tensor(u), TExact(), env["lam"][0], env["kap"][0])
    want = jn.error_norms(env["j"], jnp.asarray(u), JExact(), env["lam"][1], env["kap"][1])
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])


@pytest.fixture(scope="module")
def operator(env):
    """(port SparseMatrix, reference SparseMatrix) of the SWIPDG operator."""
    t, j = env["t"], env["j"]
    vol_t = ta.elliptic_cell_matrices(t, env["lam"][0], env["kap"][0])
    vol_j = ja.elliptic_cell_matrices(j, env["lam"][1], env["kap"][1])
    ib, bb = tsw.swipdg_face_blocks(t, env["lam"][0], env["kap"][0], env["interior"],
                                    env["boundary"])
    jib, jbb = jsw.swipdg_face_blocks(j, env["lam"][1], env["kap"][1], env["interior"],
                                      env["boundary"])
    A = tsw.assemble_swipdg_matrix(t, vol_t, ib, bb,
                                   tsw.swipdg_pattern(t, env["interior"], env["boundary"]))
    J = jsw.assemble_swipdg_matrix(j, vol_j, jib, jbb,
                                   jsw.swipdg_pattern(j, env["interior"], env["boundary"]))
    return A, J, (vol_t, ib, bb), (vol_j, jib, jbb)


def test_sparse_matrix_algebra(env, operator):
    A, J = operator[:2]
    _close(A.values, J.values)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0])
    X = rng.standard_normal((A.shape[0], 3))
    _close(A.matvec(torch.tensor(x)), J.matvec(jnp.asarray(x)))
    _close(A.matmat(torch.tensor(X)), J.matmat(jnp.asarray(X)))
    _close(A.diagonal(), J.diagonal())
    _close(A.to_dense(), J.to_dense())
    mask = np.zeros(A.shape[0], dtype=bool)
    mask[[0, 7, 100]] = True
    _close(A.with_constrained_rows(mask, True).with_constrained_cols(mask, True).to_dense(),
           J.with_constrained_rows(mask, True).with_constrained_cols(mask, True).to_dense())


def test_block_ell(env, operator):
    A, J, (vol_t, ib, bb), (vol_j, jib, jbb) = operator
    t, j = env["t"], env["j"]
    B, JB = tbe.block_ell_from_sparse(t, A), jbe.block_ell_from_sparse(j, J)
    np.testing.assert_array_equal(B.neighbors, JB.neighbors)
    _close(B.blocks, JB.blocks)
    built = tbe.build_block_ell(t, vol_t, ib, bb, env["interior"], env["boundary"])
    _close(built.blocks, jbe.build_block_ell(j, vol_j, jib, jbb, env["interior"],
                                             env["boundary"]).blocks)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(A.shape[0])
    _close(B.matvec(torch.tensor(x)), JB.matvec(jnp.asarray(x)))
    _close(B.matvec(torch.tensor(x)), A.matvec(torch.tensor(x)))
    S, b_s, s = tbe.symmetric_diagonal_scaling(B, torch.tensor(x))
    JS, jb_s, js = jbe.symmetric_diagonal_scaling(JB, jnp.asarray(x))
    _close(S.blocks, JS.blocks)
    _close(b_s, jb_s)
    _close(tbe.block_jacobi_preconditioner(S)(torch.tensor(x)),
           jbe.block_jacobi_preconditioner(JS)(jnp.asarray(x)))
    u, res, iters = tbe.block_cg(S, b_s, tol=1e-12, maxiter=2000)
    ju, jres = jbe.block_cg(JS, jb_s, tol=1e-12, maxiter=2000)
    assert float(res) <= 1e-12 and 0 < iters < 2000
    _close(u, ju, rel=1e-10)


def test_structured_layouts(env, operator):
    A, J = operator[:2]
    order, jorder = t_order(env["tg"]), j_order(env["jg"])
    B, JB = tbe.block_ell_from_sparse(env["t"], A), jbe.block_ell_from_sparse(env["j"], J)
    st, jst_ = tbe.StructuredBlockEll.from_block_ell(B, order), \
        jbe.StructuredBlockEll.from_block_ell(JB, jorder)
    np.testing.assert_array_equal(st.neighbors, jst_.neighbors)
    _close(st.blocks, jst_.blocks)
    maps, jmaps = tst.soa_index_maps(order, 3), jst.soa_index_maps(jorder, 3)
    np.testing.assert_array_equal(maps.to_soa, jmaps.to_soa)
    np.testing.assert_array_equal(maps.from_soa, jmaps.from_soa)
    S, JS = tst.StencilBlockEll.from_block_ell(B, order), jst.StencilBlockEll.from_block_ell(
        JB, jorder)
    assert S.plan == JS.plan
    _close(S.planes, JS.planes)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    X = torch.tensor(x)[torch.as_tensor(maps.to_soa, dtype=torch.long)].reshape(
        (3, 8) + tuple(order.lattice))
    y = S.matvec(X).reshape(-1)[torch.as_tensor(maps.from_soa, dtype=torch.long)]
    _close(y, J.matvec(jnp.asarray(x)))
