"""BlockSWIPDG of the PyTorch port against the JAX package's (x64, CPU), on
the ESV2007 4x4 grid at 2 bisections (384 DoF), [2 2] and [4 1]
partitionings, 2 oversampling layers:

* the partition tables (cells, inner / coupling / boundary faces,
  neighbours, oversampled cells, diameters) equal the reference exactly;
* every local operator, local rhs, local product and coupling block
  (densified) equals the reference's to 1e-12 relative, for the
  nonparametric ESV2007 problem and the parametric OS2014 problem under both
  schemes, at mu in {1, 0.3};
* the sum of locals and couplings equals the global operator and rhs to
  1e-12; the block solution equals SWIPDGDiscretization's to 1e-10;
* localize / globalize round-trip, bad input raises ValueError, and the
  online enrichment equals the reference's correction to 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization as JB  # noqa: E402
from dune_hdd_tpu.grid.multiscale import MultiscaleGrid as JMS  # noqa: E402
from dune_hdd_tpu.grid.multiscale import extract_subgrid as j_extract_subgrid  # noqa: E402
from dune_hdd_tpu.grid.structured import alu_cube_grid as j_grid  # noqa: E402
from dune_hdd_tpu.problems import ESV2007Problem as JESV  # noqa: E402
from dune_hdd_tpu.problems import ParametricESV2007Problem as JOS  # noqa: E402
from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization as TD  # noqa: E402
from dune_hdd_tpu_torch.discretizations.block_swipdg import (  # noqa: E402
    BlockSWIPDGDiscretization as TB,
    CouplingOperator,
)
from dune_hdd_tpu_torch.grid.multiscale import MultiscaleGrid as TMS  # noqa: E402
from dune_hdd_tpu_torch.grid.multiscale import Subgrid, extract_subgrid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid as t_grid  # noqa: E402
from dune_hdd_tpu_torch.problems import ESV2007Problem as TESV  # noqa: E402
from dune_hdd_tpu_torch.problems import ParametricESV2007Problem as TOS  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BI = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
PARTS = [(2, 2), (4, 1)]
CASES = [("esv2007", None), ("os2014", "reference"), ("os2014", "penalty_mu")]
BLOCKS = ("in_in", "in_out", "out_in", "out_out")


def _grids():
    return (j_grid((-1, -1), (1, 1), (4, 4), refinements=2),
            t_grid((-1, -1), (1, 1), (4, 4), refinements=2))


_BUILT = {}


def _pair(problem, scheme, part, layers=2):
    """(reference block discretization, port block discretization)."""
    key = (problem, scheme, part, layers)
    if key not in _BUILT:
        jg, tg = _grids()
        jp, tp = (JESV(), TESV()) if problem == "esv2007" else (JOS(), TOS())
        _BUILT[key] = (JB(jg, BI, jp, num_partitions=part, oversampling_layers=layers,
                          scheme=scheme),
                       TB(tg, BI, tp, num_partitions=part, oversampling_layers=layers,
                          scheme=scheme, device="cpu"))
    return _BUILT[key]


def _mus(problem):
    """[(reference parameter, port parameter)] to freeze at."""
    if problem == "esv2007":
        return [({}, {})]
    return [({"mu": jnp.asarray([m])}, {"mu": torch.tensor([m], dtype=torch.float64)})
            for m in (1.0, 0.3)]


def _close(a, b, rel=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("part", PARTS)
def test_partition_tables_match_reference(part):
    jg, tg = _grids()
    jm, tm = JMS(jg, part, 2), TMS(tg, part, 2)
    assert tm.size() == jm.size()
    np.testing.assert_array_equal(tm.subdomain_of, jm.subdomain_of)
    np.testing.assert_array_equal(tm.boundary_subdomains(), jm.boundary_subdomains())
    for ss in range(tm.size()):
        for name in ("cells", "inner_faces", "boundary_faces", "neighbors_of",
                     "oversampled_cells"):
            np.testing.assert_array_equal(getattr(tm, name)(ss), getattr(jm, name)(ss), name)
        assert tm.subdomain_diameter(ss) == jm.subdomain_diameter(ss)
        np.testing.assert_array_equal(tm.subdomain_table[ss][:len(tm.cells(ss))], tm.cells(ss))
        for nn in range(tm.size()):
            np.testing.assert_array_equal(tm.coupling_faces(ss, nn), jm.coupling_faces(ss, nn))
    for ss in (0, tm.size() - 1):
        tsub, jsub = extract_subgrid(tg, tm.cells(ss)), j_extract_subgrid(jg, jm.cells(ss))
        np.testing.assert_array_equal(tsub.grid.cells, jsub.grid.cells)
        np.testing.assert_array_equal(tsub.grid.vertices, jsub.grid.vertices)
        np.testing.assert_array_equal(tsub.vertex_map, jsub.vertex_map)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("problem,scheme", CASES)
def test_local_and_coupling_blocks_match_reference(problem, scheme, part):
    jd, td = _pair(problem, scheme, part)
    assert td._scheme == jd._scheme
    for jmu, tmu in _mus(problem):
        for ss in range(td.num_subdomains()):
            _close(td.get_local_operator(ss).freeze(tmu).to_dense(),
                   jd.get_local_operator(ss).freeze(jmu).to_dense())
            _close(td.get_local_rhs(ss).freeze(tmu), jd.get_local_rhs(ss).freeze(jmu))
            for name in ("l2", "h1_semi", "energy"):
                _close(td.get_local_product(ss, name).freeze(tmu).to_dense(),
                       jd.get_local_product(ss, name).freeze(jmu).to_dense())
            for nn in td.neighbouring_subdomains(ss):
                tc = td.get_coupling_operator(ss, int(nn)).freeze(tmu)
                jc = jd.get_coupling_operator(ss, int(nn)).freeze(jmu)
                assert isinstance(tc, CouplingOperator)
                for b in BLOCKS:
                    _close(getattr(tc, b).to_dense(), getattr(jc, b).to_dense())


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("problem,scheme", CASES)
def test_sum_of_blocks_equals_global(problem, scheme, part):
    _, d = _pair(problem, scheme, part)
    for _, mu in _mus(problem):
        A = d.freeze_operator(mu).to_dense().numpy()
        B = np.zeros_like(A)
        b = np.zeros(A.shape[0])
        for ss in range(d.num_subdomains()):
            ds = d._local_dof_map(ss)
            B[np.ix_(ds, ds)] += d.get_local_operator(ss).freeze(mu).to_dense().numpy()
            b[ds] += d.get_local_rhs(ss).freeze(mu).numpy()
            for nn in d.neighbouring_subdomains(ss):
                if nn <= ss:
                    continue
                c = d.get_coupling_operator(ss, int(nn)).freeze(mu)
                dn = d._local_dof_map(int(nn))
                for b_name, rows, cols in (("in_in", ds, ds), ("in_out", ds, dn),
                                           ("out_in", dn, ds), ("out_out", dn, dn)):
                    B[np.ix_(rows, cols)] += getattr(c, b_name).to_dense().numpy()
        _close(B, A)
        _close(b, d.freeze_rhs(mu))


@pytest.mark.parametrize("options", [{"type": "direct"},
                                     {"type": "stencil_cg", "precision": 1e-13}])
def test_block_solution_equals_swipdg(options):
    _, d = _pair("esv2007", None, (2, 2))
    single = TD(d.space.grid, BI, TESV(), device="cpu")
    u_s = single.solve(options={"type": "direct"})
    u_b = d.solve(options=options)
    assert d.last_solve_info["type"] == options["type"]
    _close(u_b, u_s, rel=1e-10)


def test_os2014_block_solution_matches_reference():
    jd, td = _pair("os2014", "reference", (4, 1))
    u = td.solve(0.3, options={"type": "direct"})
    _close(u, jd.solve(jd.problem.parse_parameter(0.3), options={"type": "direct"}), rel=1e-10)


def test_localize_globalize_roundtrip_and_validation():
    _, d = _pair("esv2007", None, (4, 1))
    u = d.solve(options={"type": "direct"})
    locals_ = [d.localize_vector(u, ss) for ss in range(d.num_subdomains())]
    assert sum(lv.shape[0] for lv in locals_) == d.space.num_dofs
    assert torch.equal(d.globalize_vectors(locals_), u)
    with pytest.raises(ValueError, match="NaN"):
        d.localize_vector(torch.full((d.space.num_dofs,), float("nan")), 0)
    with pytest.raises(ValueError, match="length"):
        d.localize_vector(torch.zeros(3), 0)
    with pytest.raises(ValueError, match="not neighbours"):
        d.get_coupling_operator(0, 3)
    with pytest.raises(ValueError):
        d.solve_for_local_correction(locals_[:2], 0)
    bad = [lv.clone() for lv in locals_]
    bad[1][0] = float("inf")
    with pytest.raises(ValueError, match="NaN or Inf"):
        d.solve_for_local_correction(bad, 0)


def test_oversampled_discretization():
    """The patch of the reference's BFS oversampling, discretized with the
    artificial boundary type asked for."""
    jd, td = _pair("esv2007", None, (2, 2))
    to = td.get_oversampled_discretization(0, "dirichlet")
    patch = to.oversampled_patch
    np.testing.assert_array_equal(patch.cell_map, jd.ms_grid.oversampled_cells(0))
    assert patch.grid.num_cells > len(td.ms_grid.cells(0))
    direct = TD(patch.grid, BI, TESV(), only_these_products=(), device="cpu")
    _close(to.freeze_operator({}).to_dense(), direct.freeze_operator({}).to_dense())
    neumann = td.get_oversampled_discretization(0, "neumann")
    assert not neumann.boundary_info.dirichlet_faces.any()
    np.testing.assert_array_equal(neumann.oversampled_patch.cell_map, patch.cell_map)
    with pytest.raises(ValueError):
        td.get_oversampled_discretization(0, "bogus")
    plain = TB(_grids()[1], BI, TESV(), num_partitions=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="oversampling"):
        plain.get_oversampled_discretization(0, "dirichlet")
    with pytest.raises(ValueError, match="oversampling"):
        plain.solve_for_local_correction([], 0)


def test_online_enrichment_matches_reference():
    """A bump strictly inside subdomain 0 is removed by the oversampled-patch
    correction (>= 80%, the reference test's bar), equal to the reference's
    correction."""
    jd, td = _pair("esv2007", None, (2, 2))
    u_star = jd.solve(options={"type": "direct"})
    grid = td.space.grid
    c = grid.cell_centroids
    bump = np.nonzero((c[:, 0] < -0.45) & (c[:, 1] < -0.45) & (c[:, 0] > -0.9)
                      & (c[:, 1] > -0.9))[0]
    assert set(td.ms_grid.subdomain_of[bump].tolist()) == {0}
    pert = np.zeros(td.space.num_dofs)
    for cell in bump:
        pert[cell * 3:(cell + 1) * 3] = 0.3
    u_star = np.array(u_star)
    u = u_star + pert
    j_locals = [jd.localize_vector(jnp.asarray(u), ss) for ss in range(4)]
    t_locals = [td.localize_vector(torch.as_tensor(u), ss) for ss in range(4)]
    delta = td.solve_for_local_correction(t_locals, 0)
    _close(delta, jd.solve_for_local_correction(j_locals, 0), rel=1e-10)
    exact0 = td.localize_vector(torch.as_tensor(u_star), 0)
    before = float(torch.linalg.norm(t_locals[0] - exact0))
    after = float(torch.linalg.norm(t_locals[0] + delta - exact0))
    assert after < 0.2 * before, (before, after)


def test_coupling_operator_arithmetic_is_blockwise():
    _, d = _pair("os2014", "penalty_mu", (2, 2))
    dec = d.get_coupling_operator(0, 1)
    a, b = dec.components[0], dec.affine_part
    s = 0.5 * a + b * 2.0
    for name in BLOCKS:
        expect = 0.5 * getattr(a, name).values + 2.0 * getattr(b, name).values
        assert torch.equal(getattr(s, name).values, expect)
        assert getattr(s, name).pattern is getattr(a, name).pattern is getattr(b, name).pattern


def test_missing_subgrid_face_raises_value_error():
    """A subgrid face that is not a face of the grid, here past the last
    global key (searchsorted returns the length there), is reported."""
    _, d = _pair("esv2007", None, (2, 2))
    sub = d.subgrid(0)
    nv = d.space.grid.num_vertices
    d._subgrids[0] = Subgrid(sub.grid, sub.cell_map, np.full_like(sub.vertex_map, nv - 1))
    try:
        with pytest.raises(ValueError, match="is not a face of the grid"):
            d._boundary_face_map(0)
        d._subgrids[0] = Subgrid(sub.grid, sub.cell_map, sub.vertex_map[::-1].copy())
        with pytest.raises(ValueError, match="is not a face of the grid"):
            d._boundary_face_map(0)
    finally:
        d._subgrids[0] = sub


def test_sharded_layout_not_ported():
    """The sharded layout, once a raise here, is ported: the subdomain row
    blocks and the halo system's exchange plan and values equal the
    reference's, and the row-split layout pads as it does."""
    from dune_hdd_tpu.parallel import make_device_mesh as j_mesh
    from dune_hdd_tpu_torch.parallel import make_device_mesh

    jd, d = _pair("esv2007", None, (2, 2))
    for n in (2, 4, 8):
        for a, b in zip(d.subdomain_row_blocks(n), jd.subdomain_row_blocks(n)):
            np.testing.assert_array_equal(a, b)
    mesh = make_device_mesh(1, 4, devices=["cpu"] * 4)
    system = d.as_sharded(mesh, dtype=torch.float64)
    ref = jd.as_sharded(j_mesh(1, 4, devices=jax.devices()[:4]), dtype=jnp.float64)
    np.testing.assert_array_equal(system.plan.cols_ext, ref.plan.cols_ext)
    assert system.plan.shifts == ref.plan.shifts
    _close(torch.stack(system.ell_vals[0], dim=1).numpy(), np.asarray(ref.ell_vals))
    rowsplit = d.as_sharded(mesh, dtype=torch.float64, halo=False)
    assert rowsplit.n_pad == jd.as_sharded(j_mesh(1, 4, devices=jax.devices()[:4]),
                                           dtype=jnp.float64, halo=False).n_pad
