"""The bench's set-up (``bench_harness._bench_geometry``) and its float64
operator: the static channel coefficient evaluated on the bench's device
(``_channel_coefficient``) is bitwise the host evaluation it replaced
(``_host_coefficient`` below, kept as its plain version), at 2, 4 and 6
bisections on the CPU and, in the ``cuda`` case, at 8 bisections on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_bench_geometry.py``);
one set-up records each of its ``bench.geometry.*`` phases once; the
assembly one subclass at a time is the batched one, and from 10 bisections
the bench refines against the float64 operator whose float32 rounding its
PCG applies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch import bench_harness as bh  # noqa: E402
from dune_hdd_tpu_torch.bench_harness import (  # noqa: E402
    _bench_geometry,
    _channel_coefficient,
    _diffusion_factor,
    _solver_settings,
    build_spe10_bench,
)
from dune_hdd_tpu_torch.functions.base import IndicatorFunction  # noqa: E402
from dune_hdd_tpu_torch.grid.boundaryinfo import make_boundary_info  # noqa: E402
from dune_hdd_tpu_torch.grid.structured import alu_cube_grid  # noqa: E402
from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order  # noqa: E402
from dune_hdd_tpu_torch.la.stencil_assembly import (  # noqa: E402
    assemble_scaled_by_subclass,
    assemble_structured_spe10,
    assembly_tensors,
    build_structured_assembly,
    precompute_coefficient,
    scale_planes,
    structured_rhs,
)
from dune_hdd_tpu_torch.utils.profiling import profile_report, recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PHASES = ["grid", "order", "plan", "coefficient", "tensors", "soa_maps", "check"]


def _host_coefficient(plan, lam_fn, dtype=np.float32):
    """The coefficient as the bench evaluated it before: ``lam_fn`` in
    float64 on host tensors, box by box, then cast to ``dtype``."""
    fams = [plan.families[k][s] for k in range(8) for s in range(3)]

    def ev(points):
        return lam_fn(torch.from_numpy(points)).numpy().astype(dtype)

    return (ev(plan.vol_qp), ev(np.stack([f.qp_m for f in fams])),
            ev(np.stack([f.qp_p for f in fams])))


def _plan(bisections):
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=bisections)
    binfo = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    return build_structured_assembly(grid, structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0)),
                                     binfo)


def _assert_bitwise(pre, want):
    for got, ref in zip(pre, want):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("bisections", [2, 4, 6])
def test_coefficient_on_the_device_is_the_host_loop_bitwise(bisections):
    plan = _plan(bisections)
    want = _host_coefficient(plan, _diffusion_factor())
    _assert_bitwise(_channel_coefficient(plan, torch.device("cpu")), want)
    if bisections == 2:  # the library's own host evaluation
        _assert_bitwise(precompute_coefficient(plan, _diffusion_factor()), want)
    # the channel reaches the points of every array
    assert all((w != 1.0).any() and (w == 1.0).any() for w in want)


def test_set_up_records_each_phase_once():
    _bench_geometry.cache_clear()
    with recording() as rec:
        geo = _bench_geometry(2, torch.device("cpu"))
    names = [s.name for s in rec.spans]
    assert sorted(names) == sorted(f"bench.geometry.{p}" for p in PHASES)
    assert all(s.parent is None and s.end_ns >= s.start_ns for s in rec.spans)
    report = profile_report()
    assert all(f"bench.geometry.{p}" in report for p in PHASES)
    assert geo.order.lattice == (20, 100)
    with recording() as rec:  # a second bench at the size shares the set-up
        assert _bench_geometry(2, torch.device("cpu")) is geo
    assert rec.spans == []


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("bisections", [2, 4])
def test_assembly_by_subclass_is_the_batched_one(bisections):
    plan = _plan(bisections)
    T = assembly_tensors(plan, _channel_coefficient(plan, torch.device("cpu"), np.float64),
                         torch.device("cpu"), torch.float64)
    KY, KX = plan.lattice
    field = torch.rand((8, KY, KX), dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    field = 10.0 ** (6.0 * field - 3.0)  # the traffic's contrast
    force = IndicatorFunction(bh._FORCES)
    want = scale_planes(assemble_structured_spe10(T, field), structured_rhs(T, force))
    got = assemble_scaled_by_subclass(T, field, structured_rhs(T, force))
    assert got[0].planes.dtype == torch.float64 and got[0].plan == want[0].plan
    for g, w in zip((got[0].planes, got[1], got[2]), (want[0].planes, want[1], want[2])):
        assert g.shape == w.shape and _rel(g, w) < 1e-14


@pytest.mark.parametrize("bisections", [2, 8, 10, 12])
def test_operator_in_float64_from_ten_bisections(bisections):
    lattice = (10 << (bisections // 2), 50 << (bisections // 2))
    assert _solver_settings(bisections, lattice).operator64 == (bisections >= 10)


def test_bench_refines_against_the_float64_operator(monkeypatch):
    """The float64 path of 10 bisections and more, taken at 2: the PCG's
    operator is the float64 assembly's rounding, the refinement's (and
    ``astype(float64)``'s) the float64 planes themselves."""
    field = torch.as_tensor(bh._synthetic_model1_field(), dtype=torch.float32)
    base = build_spe10_bench(2, device="cpu")
    S32, B32, s32 = base.assemble(field)
    assert S32.planes64 is None and base.settings.operator64 is False
    settings = bh._solver_settings
    monkeypatch.setattr(bh, "_solver_settings",
                        lambda b, lat: settings(b, lat)._replace(operator64=True))
    bench = build_spe10_bench(2, device="cpu")
    S, B, s = bench.assemble(field)
    assert S.planes.dtype == B.dtype == s.dtype == torch.float32
    assert S.planes64.dtype == torch.float64
    assert torch.equal(S.planes, S.planes64.to(torch.float32))
    assert S.astype(torch.float64).planes is S.planes64
    assert S.symmetrized().astype(torch.float64).planes is S.planes64
    assert _rel(S.planes64, S32.planes.double()) < 1e-5  # the float32 assembly's roundoff
    assert _rel(s.double(), s32.double()) < 1e-6 and _rel(B.double(), B32.double()) < 1e-6
    sol, sol32 = bench.fn(field), base.fn(field)
    assert sol.residual <= 1e-6 and sol32.residual <= 1e-6
    # the answer solves the float64 system; the two answers differ by the
    # float32 assembly's roundoff times the condition
    X = (sol.u[bench.to_soa] / s.double().reshape(-1)).reshape(B.shape)
    B64 = B.double()
    assert _rel(S.astype(torch.float64).matvec(X), B64) <= 1e-6
    assert _rel(sol.u, sol32.u) < 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_coefficient_on_the_card_is_the_host_loop_bitwise(cuda_device):
    plan = _plan(8)
    _assert_bitwise(_channel_coefficient(plan, cuda_device),
                    _host_coefficient(plan, _diffusion_factor()))
