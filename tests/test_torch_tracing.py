"""The port's spans and counters (``utils/profiling.py``): the span tree and
solve ids, the off path (no ``record_function``, no CUDA event, no
allocation, no counter), the ``hdd::`` spans in a CPU profiler trace and
their reduction by span, and the spans and counters of the three solve
paths the benchmark drives (the SPE10 bench's ``fn``, the SWIPDG snapshot
solve, and the general path's freeze and ``cg.jacobi`` on the Q1 tensor
thermalblock), at small sizes on the CPU."""
from collections import Counter
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.utils import profiling  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import (  # noqa: E402
    count, recording, span, span_breakdown)
from torch_threads import one_torch_thread  # noqa: E402,F401


def test_span_tree_and_solve_ids():
    """Nesting gives each span its parent; a root opens a solve id that its
    descendants share; counts go to the innermost span and the totals."""
    with recording() as rec:
        with span("solve"):
            count("outside")
            with span("pcg"):
                with span("matvec"):
                    count("host.syncs", 2)
                count("host.syncs")
        with span("solve"):
            with span("pcg"):
                count("host.syncs")
    names = [s.name for s in rec.spans]
    assert names == ["solve", "pcg", "matvec", "solve", "pcg"]
    assert [s.parent for s in rec.spans] == [None, 0, 1, None, 3]
    assert [s.solve for s in rec.spans] == [1, 1, 1, 2, 2]
    assert rec.solves() == [1, 2]
    assert rec.path(2) == ("solve", "pcg", "matvec")
    assert rec.spans[2].counts == {"host.syncs": 2} and rec.spans[1].counts == {"host.syncs": 1}
    assert rec.totals == {"outside": 1, "host.syncs": 4}
    assert rec.total("host.syncs", solve=1) == 3 and rec.total("host.syncs", solve=2) == 1
    assert all(s.end_ns >= s.start_ns > 0 and s.device_s is None for s in rec.spans)
    assert profiling.timings()["pcg"] == rec.seconds("pcg")


def _small_pcg():
    from dune_hdd_tpu_torch.la.stencil import jacobi_smoother, stencil_pcg

    S, B = _spd_stencil()
    return stencil_pcg(S, B / torch.linalg.norm(B), jacobi_smoother(S), rtol=1e-8, maxiter=200)


def _spd_stencil():
    """A small SWIPDG stencil system (the thermalblock's, frozen at mu)."""
    disc = _thermalblock(4)
    system = disc.stencil_system(_MU(disc))
    return system.S, system.B


def test_off_records_nothing():
    """Off (the default), a solve opens no record_function, records no CUDA
    event, builds no span object and updates no counter: ``span`` hands out
    one shared no-op context."""
    assert not profiling._ON
    assert span("a") is span("b")
    totals_before = profiling.timings()
    with mock.patch("torch.profiler.record_function") as rf, \
            mock.patch("torch.cuda.Event") as event, \
            mock.patch.object(profiling, "_Open") as opened, \
            mock.patch.object(profiling, "Record") as record:
        _, iters = _small_pcg()
    assert iters > 0
    rf.assert_not_called()
    event.assert_not_called()
    opened.assert_not_called()
    record.assert_not_called()
    assert profiling._REC is None and profiling.timings() == totals_before


def test_spans_hold_their_aten_ops_under_cpu_profiler():
    """While recording under the profiler each span is an ``hdd::`` interval
    of the trace that holds the aten ops called inside it; the reduction
    by span finds no device operation on the CPU."""
    P = torch.profiler.ProfilerActivity
    x = torch.ones(64, 64)
    with recording(), torch.profiler.profile(activities=[P.CPU]) as prof:
        with span("outer"):
            y = x * 2.0
            with span("inner"):
                y = torch.mm(y, y)
    events = prof.profiler.kineto_results.events()
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.name().startswith("hdd::")}
    assert set(spans) == {"hdd::outer", "hdd::inner"}
    (o0, o1), (i0, i1) = spans["hdd::outer"], spans["hdd::inner"]
    assert o0 <= i0 <= i1 <= o1
    mms = [e for e in events if e.name() == "aten::mm"]
    muls = [e for e in events if e.name() == "aten::mul"]
    assert mms and muls
    assert all(i0 <= e.start_ns() <= e.end_ns() <= i1 for e in mms)
    assert all(o0 <= e.start_ns() <= e.end_ns() <= o1 and not i0 <= e.start_ns() <= i1
               for e in muls)
    bd = span_breakdown(events)
    assert bd.device_ops == 0 and bd.busy_s == 0.0
    assert sum(bd.idle_s.values()) == pytest.approx(bd.window_s)
    assert float(y[0, 0]) == 64 * 4.0


class _Event(SimpleNamespace):
    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def name(self):
        return self.label

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


def _ev(label, t0, t1, cuda=False, corr=0, link=0):
    return _Event(label=label, t0=t0, t1=t1, cuda=cuda, corr=corr, link=link)


def test_span_breakdown_attributes_launches_and_idle():
    """Each device operation goes to the spans around its launch (by the
    runtime call of its correlation id, else the op it is linked to); each
    idle stretch to the spans around its midpoint; idle adds up to window
    less busy, and a span's device-side annotation is not an operation."""
    events = [
        _ev("hdd::solve", 0, 1000), _ev("hdd::pcg", 100, 900), _ev("hdd::matvec", 200, 300),
        _ev("cudaLaunchKernel", 210, 220, corr=7),     # in matvec
        _ev("aten::add", 400, 450, corr=3),            # in pcg, linked
        _ev("cudaLaunchKernel", 950, 960, corr=8),     # in solve only
        _ev("spmv", 250, 500, cuda=True, corr=7),
        _ev("add", 500, 520, cuda=True, corr=99, link=3),
        _ev("copy", 970, 990, cuda=True, corr=8),
        _ev("orphan", 600, 610, cuda=True, corr=55),
        _ev("hdd::matvec", 250, 500, cuda=True),       # gpu_user_annotation: skipped
    ]
    bd = span_breakdown(events)
    assert bd.ops == {("solve", "pcg", "matvec"): 1, ("solve", "pcg"): 1, ("solve",): 1,
                      (): 1}
    assert bd.device_s[("solve", "pcg", "matvec")] == pytest.approx(250e-9)
    assert bd.device_ops == 4
    assert bd.window_s == pytest.approx(1000e-9)
    assert bd.busy_s == pytest.approx((270 + 10 + 20) * 1e-9)
    assert sum(bd.idle_s.values()) == pytest.approx(bd.window_s - bd.busy_s)
    # gaps: [0, 250) mid 125 in pcg, [520, 600) and [610, 970) in pcg, [990, 1000) in solve
    assert bd.idle_s[("solve", "pcg")] == pytest.approx((250 + 80 + 360) * 1e-9)
    assert bd.idle_s[("solve",)] == pytest.approx(10e-9)


# -- the two solve paths ------------------------------------------------------


def _MU(disc):
    from dune_hdd_tpu_torch.parameters import parse_parameter

    return parse_parameter(np.array([0.1, 0.5, 1.0, 0.3]), disc.parameter_type)


def _thermalblock(bisections):
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    grid = alu_cube_grid((0.0, 0.0), (1.0, 1.0), (4, 4), refinements=bisections)
    return SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                ThermalblockProblem((2, 2)), only_these_products=(),
                                device="cpu")


def _checks(iterations, unroll, maxiter):
    """The PCG's convergence reads: one before each block of ``unroll``
    iterations, and the last one that stops it (none past ``maxiter``)."""
    return iterations // unroll + (1 if iterations < maxiter else 0)


def _spe10():
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    bench = build_spe10_bench(bisections=4, device="cpu")
    bench.fn(bench.field)  # the masks of the coarse bands are copied once per lattice
    with recording() as rec:
        sol = bench.fn(bench.field * 1.25)
    st = bench.settings
    per_pcg = [_checks(s.counts["pcg.iterations"], st.unroll, st.inner_iters)
               for s in rec.spans if s.name == "pcg"]
    # the two-level coarse solve: block cyclic reduction over the padded
    # macro columns (one inverse per level, one solve at the last), inside
    # the deflation build's own span
    mx = 100
    build = (1 << (mx - 1).bit_length()).bit_length()
    expected = {"pcg": sum(per_pcg), "refine.residual": sol.sweeps, "solve": 1,
                "deflation.build": build}
    tree = {("solve",), ("solve", "assemble"), ("solve", "precond.build"),
            ("solve", "precond.build", "deflation.build"), ("solve", "pcg"),
            ("solve", "pcg", "matvec"), ("solve", "pcg", "precond.apply"),
            ("solve", "refine.residual"), ("solve", "refine.residual", "matvec")}
    return rec, sol.iterations, sol.sweeps, expected, tree


def _snapshot():
    disc = _thermalblock(4)
    opts = {"type": "stencil_cg", "precision": 1e-8, "max_iter": 10000}
    disc.uncached_solve(_MU(disc), opts)  # the block-ELL slot map is found once per pattern
    with recording() as rec:
        disc.uncached_solve(_MU(disc), opts)
    iters = disc.last_solve_info["iterations"]
    # the freeze copies the SoA maps and the structured gather's indices
    expected = {"pcg": _checks(iters, 4, opts["max_iter"]), "freeze": 4}
    tree = {("solve",), ("solve", "freeze"), ("solve", "precond.build"), ("solve", "pcg"),
            ("solve", "pcg", "matvec"), ("solve", "pcg", "precond.apply")}
    return rec, iters, 1, expected, tree


_PATHS = {"spe10_stencil2": _spe10, "snapshot": _snapshot}


@pytest.fixture(scope="module", params=sorted(_PATHS))
def solved(request):
    return _PATHS[request.param]()


def test_solve_gives_the_span_tree(solved):
    """One solve: one root ``solve`` span, one solve id, the layers of the
    path under it, and a matvec and a preconditioner application per
    iteration."""
    rec, iters, sweeps, _, tree = solved
    paths = Counter(rec.path(i) for i in range(len(rec.spans)))
    assert set(paths) == tree
    assert paths[("solve",)] == 1 and rec.solves() == [1]
    assert paths[("solve", "pcg")] == sweeps
    assert paths[("solve", "pcg", "matvec")] == iters
    assert paths[("solve", "pcg", "precond.apply")] == iters + sweeps


def test_pcg_iterations_add_up_to_the_solve(solved):
    rec, iters, _, _, _ = solved
    assert rec.total("pcg.iterations") == iters
    assert sum(s.counts["pcg.iterations"] for s in rec.spans if s.name == "pcg") == iters


def test_host_syncs_match_the_solve(solved):
    """``host.syncs`` by span: the PCG's convergence reads from its
    iterations and ``unroll``, one residual norm per refinement sweep and
    the rhs norm, the build's inverses, the freeze's copies."""
    rec, _, _, expected, _ = solved
    by_span = Counter()
    for s in rec.spans:
        if s.counts and "host.syncs" in s.counts:
            by_span[s.name] += s.counts["host.syncs"]
    assert dict(by_span) == expected
    assert rec.total("host.syncs") == sum(expected.values())


def test_cpu_solve_takes_no_graph(solved):
    """On the CPU the PCG runs op by op: no graph is captured or replayed."""
    rec, _, _, _, _ = solved
    assert not [name for name in rec.totals if name.startswith("pcg.graph.")]
    assert not rec.seconds("pcg.graph.capture")


def test_host_syncs_refuse_a_graph_capture():
    """While the current CUDA stream captures a graph (patched: no capture
    runs on the CPU), a read of a device value and a copy to the device
    raise ``SyncInCapture`` before they wait or count; outside one they run."""
    with recording() as rec:
        with mock.patch("torch.cuda.is_available", return_value=True), \
                mock.patch("torch.cuda.is_current_stream_capturing", return_value=True):
            with pytest.raises(profiling.SyncInCapture):
                profiling.host_read(torch.ones(()))
            with pytest.raises(profiling.SyncInCapture):
                profiling.upload([1.0, 2.0], "cpu")
        assert rec.total("host.syncs") == 0
        assert profiling.host_read(torch.ones(())) == 1.0
        assert profiling.upload([1.0, 2.0], "cpu").tolist() == [1.0, 2.0]
    assert rec.total("host.syncs") == 2


def test_captured_counts_count_at_each_replay():
    """Counts made while a graph is captured stay out of the record; each
    replay adds them, on the span open then."""
    with recording() as rec:
        with span("pcg"):
            with profiling.captured_counts() as counts:
                count("kernel.a")
                count("kernel.a")
                count("kernel.b", 3)
            assert rec.totals == {}
            for _ in range(3):
                for name, n in counts.items():
                    count(name, n)
    assert counts == {"kernel.a": 2, "kernel.b": 3}
    assert rec.totals == {"kernel.a": 6, "kernel.b": 9}
    assert rec.spans[0].counts == rec.totals


# -- the general path: Q1 tensor CG and la/solvers.cg --------------------------

_CG_OPTS = {"type": "cg.jacobi", "precision": 1e-10, "max_iter": 20000}
_MU3D = np.array([0.1, 1.0, 0.5, 0.2, 0.9, 0.3, 0.7, 0.45])


@pytest.fixture(scope="module")
def thermalblock_3d():
    from dune_hdd_tpu_torch.cli.examples import ThermalblockExample
    from dune_hdd_tpu_torch.parameters import parse_parameter

    disc = ThermalblockExample(device="cpu").initialize_tensor(
        dim=3, num_elements=6, num_blocks=(2, 2, 2)).discretization()
    return disc, parse_parameter(_MU3D, disc.parameter_type)


@pytest.fixture(scope="module")
def cg_solved(thermalblock_3d):
    disc, mu = thermalblock_3d
    with recording() as rec:
        u = disc.uncached_solve(mu, _CG_OPTS)
    return rec, u, disc.last_solve_info["iterations"]


def test_cg_solve_gives_the_span_tree(cg_solved):
    """One general solve: ``solve`` holds the ``freeze`` of the 8 sparse
    components and the ``cg``, which holds a ``matvec`` and a
    ``precond.apply`` per executed iteration (blocks of ``CHECK_EVERY``,
    the last ones masked) and one more for the initial residual."""
    from dune_hdd_tpu_torch.la.solvers import CHECK_EVERY

    rec, _, iters = cg_solved
    paths = Counter(rec.path(i) for i in range(len(rec.spans)))
    executed = -(-iters // CHECK_EVERY) * CHECK_EVERY
    assert paths == {("solve",): 1, ("solve", "freeze"): 1, ("solve", "cg"): 1,
                     ("solve", "cg", "matvec"): executed + 1,
                     ("solve", "cg", "precond.apply"): executed + 1}
    assert rec.solves() == [1]
    freeze = next(s for s in rec.spans if s.name == "freeze")
    assert freeze.counts == {"freeze.components": 16}  # the operator's 8 and the rhs's 8


def test_cg_counts_its_iterations_and_host_reads(cg_solved):
    """``cg.iterations`` is the solve's count; ``host.syncs`` on the ``cg``
    span are the stopping test's reads, one before each block of
    ``CHECK_EVERY`` and the one that stops it, and the read of the count."""
    from dune_hdd_tpu_torch.la.solvers import CHECK_EVERY

    rec, _, iters = cg_solved
    assert 0 < iters < _CG_OPTS["max_iter"]
    assert rec.total("cg.iterations") == iters
    cg = next(s for s in rec.spans if s.name == "cg")
    assert cg.counts == {"cg.iterations": iters, "host.syncs": -(-iters // CHECK_EVERY) + 2}
    assert rec.total("host.syncs") == cg.counts["host.syncs"]


def test_cg_off_records_nothing_and_solves_alike(thermalblock_3d, cg_solved):
    """Off, the general solve opens no span and counts nothing, and its
    answer is bitwise the recorded one's."""
    disc, mu = thermalblock_3d
    _, u_on, iters = cg_solved
    with mock.patch.object(profiling, "_Open") as opened, \
            mock.patch.object(profiling, "Record") as record:
        u_off = disc.uncached_solve(mu, _CG_OPTS)
    opened.assert_not_called()
    record.assert_not_called()
    assert profiling._REC is None
    assert disc.last_solve_info["iterations"] == iters
    assert torch.equal(u_off, u_on)


def test_bicgstab_counts_its_iterations(thermalblock_3d):
    from dune_hdd_tpu_torch.la.solvers import bicgstab, make_preconditioner

    disc, mu = thermalblock_3d
    A, b = disc.freeze_operator(mu), disc.freeze_rhs(mu)
    with recording() as rec:
        _, iters = bicgstab(A.matvec, b, tol=1e-8, M=make_preconditioner(A, "jacobi"))
    assert iters > 0 and rec.total("bicgstab.iterations") == iters
    assert [s.name for s in rec.spans if s.parent is None] == ["bicgstab"]
