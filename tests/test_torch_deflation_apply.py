"""The fine level of the deflation apply (kernels/deflation_apply.py) and
``stencil_deflation_preconditioner`` on it (la/stencil.py).

On the CPU: the apply built from the plain passes is bitwise the closures
the preconditioner ran before the kernels (``_old_apply`` below), at nd 3 /
6 / 10 in float32 and float64, with the x-major and the [my, mx] coarse
layouts, fx = 1 and fx >= 2, lattices narrower than the slot shifts, the
default block-Jacobi smoother and a caller's; on assembled operators through
``stencil_deflation_preconditioner`` (the thermalblock SWIPDG in float64
two- and three-level, the SPE10 bench in float32); a plan whose slot map is
not a bijection raises at build time.  The kernels' index arithmetic is
replayed here in numpy on integer data, where every order of summation is
exact: the aggregate sums' two launches under ``sum_geometry`` (each
site counted once, the coarse layouts), the target-side gather of Z_w^T A S
and the residual's shifted coarse reads.  The ``cuda`` tests hold the kernels
to the plain versions on the card (the residual and combine bitwise, the
aggregate sums within a stated bar, two runs bitwise equal), count the
passes in a graphed solve and hold the OS2014 solve's iterations to the plain
apply's (``python -m pytest --noconftest -m cuda tests/test_torch_deflation_apply.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.kernels import deflation_apply as mod  # noqa: E402
from dune_hdd_tpu_torch.la import stencil as pt  # noqa: E402
from dune_hdd_tpu_torch.utils.profiling import recording  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

DTYPES = [torch.float32, torch.float64]
NDS = [3, 6, 10]
# the relative bars of the aggregate sums on the card against the plain
# versions, max |kernel - plain| / max |plain| (measured in PERF.md)
SUM_BAR = {torch.float32: 1e-5, torch.float64: 1e-13}


def _old_apply(AZ, weight, agg, plan, coarse, smoother):
    """The deflation apply as ``stencil_deflation_preconditioner`` ran it
    before the kernels: its closures ``wsum``, ``wbcast``, ``a_broadcast``
    and ``zt_a``."""

    def wsum(R):
        return agg.aggsum(R * weight)

    def wbcast(yc):
        return agg.broadcast(yc)[None] * weight

    def a_broadcast(yc):
        B0 = agg.broadcast(yc)
        out = AZ[0] * B0[None]
        for s in range(3):
            Bs = torch.stack([torch.roll(B0[ks], shifts=(-dy, -dx), dims=(0, 1))
                              for ks, dy, dx in (plan[k][s] for k in range(8))])
            out = out + AZ[s + 1] * Bs[None]
        return out

    def zt_a(Svec):
        total = (AZ[0] * Svec).sum(dim=0)
        for s in range(3):
            Ps = (AZ[s + 1] * Svec).sum(dim=0)
            out_k = [None] * 8
            for k in range(8):
                ks, dy, dx = plan[k][s]
                contrib = torch.roll(Ps[k], shifts=(dy, dx), dims=(0, 1))
                out_k[ks] = contrib if out_k[ks] is None else out_k[ks] + contrib
            if any(o is None for o in out_k):
                raise ValueError("stencil plan slot map is not bijective")
            total = total + torch.stack(out_k)
        return agg.aggsum(total)

    def apply(R):
        yc = coarse(wsum(R))
        s = smoother(R - a_broadcast(yc))
        return wbcast(yc) + s - wbcast(coarse(zt_a(s)))

    return apply


# -- random operators -----------------------------------------------------------


def _plan(rng, shift=2):
    """A random plan: per slot a random permutation of the subclasses, each
    with a random lattice shift in [-shift, shift]^2."""
    plan = [[None] * 3 for _ in range(8)]
    for s in range(3):
        perm = rng.permutation(8)
        for k in range(8):
            plan[k][s] = (int(perm[k]), int(rng.integers(-shift, shift + 1)),
                          int(rng.integers(-shift, shift + 1)))
    return tuple(tuple(row) for row in plan)


def _operator(nd, lattice, dtype, seed):
    """(StencilBlockEll with random planes and diagonally dominant self
    blocks, weight) on ``lattice``."""
    rng = np.random.default_rng(seed)
    KY, KX = lattice
    W = rng.standard_normal((4, nd, nd, 8, KY, KX))
    W[0] += 4 * nd * np.eye(nd)[:, :, None, None, None]
    w = rng.uniform(0.5, 2.0, (nd, 8, KY, KX))
    return (pt.StencilBlockEll(torch.as_tensor(W, dtype=dtype), _plan(rng)),
            torch.as_tensor(w, dtype=dtype))


def _az(A, weight):
    """The weighted AZ planes as the build computes them."""
    wnbr = A.neighbor_fields(weight)
    return torch.stack([(A.planes[s] * wnbr[s][None, :]).sum(dim=1) for s in range(4)])


def _coarse(agg, dtype, seed):
    """A fixed random linear coarse solve in the layout of ``agg``."""
    n = agg.mx * agg.my
    C = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, n)) / n, dtype=dtype)
    return lambda rc: (C @ rc.reshape(-1)).reshape(agg.shape)


# (lattice, macro (mx, my), x-major layout): fx >= 2 and fx = 1, the two
# layouts, lattices narrower than the slot shifts (KY = 2, 3 < 2 * 2 + 1)
CASES = [((4, 6), (3, 2), True), ((4, 6), (6, 2), True), ((4, 6), (3, 1), False),
         ((2, 3), (3, 1), True), ((3, 4), (2, 3), False), ((6, 4), (1, 3), True)]


@pytest.mark.parametrize("smoothing", ["jacobi", "caller"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{'xm' if c[2] else '2d'}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nd", NDS)
def test_plain_apply_is_the_old_closures_bitwise(nd, dtype, case, smoothing):
    lattice, macro, x_major = case
    A, w = _operator(nd, lattice, dtype, 7 * nd + len(lattice))
    agg = (pt._aggregation if x_major else pt._aggregation2d)(A, macro)
    AZ = _az(A, w)
    assert agg.shape == ((agg.mx * agg.my,) if x_major else (agg.my, agg.mx))
    coarse = _coarse(agg, dtype, 3)
    jacobi = pt.jacobi_smoother(A)
    fine = mod.fine_level(AZ, w, A.plan, agg,
                          Dinv=pt._block_inverse(A) if smoothing == "jacobi" else None)
    assert (fine.Dinv is None) == (smoothing == "caller")
    new = pt._deflation_apply(fine, coarse, None if smoothing == "jacobi" else jacobi)
    old = _old_apply(AZ, w, agg, A.plan, coarse, jacobi)
    R = torch.as_tensor(np.random.default_rng(5).standard_normal(tuple(w.shape)), dtype=dtype)
    with recording() as rec:
        Z = new(R)
    assert rec.total("deflation.applies") == 1 and rec.totals_under("kernel.") == {}
    assert Z.dtype == dtype and Z.shape == R.shape
    assert torch.equal(Z, old(R))


@pytest.fixture(scope="module")
def thermalblock():
    """(A, weight = 1/s) of the thermalblock SWIPDG at 6 bisections (lattice
    16 x 16), float64, scaled as ``_stencil_solve`` scales it."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.parameters import parse_parameter
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    grid = alu_cube_grid((0.0, 0.0), (1.0, 1.0), (4, 4), refinements=6)
    disc = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                ThermalblockProblem((2, 2)), only_these_products=(),
                                device="cpu")
    system = disc.stencil_system(parse_parameter(np.array([0.1, 0.5, 1.0, 0.3]),
                                                 disc.parameter_type))
    w = (1.0 / system.s)[system.to_soa].reshape(system.B.shape)
    return system.S, w, system.B


def _spy(monkeypatch):
    """{} filled with what the next build hands ``_deflation_apply``."""
    seen = {}
    real = pt._deflation_apply

    def spy(fine, coarse, smoother=None):
        seen.update(fine=fine, coarse=coarse, smoother=smoother)
        return real(fine, coarse, smoother)

    monkeypatch.setattr(pt, "_deflation_apply", spy)
    return seen


@pytest.mark.parametrize("form", ["two_level", "two_level_fx1", "three_level", "caller_smoother"])
def test_preconditioner_is_the_old_closures_bitwise(thermalblock, monkeypatch, form):
    A, w, B = thermalblock
    assert A.lattice == (16, 16)
    macro, kwargs = {"two_level": ((4, 4), {}), "two_level_fx1": ((16, 2), {}),
                     "three_level": ((2, 2), {"mid_shape": (8, 8), "newton_schulz": 2}),
                     "caller_smoother": ((4, 4), {"smoother": pt.jacobi_smoother(A)})}[form]
    seen = _spy(monkeypatch)
    M = pt.stencil_deflation_preconditioner(A, macro, weight=w, **kwargs)
    fine = seen["fine"]
    assert isinstance(fine.agg, pt._Aggregation) == (form != "three_level")
    assert (fine.Dinv is None) == (form == "caller_smoother")
    assert torch.equal(fine.AZ, _az(A, w))
    old = _old_apply(fine.AZ, w, fine.agg, A.plan, seen["coarse"], pt.jacobi_smoother(A))
    R = B * torch.linspace(0.5, 1.5, B.numel(), dtype=B.dtype).reshape(B.shape)
    assert torch.equal(M(R), old(R))


def test_spe10_three_level_preconditioner_is_the_old_closures_bitwise(monkeypatch):
    """The b8 form at 4 bisections: float32, the [my, mx] middle level."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    seen = _spy(monkeypatch)
    bench = build_spe10_bench(4, macro=(25, 5), device="cpu")
    S, B, s = bench.assemble(bench.field)
    _, M = bench.precondition(S, s)
    fine = seen["fine"]
    assert fine.AZ.dtype == torch.float32 and fine.agg.shape == (20, 100)
    assert (fine.agg.my, fine.agg.mx, fine.agg.fy, fine.agg.fx) == (20, 100, 2, 2)
    old = _old_apply(fine.AZ, fine.weight, fine.agg, S.plan, seen["coarse"],
                     pt.jacobi_smoother(S))
    assert torch.equal(M(B), old(B))


def test_non_bijective_plan_raises_at_build(thermalblock):
    A, w, _ = thermalblock
    plan = [list(row) for row in A.plan]
    plan[1][2] = (plan[0][2][0],) + tuple(plan[1][2][1:])  # two subclasses reach one target
    bad = pt.StencilBlockEll(A.planes, plan)
    with pytest.raises(ValueError, match="not bijective"):
        pt.stencil_deflation_preconditioner(bad, (4, 4), weight=w)
    with pytest.raises(ValueError, match="not bijective"):
        mod.fine_level(_az(A, w), w, plan, pt._aggregation(A, (4, 4)))


# -- the kernels' index arithmetic, replayed on integer data ----------------------


def _stage_sums(values, geometry, my, mx, fy, fx, x_major):
    """The two launches of an aggregate sum as the kernels index them:
    ``values`` [8, KY, KX] site values -> the coarse vector."""
    _, KY, KX = values.shape
    nch, ch, lw, group = geometry
    n = my * nch * KX
    t = np.arange(n)
    x, r = t % KX, t // KX
    c, ay = r % nch, r // nch
    acc = np.zeros(n, dtype=values.dtype)
    for j in range(ch):
        q = c * ch + j
        live = q < 8 * fy
        k, y = np.where(live, q // fy, 0), np.where(live, ay * fy + q % fy, 0)
        acc += np.where(live, values[k, y, x], 0)
    partial = acc.reshape(-1, lw).sum(axis=1)  # the lw adjacent columns of a warp
    assert partial.size == geometry.partials(my, KX)
    per_row, per_agg = KX // lw, fx // lw
    out = np.zeros(mx * my, dtype=values.dtype)
    sy, sx = (1, my) if x_major else (mx, 1)
    for a in range(my * mx):
        a_y, a_x = a // mx, a % mx
        q = np.arange(nch * per_agg)
        out[a_y * sy + a_x * sx] = partial[(a_y * nch + q // per_agg) * per_row + a_x * per_agg
                                           + q % per_agg].sum()
    return out if x_major else out.reshape(my, mx)


# (KY, KX, fy, fx): the OS2014, b8 and b10 shapes, fx = 1, an odd fx, a factor
# of 32 that leaves lanes over, fy = 1
GEOMETRIES = [(256, 256, 64, 64), (160, 800, 2, 2), (320, 1600, 4, 4), (8, 12, 2, 1),
              (6, 12, 3, 3), (8, 96, 4, 48), (4, 64, 1, 32), (20, 100, 4, 25)]


@pytest.mark.parametrize("threads", [64, 4096, mod.STAGE_ONE_THREADS])
@pytest.mark.parametrize("shape", GEOMETRIES, ids=lambda s: "x".join(map(str, s)))
def test_aggregate_sums_geometry_counts_every_site_once(shape, threads):
    KY, KX, fy, fx = shape
    my, mx = KY // fy, KX // fx
    g = mod.sum_geometry(KX, fy, fx, my, threads)
    assert g.nch * g.ch >= 8 * fy > (g.nch - 1) * g.ch  # every pair, no empty chunk
    assert g.lw in (1, 2, 4, 8, 16, 32) and fx % g.lw == 0 and KX % g.lw == 0
    assert g.group in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert g.group == 1 or (g.group // 2) * mod.TERMS_PER_THREAD < g.nch * (fx // g.lw)
    values = np.random.default_rng(KX + fy).integers(-1000, 1000, (8, KY, KX)).astype(np.float64)
    agg = values.reshape(8, my, fy, mx, fx).sum(axis=(0, 2, 4))  # [my, mx]
    for x_major in (True, False):
        got = _stage_sums(values, g, my, mx, fy, fx, x_major)
        np.testing.assert_array_equal(got, agg.T.reshape(-1) if x_major else agg)


def test_aggregate_sums_geometry_at_the_cells_shapes():
    """OS2014: 16 aggregates of 64 x 64 sites, a warp per column run and 32
    threads an aggregate; b8: 32,000 aggregates of 2 x 2, one thread each;
    b10: 32,000 aggregates of 4 x 4, 32 pairs in two chunks, 4 lanes a row."""
    assert mod.sum_geometry(256, 64, 64, 4) == (128, 4, 32, 32)
    assert mod.sum_geometry(800, 2, 2, 80) == (3, 6, 2, 1)
    assert mod.sum_geometry(1600, 4, 4, 80) == (2, 16, 4, 1)


@pytest.mark.parametrize("nd", [3, 6])
@pytest.mark.parametrize("lattice", [(4, 6), (2, 3)])
def test_target_gather_is_the_scattered_pairing(nd, lattice):
    """Z_w^T A S's site totals as the kernel gathers them (per slot the
    pairing of the source ``sources[s][ks]`` at (y - dy, x - dx)), against
    the rolled scatter of the plain version, on integer data."""
    rng = np.random.default_rng(nd)
    KY, KX = lattice
    plan = _plan(rng)
    AZ = rng.integers(-50, 50, (4, nd, 8, KY, KX)).astype(np.float64)
    S = rng.integers(-50, 50, (nd, 8, KY, KX)).astype(np.float64)
    sources = mod._sources(plan)
    y, x = np.meshgrid(np.arange(KY), np.arange(KX), indexing="ij")
    gathered = (AZ[0] * S).sum(axis=0)
    for s in range(3):
        pairing = (AZ[s + 1] * S).sum(axis=0)  # [8, KY, KX] at the source
        for ks in range(8):
            k, dy, dx = sources[s][ks]
            gathered[ks] += pairing[k, (y - dy) % KY, (x - dx) % KX]
    # the site totals themselves
    agg = pt._Aggregation(lambda V: V, None, 1, 1, KY, KX, (1,), None)
    F = mod.FineLevel(torch.as_tensor(AZ), torch.ones(nd, 8, KY, KX, dtype=torch.float64),
                      None, plan, sources, agg)
    scattered = mod.zt_a_reference(F, torch.as_tensor(S))
    np.testing.assert_array_equal(scattered.numpy(), gathered)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{'xm' if c[2] else '2d'}")
def test_residual_reads_the_coarse_vector_at_the_shifted_aggregate(case):
    """A Z_w y as the residual kernel forms it, y read at the aggregate of
    (y + dy, x + dx) through the layout's strides, each product and sum in
    the kernel's order: bitwise the plain rolled broadcast."""
    lattice, macro, x_major = case
    A, w = _operator(3, lattice, torch.float64, 11)
    agg = (pt._aggregation if x_major else pt._aggregation2d)(A, macro)
    F = mod.fine_level(_az(A, w), w, A.plan, agg)
    yc = _coarse(agg, torch.float64, 2)(torch.arange(1.0, agg.mx * agg.my + 1,
                                                     dtype=torch.float64).reshape(agg.shape))
    KY, KX = lattice
    sy, sx = (1, agg.my) if x_major else (agg.mx, 1)
    flat = yc.reshape(-1)
    y, x = torch.meshgrid(torch.arange(KY), torch.arange(KX), indexing="ij")

    def at(yy, xx):
        return flat[(yy // agg.fy) * sy + (xx // agg.fx) * sx]

    out = torch.empty_like(w)
    for k in range(8):
        b = [at(y, x)] + [at((y + dy) % KY, (x + dx) % KX) for _, dy, dx in F.plan[k]]
        for i in range(3):
            o = F.AZ[0, i, k] * b[0]
            for s in range(1, 4):
                o = o + F.AZ[s, i, k] * b[s]
            out[i, k] = o
    R = torch.zeros_like(w)
    assert torch.equal(mod.residual_reference(F, R, yc), R - out)


@pytest.mark.parametrize("layout", ["x_major", "x_major_strided", "2d", "2d_transposed"])
def test_coarse_strides_follow_the_layout(layout):
    """The strides the kernels read a coarse vector by, from the
    aggregation's ``grid`` view: aggregate (iy, ix) at iy * sy + ix * sx of
    the vector's memory, in the x-major flat and the [my, mx] layouts,
    contiguous or not."""
    A, _ = _operator(3, (4, 6), torch.float64, 1)
    agg = (pt._aggregation if layout.startswith("x_major") else pt._aggregation2d)(A, (3, 2))
    F = mod.FineLevel(None, None, None, None, None, agg)
    my, mx = agg.my, agg.mx
    n = mx * my
    yc, want = {
        "x_major": (torch.arange(n), lambda iy, ix: ix * my + iy),
        "x_major_strided": (torch.arange(2 * n)[::2], lambda iy, ix: 2 * (ix * my + iy)),
        "2d": (torch.arange(n).reshape(my, mx), lambda iy, ix: iy * mx + ix),
        "2d_transposed": (torch.arange(n).reshape(mx, my).t(), lambda iy, ix: ix * my + iy),
    }[layout]
    sy, sx = mod._coarse_strides(F, yc)
    iy, ix = torch.meshgrid(torch.arange(my), torch.arange(mx), indexing="ij")
    assert torch.equal(torch.as_strided(yc, (my, mx), (sy, sx)), want(iy, ix))
    with pytest.raises(ValueError, match="coarse vector"):
        mod._coarse_strides(F, torch.arange(n + 1))


# -- the wrappers ---------------------------------------------------------------


def _fine(nd=3, dtype=torch.float64, jacobi=True):
    A, w = _operator(nd, (4, 6), dtype, 1)
    agg = pt._aggregation(A, (3, 2))
    return mod.fine_level(_az(A, w), w, A.plan, agg,
                          Dinv=pt._block_inverse(A) if jacobi else None), w


def test_wrappers_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel was launched for CPU tensors")

    monkeypatch.setattr(mod, "_launch", no_launch)
    F, w = _fine()
    R = w * 0.25
    y = torch.arange(6.0, dtype=torch.float64)
    with recording() as rec:
        rc = mod.weighted_sums(F, R)
        S = mod.residual(F, R, y)
        rc2 = mod.zt_a(F, S)
        Z = mod.combine(F, y, S, rc2)
    assert rec.totals_under("kernel.") == {}
    assert torch.equal(rc, mod.weighted_sums_reference(F, R))
    assert torch.equal(S, mod.residual_reference(F, R, y))
    assert torch.equal(rc2, mod.zt_a_reference(F, S))
    assert torch.equal(Z, mod.combine_reference(F, y, S, rc2))


@pytest.mark.parametrize("fault", ["nd4", "float16", "dtype", "field_shape", "devices",
                                   "dinv_shape", "tiling"])
def test_wrappers_refuse_what_the_kernels_do_not_take(fault):
    F, w = _fine()
    A4, w4 = _operator(4, (4, 6), torch.float64, 1)
    agg = pt._aggregation(A4, (3, 2))
    with pytest.raises((TypeError, ValueError)):
        if fault == "nd4":
            mod.weighted_sums(mod.fine_level(_az(A4, w4), w4, A4.plan, agg), w4)
        elif fault == "float16":
            mod.weighted_sums(F._replace(AZ=F.AZ.half(), weight=F.weight.half(), Dinv=None),
                              w.half())
        elif fault == "dtype":
            mod.weighted_sums(F, w.float())
        elif fault == "field_shape":
            mod.zt_a(F, w[:, :, :-1])
        elif fault == "devices":
            mod.weighted_sums(F, torch.empty(w.shape, dtype=w.dtype, device="meta"))
        elif fault == "dinv_shape":
            mod.fine_level(F.AZ, w, F.plan, F.agg, Dinv=F.Dinv[:2])
        else:
            mod.fine_level(F.AZ, w, F.plan, pt._aggregation(A4, (2, 2))._replace(fx=2))


def test_params_match_the_kernels_struct():
    """``_Params`` lays out as csrc/deflation_apply.cu's ``Params``: eight
    pointers, 16 ints, then the 48 shifts and the 72 sources."""
    P = mod._Params
    assert P.KY.offset == 64 and P.group.offset == 64 + 15 * 4
    assert P.shift.offset == 128 and P.source.offset == 128 + 48 * 4
    assert mod.ctypes.sizeof(P) == 128 + 120 * 4


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _esv_plan():
    """The plan of the structured triangle grids (the thermalblock, OS2014
    and SPE10 lattices share it), from the smallest such grid."""
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2)
    return pt.stencil_plan(structured_cell_order(grid, (0, 0), (1, 1)))


def _card_level(nd, lattice, macro, x_major, dtype, device, jacobi=True, seed=1):
    """A random fine level on the card under the grids' plan, a field R and
    the coarse vectors' shape."""
    rng = np.random.default_rng(seed)
    KY, KX = lattice
    AZ = torch.as_tensor(rng.standard_normal((4, nd, 8, KY, KX)), dtype=dtype, device=device)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, (nd, 8, KY, KX)), dtype=dtype, device=device)
    D = torch.as_tensor(rng.standard_normal((8, KY, KX, nd, nd)) + 2 * nd * np.eye(nd),
                        dtype=dtype, device=device)
    Dinv = torch.movedim(torch.linalg.inv(D), (-2, -1), (0, 1)).contiguous()
    A = pt.StencilBlockEll(torch.empty((4, nd, nd, 8, KY, KX), device="meta"), _esv_plan())
    agg = (pt._aggregation if x_major else pt._aggregation2d)(A, macro)
    F = mod.fine_level(AZ, w, A.plan, agg, Dinv=Dinv if jacobi else None)
    R = torch.as_tensor(rng.standard_normal((nd, 8, KY, KX)), dtype=dtype, device=device)
    return F, R


def _coarse_like(F, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(F.agg.shape),
                           dtype=F.AZ.dtype, device=F.AZ.device)


def _sum_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# (nd, lattice, macro, x-major, dtype): the OS2014, b8 and b10 shapes, then
# the other nd, fx = 1 and the [my, mx] layout at small lattices
CARD_CASES = [(3, (256, 256), (4, 4), True, torch.float64),
              (3, (160, 800), (400, 80), False, torch.float32),
              (3, (320, 1600), (400, 80), False, torch.float32),
              (6, (32, 48), (4, 4), True, torch.float64), (10, (16, 24), (8, 4), False,
                                                           torch.float32),
              (3, (12, 44), (44, 3), True, torch.float64), (6, (8, 12), (3, 2), False,
                                                           torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"nd{c[0]}-{c[1][0]}x{c[1][1]}")
def test_kernels_against_the_plain_versions(cuda_device, case):
    nd, lattice, macro, x_major, dtype = case
    F, R = _card_level(nd, lattice, macro, x_major, dtype, cuda_device)
    y1, y2 = _coarse_like(F, 2), _coarse_like(F, 3)
    with recording() as rec:
        rc = mod.weighted_sums(F, R)
        S = mod.residual(F, R, y1)
        rc2 = mod.zt_a(F, S)
        Z = mod.combine(F, y1, S, y2)
        T = mod.residual(F._replace(Dinv=None), R, y1)
    torch.cuda.synchronize()
    assert rec.totals_under("kernel.deflation_apply.") == {
        "weighted_sums": 1, "residual": 1, "zt_a": 1, "combine": 1, "defect": 1}
    assert torch.equal(S, mod.residual_reference(F, R, y1))
    assert torch.equal(T, mod.residual_reference(F._replace(Dinv=None), R, y1))
    assert torch.equal(Z, mod.combine_reference(F, y1, S, y2))
    assert rc.shape == rc2.shape == y1.shape and rc.is_contiguous()
    assert _sum_err(rc, mod.weighted_sums_reference(F, R)) <= SUM_BAR[dtype]
    assert _sum_err(rc2, mod.zt_a_reference(F, S)) <= SUM_BAR[dtype]
    # no atomics: a second run is bitwise the first
    assert torch.equal(rc, mod.weighted_sums(F, R)) and torch.equal(rc2, mod.zt_a(F, S))
    assert torch.equal(S, mod.residual(F, R, y1))


@pytest.mark.cuda
def test_kernels_read_strided_coarse_vectors(cuda_device):
    """A [my, mx] coarse vector that is a transposed view (as a middle
    level's exact solve returns it): read through its strides."""
    F, R = _card_level(3, (16, 24), (4, 4), False, torch.float64, cuda_device)
    y = _coarse_like(F, 4).t().contiguous().t()
    assert not y.is_contiguous()
    assert torch.equal(mod.residual(F, R, y), mod.residual_reference(F, R, y))


@pytest.fixture(scope="module")
def os2014_level3():
    """The OS2014 cell's system at level 3 (lattice 32 x 32) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    from pathlib import Path

    from hddbench.entries.os2014_snapshots import System

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "hddbench/configs/os2014_swipdg.json").read_text())
    config.update(level=3, bisections=8, dofs=3 * 8 * 32 * 32, lattice=[32, 32])
    return System(config, torch.device("cuda"))


@pytest.mark.cuda
def test_graphed_solve_runs_the_kernels(os2014_level3):
    """The graphed PCG with the kernels' apply: no eager fallback, and the
    fused residual pass once per application of M (the init's and one an
    iteration, counted again at each replay)."""
    system = os2014_level3
    system.solve(np.array([0.5]))  # build and capture once
    with recording() as rec:
        out = system.solve(np.array([0.5]))
    assert out.ok and rec.total("pcg.graph.eager_fallbacks") == 0
    applies = rec.total("deflation.applies")
    assert applies == out.iterations + 1
    for pass_name in ("weighted_sums", "residual", "zt_a", "combine"):
        assert rec.total(f"kernel.deflation_apply.{pass_name}") == applies
    assert rec.total("kernel.deflation_apply.defect") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mu", [0.1, 1.0])
def test_os2014_iterations_match_the_plain_apply(os2014_level3, monkeypatch, mu):
    system = os2014_level3
    kernels = system.solve(np.array([mu]))
    for name in ("weighted_sums", "residual", "zt_a", "combine"):
        monkeypatch.setattr(pt, name, getattr(mod, f"{name}_reference"))
    with recording() as rec:
        plain = system.solve(np.array([mu]))
    assert rec.totals_under("kernel.deflation_apply.") == {}
    assert kernels.ok and plain.ok
    assert abs(kernels.iterations - plain.iterations) <= 0.02 * plain.iterations
