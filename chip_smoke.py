#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the three CUDA
kernels, checks each against its plain PyTorch version, drives the SPE10
SWIPDG assemble-and-solve bench at 768k, 3.07M and 12.29M DoF (6, 8 and 10
bisections) through the plane SpMV kernel, drives the structured SpMV and
the probe through their own entry points, times every kernel beside its
plain version and one library call that computes the same function, then
runs the ESV2007 EOC study with its a-posteriori estimators (levels 0-6, up
to 1.57M DoF), the CG-P1 EOC study on the same hierarchy, the BlockSWIPDG /
OS2014 path (the published block table at four partitionings, [8 8 1] to
1.57M DoF, the OS2014 parametric and SPE10 parametric block studies, the
bench's block provenance check at 768k and 3.07M DoF), 8 online
thermalblock solves at 1.57M DoF through the general parametric SWIPDG
path, and model order reduction: the RB / LRBMS greedy workflow on that
1.57M-DoF thermalblock and the adaptive LRBMS enrichment.  Exits non-zero
if any phase fails or there is no card.

    python3 chip_smoke.py

Phases (one line of output each, each with its seconds): device, build,
kernel vs plain (plane SpMV at 6 and 2 bisections; structured SpMV on the
768k-DoF operator and on random blocks; probe bitwise at three sizes and on
offset views, both of its paths), main path at 6 bisections, structured
path, probe path, kernel path vs plain path at 4 bisections, kernel timing
at 768k DoF (the probe at [64, 128] and 2^24, and its scalar path), main
path at 8 bisections with the symmetric operator's checks, main path at 10
bisections with the plane SpMV checked against its plain version and timed
on the symmetric 12.29M-DoF planes, the ESV2007 study (stencil_cg with the
4x4 macro and the six ESV2007 estimators: the table of errors, estimates
and efficiencies at levels 0-3, EOC at 4-6, RT0 local conservation at level
6), the CG study (Jacobi CG, EOC from level 2 on), the block ESV2007 table
(stencil_cg at [1 1 1] ... [8 8 1], levels 0-3 against the published OS2014
columns, [8 8 1] to level 6 with EOC and efficiency), the OS2014 parametric
[4 4 1] study at four (mu, mu_bar, mu_hat) triples, the SPE10 parametric
[20 4 1] study against its 384,000-DoF reference, the block provenance
check (768k and 3.07M DoF) and the
thermalblock online solves (block_cg through make_solve_fn, each rechecked
in float64, one stencil_cg solve, RT0 local conservation and eta_ESV2007),
the RB workflow on the same grid (BlockSWIPDG [2 2]: the RB and LRBMS greedy
with the Riesz estimator and stencil_cg snapshots, their errors at the 8
solved mu, the batched online sweep over 1,024 mu against single solves,
save/load), the recorded adaptive LRBMS trajectory on SPE10 [20 4 1] and
the adaptive OS2014 [2 2] enrichment with 3 oversampling layers.
Then a JSON line of the kernels, the card's name and power limit, and last
{"ok": true, ...}.
"""
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "plane_spmv": ("dune_hdd_tpu_torch/csrc/plane_spmv.cu", "scripts/pallas_plane_repro.py:83"),
    "structured_spmv": ("dune_hdd_tpu_torch/csrc/structured_spmv.cu",
                        "dune_hdd_tpu/la/pallas_spmv.py:32"),
    "probe": ("dune_hdd_tpu_torch/csrc/probe.cu", "scripts/pallas_minimal_repro.py:7"),
}
_T0 = time.perf_counter()
_LAST = [_T0]


def log(phase, **fields):
    now = time.perf_counter()
    fields["phase_seconds"] = f"{now - _LAST[0]:.2f}"
    _LAST[0] = now
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_check(what, y, y_ref, rel):
    """max |y - y_ref|, raising if it exceeds rel * max |y_ref|."""
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    bound = rel * y_ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"{what}: {err:.3e} > {bound:.3e}")
    return err


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a card")
    from dune_hdd_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log("device", card=repr(card()), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), count=torch.cuda.device_count())


def phase_build():
    """One nvcc per source, all started together."""
    from dune_hdd_tpu_torch.kernels import build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        results = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, (lib, seconds, compiler_log) in results.items():
        ptxas = [ln.strip() for ln in compiler_log.splitlines() if "registers" in ln]
        log("build", kernel=name, library=lib.name, compiled_now=bool(compiler_log),
            nvcc_seconds=f"{seconds:.2f}", ptxas=repr("; ".join(ptxas)))


def phase_plane_vs_plain(dev):
    """Returns the 6-bisection bench, its scaled system (S, B) and the max
    abs error of the plane SpMV there (f32 and f64)."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out = {}
    for bisections in (6, 2):
        bench = build_spe10_bench(bisections=bisections, device=dev)
        S, B, _ = bench.assemble(bench.field)
        gen = torch.Generator(device="cpu").manual_seed(bisections)
        X = torch.randn(tuple(B.shape), generator=gen, dtype=torch.float64).to(dev)
        errs = {}
        for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            W, Xd = S.planes.to(dtype), X.to(dtype)
            errs[dtype] = rel_check("plane_spmv vs plain", plane_spmv(W, Xd, S.plan),
                                    plane_spmv_reference(W, Xd, S.plan), rel)
        out[bisections] = (bench, S, B, max(errs.values()))
        log("kernel_vs_plain", kernel="plane_spmv", bisections=bisections, dofs=bench.num_dofs,
            f32_max_abs_err=f"{errs[torch.float32]:.3e}",
            f64_max_abs_err=f"{errs[torch.float64]:.3e}")
    return out[6]


def flat(X):
    """[3, 8, KY, KX] plane-layout vector -> flat cell-major [nc * 3]."""
    return X.reshape(3, -1).t().reshape(-1)


def phase_structured_vs_plain(dev, bench, S, B):
    """The structured SpMV against its plain version and against the plane
    SpMV on the 768k-DoF operator, and against its plain version on random
    blocks with random offsets at an nc that is not a multiple of 1024.
    Returns the repacked operator, the flat rhs and the max abs error."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)
    from dune_hdd_tpu_torch.la.block_ell import StructuredBlockEll

    # the planes' cells in subclass-major lattice order are the structured
    # numbering: the flat operator is a view of the planes
    nc = S.num_cells
    A = StructuredBlockEll(None, S.planes.reshape(4, 3, 3, nc).permute(3, 0, 1, 2), bench.offsets)
    gen = torch.Generator(device="cpu").manual_seed(11)
    X = torch.randn(tuple(B.shape), generator=gen).to(dev)
    x = flat(X)
    y = structured_spmv(A.planes, x, A.offsets)
    err = rel_check("structured_spmv vs plain", y,
                    structured_spmv_reference(A.planes, x, A.offsets), 1e-5)
    err_layout = rel_check("structured_spmv vs plane_spmv", y, flat(plane_spmv(S.planes, X, S.plan)),
                           1e-5)
    nr = 8 * 125_003  # 1,000,024 cells: not a multiple of 1024
    rng = np.random.default_rng(12)
    offsets = tuple(tuple(int(o) for o in row)
                    for row in rng.integers(-nr // 2, nr // 2, size=(8, 3)))
    P = torch.as_tensor(rng.standard_normal((4, 3, 3, nr), dtype=np.float32)).to(dev)
    xr = torch.as_tensor(rng.standard_normal(nr * 3, dtype=np.float32)).to(dev)
    err_random = rel_check("structured_spmv vs plain (random)", structured_spmv(P, xr, offsets),
                           structured_spmv_reference(P, xr, offsets), 1e-5)
    log("kernel_vs_plain", kernel="structured_spmv", dofs=x.numel(),
        max_abs_err=f"{err:.3e}", max_abs_diff_vs_plane_spmv=f"{err_layout:.3e}",
        random_nc=nr, random_max_abs_err=f"{err_random:.3e}")
    return A, flat(B), err


def phase_probe_vs_plain(dev):
    """The probe bitwise against 2x + y at [64, 128], 2^24 and 2^24 + 3, and
    on views whose offsets take the float4 path with a scalar head (x[1:]
    with y[1:]) or the scalar path (x[1:] beside y[:-1] or y[3:])."""
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference

    rng = np.random.default_rng(13)
    n = 1 << 24

    def normal(size):
        return torch.as_tensor(rng.standard_normal(size, dtype=np.float32)).to(dev)

    cases = [(repr(shape), normal(shape), normal(shape)) for shape in ((64, 128), n, n + 3)]
    xb, yb = normal(n + 3), normal(n + 3)
    cases += [("x[1:] y[1:]", xb[1:n + 1], yb[1:n + 1]), ("x[1:] y[:-1]", xb[1:n + 1], yb[:n]),
              ("x[1:] y[3:]", xb[1:n + 1], yb[3:n + 3])]
    launches, scalar = probe.launches, probe.scalar_launches
    err = 0.0
    for label, x, y in cases:
        o, o_ref = probe(x, y), probe_reference(x, y)
        err = max(err, rel_check(f"probe vs 2x + y ({label})", o, o_ref, 0.0))
        if not torch.equal(o, o_ref):
            raise AssertionError(f"probe differs from 2x + y bitwise ({label})")
    scalar = probe.scalar_launches - scalar
    vector = probe.launches - launches - scalar
    if (vector, scalar) != (4, 2):
        raise AssertionError(f"probe paths: {vector} vector and {scalar} scalar launches, "
                             "expected 4 and 2")
    log("kernel_vs_plain", kernel="probe", cases=repr([c[0] for c in cases]),
        max_abs_err=err, bitwise_equal=True, vector_launches=vector, scalar_launches=scalar)
    return err


def phase_main_path(dev, bisections, repeats):
    """The bench through its entry point, with the plane SpMV's launch count
    set to 0 just before and read just after.  Returns the run's dict and
    the launch count."""
    from dune_hdd_tpu_torch.bench_harness import run_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    plane_spmv.launches = 0
    r = run_spe10_bench(bisections=bisections, repeats=repeats, tol=1e-6, device=dev)
    launches = plane_spmv.launches
    if not r["residual"] <= 1e-6:
        raise AssertionError(f"residual {r['residual']:.3e} > 1e-6")
    bench = r["bench"]
    S, B, s = bench.assemble(r["field"])
    if bench.settings.symmetric:
        S = S.symmetrized()
    W64 = S.matvec_planes.double()
    B64 = B.double()
    X = r["u"][bench.to_soa].reshape(B.shape) / s.double()
    res64 = ((B64 - plane_spmv_reference(W64, X, S.plan)).norm() / B64.norm()).item()
    del W64
    if not res64 <= 1.01e-6:
        raise AssertionError(f"float64 recheck: residual {res64:.3e} > 1.01e-6")
    per_solve = r["inner_iterations"] + r["outer_sweeps"]
    if launches < per_solve:
        raise AssertionError(f"{launches} kernel launches < {per_solve} SpMVs of one solve")
    log("main_path", bisections=bisections, dofs=r["num_dofs"], mid_shape=repr(bench.mid_shape),
        symmetric=bench.settings.symmetric, setup_seconds=f"{r['setup_seconds']:.3f}",
        warmup_seconds=f"{r['warmup_seconds']:.3f}", seconds=f"{r['seconds']:.6f}",
        mdof_per_s=f"{r['mdof_per_s']:.4f}", all_seconds=repr([round(t, 6) for t in r["all_times"]]),
        inner_iterations=r["inner_iterations"], outer_sweeps=r["outer_sweeps"],
        residual=f"{r['residual']:.3e}", residual_f64_recheck=f"{res64:.3e}",
        launches=launches, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        card=repr(card()))
    return r, (S, B), launches


def power_lambda(matvec, v, iters=20):
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.norm(w)
    return torch.dot(v.reshape(-1), matvec(v).reshape(-1)).item()


def phase_structured_path(A, S, B):
    """StructuredBlockEll.matvec, the structured SpMV's entry point, in a
    power iteration on the 768k-DoF operator, its launch count set to 0 just
    before and read just after; the same iteration through the plane
    layout must give the same lambda_max."""
    from dune_hdd_tpu_torch.kernels.structured_spmv import structured_spmv

    structured_spmv.launches = 0
    lam = power_lambda(A.matvec, flat(B) / torch.linalg.norm(B))
    launches = structured_spmv.launches
    lam_plane = power_lambda(S.matvec, B / torch.linalg.norm(B))
    if not abs(lam - lam_plane) <= 1e-5 * abs(lam_plane):
        raise AssertionError(f"structured path lambda {lam} != plane path {lam_plane}")
    log("structured_path", dofs=B.numel(), power_iterations=20, lambda_max=f"{lam:.8e}",
        lambda_max_plane=f"{lam_plane:.8e}", launches=launches)
    return launches


def phase_probe_path(dev):
    """The probe through its entry point at the reference script's shape and
    inputs (ones, expecting 3.0), launch count set to 0 just before."""
    from dune_hdd_tpu_torch.kernels.probe import probe

    probe.launches = 0
    x = torch.ones((64, 128), device=dev)
    o = probe(x, x)
    launches = probe.launches
    if not torch.equal(o, torch.full_like(x, 3.0)):
        raise AssertionError("probe(ones, ones) != 3")
    log("probe_path", shape=(64, 128), value=o[0, 0].item(), launches=launches)
    return launches


def phase_kernel_path_vs_plain_path(dev):
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv_reference

    sols = []
    for spmv in (None, plane_spmv_reference):
        kw = {} if spmv is None else {"spmv": spmv}
        bench = build_spe10_bench(bisections=4, device=dev, **kw)
        sol = bench.fn(bench.field)
        if not sol.residual <= 1e-6:
            raise AssertionError(f"residual {sol.residual:.3e} > 1e-6")
        sols.append(sol)
    diff = ((sols[0].u - sols[1].u).abs().max() / sols[1].u.abs().max()).item()
    if not diff <= 1e-4:
        raise AssertionError(f"kernel and plain paths disagree: {diff:.3e} > 1e-4")
    log("kernel_path_vs_plain_path", bisections=4, rel_max_diff=f"{diff:.3e}",
        residuals=repr([f"{x.residual:.3e}" for x in sols]),
        iterations=repr([x.iterations for x in sols]))


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)
# peak rates outside the tensor cores (NVIDIA's data sheet, H100 SXM at 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bsr_operator(planes, plan):
    """The plane operator as a torch.sparse BSR tensor with 3x3 blocks over
    the flat cell-major vector in (subclass, iy, ix) order, which is also the
    structured numbering: the library yardstick of both SpMV kernels (timed
    here, used nowhere in the port)."""
    _, nd, _, _, KY, KX = planes.shape
    L, dev = KY * KX, planes.device
    nc = 8 * L
    iy = torch.arange(KY, device=dev)[:, None]
    ix = torch.arange(KX, device=dev)[None, :]
    cols = [torch.arange(nc, device=dev).reshape(8, KY, KX)]
    for s in range(3):
        cols.append(torch.stack([ks * L + ((iy + dy) % KY) * KX + (ix + dx) % KX
                                 for ks, dy, dx in (plan[k][s] for k in range(8))]))
    cols, order = torch.sort(torch.stack(cols, dim=-1).reshape(nc, 4), dim=1)
    if not bool((cols[:, 1:] != cols[:, :-1]).all()):
        raise AssertionError("two slots of one cell share a neighbour")
    vals = planes.permute(3, 4, 5, 0, 1, 2).reshape(nc, 4, nd, nd)
    vals = torch.gather(vals, 1, order[:, :, None, None].expand(-1, -1, nd, nd))
    crow = torch.arange(0, 4 * nc + 1, 4, device=dev)
    return torch.sparse_bsr_tensor(crow, cols.reshape(-1), vals.reshape(-1, nd, nd).contiguous(),
                                   size=(nc * nd, nc * nd), check_invariants=False)


def time_calls(fn, calls=100):
    """Device time of one call (ms): the median of ``calls`` chained calls,
    each between two CUDA events.  A device-side sleep queued first keeps
    the card busy while the host enqueues all calls, so the host's launch
    latency does not land between the events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    torch.cuda._sleep(int(3 * calls * host_s * 2e9))  # cycles, >= 3x the enqueue time
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def timed(kernel, label, fn, plain_fn, library_fn, nbytes, flops, dtype, **fields):
    """Times a kernel, its plain version and the one library call that
    computes the same function; logs µs and GB/s under the bytes model and
    the bound; returns the timing fields of the kernels line."""
    ms, plain_ms, library_ms = time_calls(fn), time_calls(plain_fn), time_calls(library_fn)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log("timing", kernel=kernel, case=label, kernel_us=f"{ms * 1e3:.2f}",
        kernel_gbps=f"{nbytes / ms / 1e6:.1f}", plain_us=f"{plain_ms * 1e3:.2f}",
        library_us=f"{library_ms * 1e3:.2f}", bound_us=f"{bound_ms * 1e3:.2f}",
        bound_by=bound_by, bytes=nbytes, flops=flops, **fields, card=repr(card()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_plane_spmv(S, B, label, W=None):
    """Checks the plane SpMV against its plain version on these planes and
    times both, and the BSR library call, in f32 and f64.  Returns ({dtype
    name: timing fields}, the max abs error over both dtypes); bytes =
    planes + 2 vectors, operations = one multiply-add per plane entry."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out, err = {}, 0.0
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        Wd, X = (S.planes if W is None else W).to(dtype), B.to(dtype)
        name = str(dtype).replace("torch.", "")
        y = plane_spmv(Wd, X, S.plan)
        e = rel_check(f"plane_spmv vs plain ({label} {name})", y,
                      plane_spmv_reference(Wd, X, S.plan), rel)
        err = max(err, e)
        A, x = bsr_operator(Wd, S.plan), flat(X)
        e_lib = rel_check(f"BSR library call vs plane_spmv ({label} {name})", A @ x, flat(y),
                          10 * rel)
        out[name] = timed("plane_spmv", f"{label} {name}", lambda: plane_spmv(Wd, X, S.plan),
                          lambda: plane_spmv_reference(Wd, X, S.plan), lambda: A @ x,
                          (Wd.numel() + 2 * X.numel()) * Wd.element_size(), 2 * Wd.numel(),
                          dtype, dofs=X.numel(), max_abs_err=f"{e:.3e}",
                          library_max_abs_diff=f"{e_lib:.3e}")
        del Wd, X, A, x, y
    return out, err


def phase_timing_768k(dev, S, B, A, b_flat):
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)

    _, plane_err = time_plane_spmv(S, B, "768k")
    lib = bsr_operator(S.planes, S.plan)  # the same operator: planes in structured order
    y = structured_spmv(A.planes, b_flat, A.offsets)
    e_lib = rel_check("BSR library call vs structured_spmv", lib @ b_flat, y, 1e-4)
    st = timed("structured_spmv", "768k f32", lambda: structured_spmv(A.planes, b_flat, A.offsets),
               lambda: structured_spmv_reference(A.planes, b_flat, A.offsets), lambda: lib @ b_flat,
               (A.planes.numel() + 2 * b_flat.numel()) * 4, 2 * A.planes.numel(), torch.float32,
               dofs=b_flat.numel(), library_max_abs_diff=f"{e_lib:.3e}")
    del lib, y
    pr = {}
    gen = torch.Generator(device="cpu").manual_seed(16)
    for shape in ((64, 128), 1 << 24):
        # two distinct inputs: the bytes model reads both
        x, y = (torch.rand(shape, generator=gen).to(dev) for _ in range(2))
        pr[shape] = timed("probe", repr(shape), lambda: probe(x, y), lambda: probe_reference(x, y),
                          lambda: torch.add(y, x, alpha=2), 3 * x.numel() * 4, 2 * x.numel(),
                          torch.float32)
    # the scalar path: x and y at different offsets modulo 16 bytes
    xs, ys = (torch.rand((1 << 24) + 1, generator=gen).to(dev) for _ in range(2))
    x, y = xs[1:], ys[:-1]
    timed("probe", "2^24 scalar path (x[1:], y[:-1])", lambda: probe(x, y),
          lambda: probe_reference(x, y), lambda: torch.add(y, x, alpha=2), 3 * x.numel() * 4,
          2 * x.numel(), torch.float32)
    # the kernels line: the 2^24 times, the [64, 128] ones beside them
    probe_row = dict(pr[1 << 24], **{f"{k}_64x128": v for k, v in pr[(64, 128)].items()
                                      if k != "bound_by"})
    return st, probe_row, plane_err


def phase_symmetric_checks(S):
    """The plane SpMV on the symmetrized 3.07M-DoF planes against its plain
    version in f32 and f64, and the symmetric operator against the assembled
    one.  Returns the max abs error of the kernel over both dtypes."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    gen = torch.Generator(device="cpu").manual_seed(14)
    X = torch.randn((3, 8) + tuple(S.lattice), generator=gen).to(S.planes.device)
    y = plane_spmv(S.sym_planes, X, S.plan)
    err = rel_check("plane_spmv on symmetric planes vs plain", y,
                    plane_spmv_reference(S.sym_planes, X, S.plan), 1e-5)
    W64, X64 = S.sym_planes.double(), X.double()
    err64 = rel_check("plane_spmv on symmetric f64 planes vs plain", plane_spmv(W64, X64, S.plan),
                      plane_spmv_reference(W64, X64, S.plan), 1e-12)
    del W64, X64
    y_assembled = plane_spmv(S.planes, X, S.plan)
    diff = rel_check("symmetric vs assembled operator", y, y_assembled, 1e-5)
    log("symmetric_operator", dofs=X.numel(), kernel_vs_plain_max_abs_err=f"{err:.3e}",
        kernel_vs_plain_f64_max_abs_err=f"{err64:.3e}",
        sym_vs_assembled_max_abs_diff=f"{diff:.3e}",
        rel=f"{diff / y_assembled.abs().max().item():.3e}")
    return max(err, err64)


def check_plane_spmv_at(system, what):
    """plane_spmv against its plain version on a discretization's scaled
    float64 plane operator (the shapes its stencil_cg path gives it)."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    S = system.S
    gen = torch.Generator(device="cpu").manual_seed(15)
    X = torch.randn(tuple(system.B.shape), generator=gen, dtype=torch.float64).to(S.planes.device)
    return rel_check(f"plane_spmv vs plain ({what})", plane_spmv(S.planes, X, S.plan),
                     plane_spmv_reference(S.planes, X, S.plan), 1e-12)


ESV_LEVELS = 6  # 384 to 1,572,864 DoF
ESV_ESTIMATORS = ("eta_NC_ESV2007", "eta_R_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007",
                  "eta_ESV2007", "eta_ESV2007_alt")


def rt0_conservation(d, u, mu=None, **reconstruction):
    """max_T |div t_h - P0 f| / |P0 f| of the RT0 reconstruction of u's
    SWIPDG flux (``reconstruction``: the keywords that make it the assembled
    scheme's flux), and the reconstruction's seconds."""
    from dune_hdd_tpu_torch.estimators import rt0_divergence, rt0_flux_reconstruction
    from dune_hdd_tpu_torch.functions.base import freeze_function
    from dune_hdd_tpu_torch.ops.assembly import cell_quadrature

    grid, problem = d.space.grid, (d.problem.with_mu(mu) if mu is not None else d.problem)
    lam, kap, force, g_d, g_n = (freeze_function(getattr(problem, name)) for name in (
        "diffusion_factor", "diffusion_tensor", "force", "dirichlet", "neumann"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = rt0_flux_reconstruction(d.space, u, lam, kap,
                                   np.nonzero(d.boundary_info.dirichlet_faces)[0],
                                   np.nonzero(d.boundary_info.neumann_faces)[0], g_d, g_n,
                                   **reconstruction)
    div = rt0_divergence(grid, flux)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    qp, qw = cell_quadrature(grid, 6, u.device)
    p0f = torch.sum(qw * force(qp), dim=1) / d.space.tensor(grid.cell_volumes)
    return ((div - p0f).abs() / p0f.abs()).max().item(), seconds


def phase_esv2007_study(dev):
    """The ESV2007 ALU-conforming SWIPDG EOC study through EocStudy with the
    stencil_cg option (plane_spmv in float64) and the six ESV2007
    estimators, levels 0-6; levels 0-3 against the published table (errors,
    estimators, efficiency), EOC above 1.9 (L2) and 0.95 (H1_semi, eta_NC,
    eta_DF, eta_ESV2007) up to the last level; RT0 local conservation at
    level 6.  The launch count is set to 0 just before and read just after.
    Returns (launches, the kernel's max abs error at level 6, the test case)."""
    from types import SimpleNamespace

    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators import SWIPDGEstimators
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.studies import (
        EocStudy, check_eoc_study_for_success, expected_results)
    from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    estimator_seconds = {}

    def estimate_fn(disc, u, type_, level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eta = SWIPDGEstimators.estimate(disc.space, disc.boundary_info, disc.problem, u, type_)
        torch.cuda.synchronize()
        estimator_seconds.setdefault(level, {})[type_] = time.perf_counter() - t0
        return eta

    max_iter = 50000
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": max_iter, "macro": (4, 4)}
    reset_timings()
    torch.cuda.reset_peak_memory_stats()
    plane_spmv.launches = 0
    t0 = time.perf_counter()
    tc = ESV2007TestCase(num_refinements=ESV_LEVELS)
    hierarchy_s = time.perf_counter() - t0
    study = EocStudy(tc, SWIPDGDiscretization, estimator_types=ESV_ESTIMATORS,
                     estimate_fn=estimate_fn, solver_options=options, device=dev)
    results = study.run(verbose=False)
    launches = plane_spmv.launches
    host = timings()
    log("esv2007_study", levels=f"0-{ESV_LEVELS}", hierarchy_host_seconds=f"{hierarchy_s:.2f}",
        reference_level_cells=tc.reference_grid.num_cells,
        pattern_host_seconds=repr([round(t, 3) for t in host.get("swipdg.pattern", [])]),
        block_ell_map_host_seconds=repr(
            [round(t, 3) for t in host.get("block_ell_from_sparse.slot_map", [])]),
        launches=launches, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for r, info in enumerate(study.level_info):
        log("esv2007_level", level=r, dofs=info["num_dofs"],
            **{k: f"{results[k][r]:.6e}" for k in results},
            iterations=info["iterations"], time_to_solution=f"{study.time_to_solution[r]:.3f}",
            assembly_seconds=f"{info['assembly_seconds']:.3f}",
            solve_seconds=f"{info['solve_seconds']:.3f}",
            estimator_seconds=f"{sum(estimator_seconds[r].values()):.3f}",
            estimator_seconds_by_type=repr({k: round(v, 4)
                                            for k, v in estimator_seconds[r].items()}))
        if not (info["type"] == "stencil_cg" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"level {r}: {info}")
    check_eoc_study_for_success(SimpleNamespace(results={k: v[:4] for k, v in results.items()}),
                                "ESV2007", "alu_conforming", 1)
    eff = [e / h for e, h in zip(results["eta_ESV2007"][:4], results["H1_semi"])]
    eff_expected = expected_results("ESV2007", "alu_conforming", 1, "eff_ESV2007")
    if not np.allclose(eff, eff_expected, rtol=1e-2, atol=0):
        raise AssertionError(f"eff_ESV2007 {eff} != {eff_expected} (rel 1e-2)")
    eocs = {k: study.eoc(k) for k in ("L2", "H1_semi", "eta_NC_ESV2007", "eta_DF_ESV2007",
                                      "eta_ESV2007")}
    if not (min(eocs["L2"][3:]) > 1.9
            and all(min(v[3:]) > 0.95 for k, v in eocs.items() if k != "L2")):
        raise AssertionError(f"EOC {eocs}")
    if launches <= 0:
        raise AssertionError("the study did not launch plane_spmv")
    d, u = study.discretizations[-1], study.solutions[-1]
    conservation, rt0_seconds = rt0_conservation(d, u)
    if not conservation <= 1e-5:
        raise AssertionError(f"level {ESV_LEVELS}: div t_h != P0 f ({conservation:.3e})")
    err = check_plane_spmv_at(d.stencil_system(), f"ESV2007 level {ESV_LEVELS}")
    log("esv2007_eoc", table_levels="0-3 ok (errors, estimators)",
        eff_ESV2007=repr([round(e, 4) for e in eff]),
        **{f"eoc_{k}": repr([round(e, 4) for e in v]) for k, v in eocs.items()},
        rt0_conservation_max_rel_dev=f"{conservation:.3e}",
        rt0_reconstruction_seconds=f"{rt0_seconds:.3f}",
        plane_spmv_f64_max_abs_err=f"{err:.3e}", card=repr(card()))
    return launches, err, tc


def phase_esv2007_cg(dev, tc):
    """The CG-P1 EOC study on the same ESV2007 hierarchy, levels 0-6 (up to
    263k vertex DoF), Jacobi CG to 1e-12: EOC above 1.85 (L2) and 0.95
    (H1_semi) from level 2 on."""
    from dune_hdd_tpu_torch.discretizations import CGDiscretization
    from dune_hdd_tpu_torch.studies import EocStudy

    max_iter = 100000
    options = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": max_iter}
    torch.cuda.reset_peak_memory_stats()
    study = EocStudy(tc, CGDiscretization, solver_options=options, device=dev)
    results = study.run(verbose=False)
    for r, info in enumerate(study.level_info):
        log("esv2007_cg_level", level=r, dofs=info["num_dofs"],
            **{k: f"{results[k][r]:.6e}" for k in results},
            iterations=info["iterations"], time_to_solution=f"{study.time_to_solution[r]:.3f}",
            assembly_seconds=f"{info['assembly_seconds']:.3f}",
            solve_seconds=f"{info['solve_seconds']:.3f}")
        if not (info["type"] == "cg.jacobi" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"level {r}: {info}")
    eoc_l2, eoc_h1 = study.eoc("L2"), study.eoc("H1_semi")
    if not (min(eoc_l2[2:]) >= 1.85 and min(eoc_h1[2:]) >= 0.95):
        raise AssertionError(f"CG EOC L2 {eoc_l2}, H1_semi {eoc_h1}")
    log("esv2007_cg_eoc", gated_from_level=2, eoc_L2=repr([round(e, 4) for e in eoc_l2]),
        eoc_H1_semi=repr([round(e, 4) for e in eoc_h1]),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))


BLOCK_PARTITIONS = ((1, 1), (2, 2), (4, 4), (8, 8))
BLOCK_TABLE_LEVELS = 4  # levels 0-3 against the published block table
BLOCK_TYPES = ("eta_NC_OS2014", "eta_R_OS2014", "eta_DF_OS2014", "eta_DF_OS2014_*", "eta_OS2014")


def partitioning(part) -> str:
    return f"[{part[0]} {part[1]} 1]"


def phase_block_esv2007_table(dev, tc):
    """BlockSWIPDG on the ESV2007 hierarchy (``tc``'s levels): the
    partitionings [1 1 1], [2 2 1], [4 4 1] and [8 8 1] at levels 0-3, each
    level's global system solved by stencil_cg (plane_spmv in float64, the
    4x4 macro, 1e-12) and the OS2014 estimators and eff_OS2014 held to the
    published block table (6e-3).  The block solve is the global SWIPDG
    solve, which the partitioning does not enter: each level is solved once,
    through the first partitioning, and the others reuse that solution.
    Then [8 8 1] at levels 4 to the last, with EOC(eta_OS2014) >= 0.95
    from level 3 on and eff_OS2014 within 1e-2 of 1.80.  The launch count is
    set to 0 just before and read just after.  Returns (launches, the
    kernel's max abs error on the last level's operator)."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.ops.norms import error_norms
    from dune_hdd_tpu_torch.studies import eoc_rates, expected_results

    max_iter = 50000
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": max_iter, "macro": (4, 4)}
    torch.cuda.reset_peak_memory_stats()
    plane_spmv.launches = 0
    t_phase = time.perf_counter()

    def build_and_solve(grid, part, u=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = BlockSWIPDGDiscretization(grid, tc.boundary_info(), tc.problem, num_partitions=part,
                                      device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = {}
        if u is None:
            u = d.solve(options=options)
            torch.cuda.synchronize()
            info = d.last_solve_info
            if not (info["type"] == "stencil_cg" and 0 < info["iterations"] < max_iter):
                raise AssertionError(f"{partitioning(part)} level grid {grid}: {info}")
        return d, u, dict(info, assembly_seconds=t1 - t0, solve_seconds=time.perf_counter() - t1)

    def estimates(d, u):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = {t: BlockSWIPDGEstimators.estimate(d, u, t) for t in BLOCK_TYPES}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        vals["eff_OS2014"] = vals["eta_OS2014"] / error_norms(d.space, u,
                                                              tc.exact_solution)["H1_semi"]
        return vals, seconds

    def log_level(part, level, d, vals, seconds, info):
        log("block_esv2007_level", partitioning=repr(partitioning(part)), level=level,
            dofs=d.space.num_dofs, subdomains=d.num_subdomains(),
            **{k: f"{v:.6e}" for k, v in vals.items()}, iterations=info.get("iterations", "reused"),
            assembly_seconds=f"{info['assembly_seconds']:.3f}",
            solve_seconds=f"{info['solve_seconds']:.3f}", estimator_seconds=f"{seconds:.3f}")

    table = {}
    for level in range(BLOCK_TABLE_LEVELS):
        grid, u = tc.level_grid(level), None
        for part in BLOCK_PARTITIONS:
            d, u, info = build_and_solve(grid, part, u)
            vals, seconds = estimates(d, u)
            table[part, level] = vals
            log_level(part, level, d, vals, seconds, info)
    for part in BLOCK_PARTITIONS:
        for t in BLOCK_TYPES + ("eff_OS2014",):
            got = [table[part, level][t] for level in range(BLOCK_TABLE_LEVELS)]
            want = expected_results(f"ESV2007Multiscale.{partitioning(part)}", "alu_conforming",
                                    1, t)
            if not np.allclose(got, want, rtol=6e-3, atol=0):
                raise AssertionError(f"{partitioning(part)} {t}: {got} != {want} (rel 6e-3)")

    deep = (8, 8)
    for level in range(BLOCK_TABLE_LEVELS, tc.num_refinements + 1):
        d, u, info = build_and_solve(tc.level_grid(level), deep)
        vals, seconds = estimates(d, u)
        table[deep, level] = vals
        log_level(deep, level, d, vals, seconds, info)
        del u
    launches = plane_spmv.launches
    levels = range(BLOCK_TABLE_LEVELS - 1, tc.num_refinements + 1)
    eoc = eoc_rates([table[deep, level]["eta_OS2014"] for level in levels])
    eff = [table[deep, level]["eff_OS2014"] for level in levels]
    if not (min(eoc) >= 0.95 and max(abs(e - 1.80) for e in eff) <= 1e-2):
        raise AssertionError(f"[8 8 1]: EOC(eta_OS2014) {eoc}, eff_OS2014 {eff}")
    if launches <= 0:
        raise AssertionError("the block study did not launch plane_spmv")
    err = check_plane_spmv_at(d._global.stencil_system(), f"block ESV2007 level {level} [8 8 1]")
    log("block_esv2007_table", table_levels=f"0-{BLOCK_TABLE_LEVELS - 1} ok (6e-3)",
        partitionings=repr([partitioning(p) for p in BLOCK_PARTITIONS]),
        deep=f"[8 8 1] levels {BLOCK_TABLE_LEVELS}-{tc.num_refinements}",
        eoc_eta_OS2014=repr([round(e, 4) for e in eoc]),
        eff_OS2014=repr([round(e, 4) for e in eff]), launches=launches,
        plane_spmv_f64_max_abs_err=f"{err:.3e}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        seconds=f"{time.perf_counter() - t_phase:.2f}", card=repr(card()))
    return launches, err


OS2014_TRIPLES = ((0.1, 0.1, 0.1), (1.0, 1.0, 0.1), (0.1, 0.1, 1.0), (1.0, 1.0, 1.0))
# the published parametric block table at mu = 1, levels 0-1
# (test/linearelliptic-block-swipdg-expectations_os2014_2daluconform.cxx)
OS2014_PUBLISHED = {
    (1.0, 1.0, 0.1): {"eta_DF_OS2014": [1.36, 1.33], "eta_DF_OS2014_*": [0.413, 0.205],
                      "eta_OS2014": [4.71, 4.42], "eta_OS2014_*": [0.550, 0.271]},
    (1.0, 1.0, 1.0): {"eta_DF_OS2014": [0.355, 0.176], "eta_DF_OS2014_*": [0.355, 0.176],
                      "eta_OS2014": [0.774, 0.382], "eta_OS2014_*": [0.774, 0.382]},
}


def triple_key(triple) -> str:
    mu, bar, hat = (f"{v:g}" for v in triple)
    return f"mu{mu}_bar{bar}_hat{hat}"


def phase_os2014_parametric(dev, levels=2):
    """The OS2014 parametric [4 4 1] block study at levels 0-1 at the four
    (mu, mu_bar, mu_hat) triples, one direct solve per level and distinct
    mu: every recorded estimator within 2e-3 of the JAX-recorded values
    (studies/expectations.py) and, at mu = 1, within 3.5e-3 of the
    published ones."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.studies import expected_results
    from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase

    t_phase = time.perf_counter()
    types = ("eta_DF_OS2014", "eta_DF_OS2014_*", "eta_OS2014", "eta_OS2014_*")
    discs, solutions = {}, {}
    for triple in OS2014_TRIPLES:
        mu, bar, hat = triple
        tc = OS2014MultiscaleTestCase({"mu": mu, "mu_bar": bar, "mu_hat": hat,
                                       "mu_minimizing": 0.1}, num_partitions=(4, 4),
                                      num_refinements=levels - 1)
        pars = tc.estimator_parameters()
        values = {t: [] for t in types}
        for level in range(levels):
            if level not in discs:
                discs[level] = BlockSWIPDGDiscretization(
                    tc.level_grid(level), tc.boundary_info(), tc.problem, num_partitions=(4, 4),
                    device=dev)
            d = discs[level]
            if (level, mu) not in solutions:
                solutions[level, mu] = d.solve(tc.parameters["mu"], options={"type": "direct"})
            for t in types:
                values[t].append(BlockSWIPDGEstimators.estimate(d, solutions[level, mu], t, pars))
        key = f"OS2014.block.[4 4 1].{triple_key(triple)}"
        for t, got in values.items():
            want = expected_results(key, "alu_conforming", 1, t)
            if want is not None and not np.allclose(got, want, rtol=2e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != recorded {want} (rel 2e-3)")
            published = OS2014_PUBLISHED.get(triple, {}).get(t)
            if published is not None and not np.allclose(got, published, rtol=3.5e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != published {published} (rel 3.5e-3)")
        log("os2014_parametric", triple=repr(triple), scheme=discs[0]._scheme,
            dofs=repr([discs[r].space.num_dofs for r in range(levels)]),
            **{t: repr([round(v, 6) for v in vals]) for t, vals in values.items()})
    log("os2014_parametric_done", triples=len(OS2014_TRIPLES), solves=len(solutions),
        seconds=f"{time.perf_counter() - t_phase:.2f}", card=repr(card()))


def phase_spe10_parametric_block(dev, num_refinements=1):
    """The SPE10 parametric [20 4 1] block study at reference scale
    (tests/test_spe10_study.py): the 100 x 20 macro grid at levels 0-1
    against the level-2 reference solution (384,000 DoF), solver direct,
    through EocStudy once per distinct mu (0.1 and 1); the other two
    triples evaluate their estimators on the same solutions.  energy,
    eta_OS2014 and eta_OS2014_* within 2e-3 of the recorded values
    (studies/expectations.py); eta_OS2014 == eta_OS2014_* at mu_hat = mu;
    otherwise the plain estimate stagnates and the star one converges."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.studies import EocStudy, expected_results
    from dune_hdd_tpu_torch.testcases.spe10 import Spe10ParametricBlockModel1TestCase

    t_phase = time.perf_counter()
    types = ("eta_OS2014", "eta_OS2014_*")
    part = (20, 4)
    studies = {}

    def factory(grid, bi, problem, device):
        return BlockSWIPDGDiscretization(grid, bi, problem, num_partitions=part, device=device)

    for triple in sorted(OS2014_TRIPLES, key=lambda t: t[0] != t[2]):  # mu_hat = mu first
        mu, bar, hat = triple
        tc = Spe10ParametricBlockModel1TestCase(
            {"mu": mu, "mu_bar": bar, "mu_hat": hat, "mu_minimizing": 0.1},
            num_partitions=part, num_refinements=num_refinements)
        pars = tc.estimator_parameters()
        t0 = time.perf_counter()
        solved_now = mu not in studies
        if solved_now:
            study = EocStudy(tc, factory, norms=("energy",), estimator_types=types,
                             estimate_fn=lambda d, u, t, level: BlockSWIPDGEstimators.estimate(
                                 d, u, t, pars),
                             mu=tc.parameters["mu"], energy_mu=tc.parameters["mu"],
                             solver_options={"type": "direct"}, device=dev)
            res = study.run(verbose=False)
            studies[mu] = study
        else:
            study = studies[mu]
            res = {"energy": study.results["energy"],
                   **{t: [BlockSWIPDGEstimators.estimate(d, u, t, pars)
                          for d, u in zip(study.discretizations, study.solutions)]
                      for t in types}}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        key = f"Spe10.parametric_block.{partitioning(part)}.{triple_key(triple)}"
        for t, got in res.items():
            want = expected_results(key, "alu_conforming", 1,
                                    "energy_mu" if t == "energy" else t)
            if not np.allclose(got, want, rtol=2e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != recorded {want} (rel 2e-3)")
        if hat == mu:
            if not np.allclose(res["eta_OS2014"], res["eta_OS2014_*"], rtol=1e-6, atol=0):
                raise AssertionError(f"{key}: eta_OS2014 != eta_OS2014_* at mu_hat = mu")
        elif not (res["eta_OS2014"][1] / res["eta_OS2014"][0] > 0.8
                  and np.log2(res["eta_OS2014_*"][0] / res["eta_OS2014_*"][1]) > 0.9):
            raise AssertionError(f"{key}: the plain estimate does not stagnate or the star "
                                 f"one does not converge: {res}")
        info = study.level_info
        log("spe10_parametric_block", triple=repr(triple), scheme=study.discretizations[0]._scheme,
            dofs=repr([i["num_dofs"] for i in info]),
            reference_dofs=tc.reference_grid.num_cells * 3,
            **{t: repr([round(v, 6) for v in vals]) for t, vals in res.items()},
            solved_now=solved_now,
            level_solve_seconds=repr([round(i["solve_seconds"], 3) for i in info]),
            seconds=f"{seconds:.2f}")
    log("spe10_parametric_block_done", solves=len(studies),
        seconds=f"{time.perf_counter() - t_phase:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))


def phase_block_provenance(dev, bisections=6, larger=8):
    """block_provenance_check: the bench's stencil operator and rhs (f32,
    applied through plane_spmv) against the BlockSWIPDG [20 4 1] global
    system assembled from its 80 local operators and pairwise couplings
    (f64) at ``bisections`` (768,000 DoF) and at ``larger`` bisections
    (3,072,000 DoF), rel_op and rel_rhs <= 1e-4.  The launch count is set
    to 0 just before and read just after each check.  Returns the
    launches."""
    from dune_hdd_tpu_torch.bench_harness import block_provenance_check
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    launches = 0
    for b in (bisections, larger):
        reset_timings()
        torch.cuda.reset_peak_memory_stats()
        plane_spmv.launches = 0
        t0 = time.perf_counter()
        r = block_provenance_check(bisections=b, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = plane_spmv.launches
        if n < 3:
            raise AssertionError(f"provenance at {b} bisections: {n} plane_spmv launches < 3")
        launches += n
        host = timings()
        log("block_provenance", **{k: v for k, v in r.items() if k not in ("rel_op", "rel_rhs")},
            rel_op=f"{r['rel_op']:.3e}", rel_rhs=f"{r['rel_rhs']:.3e}",
            locals_seconds=f"{sum(host['block.locals']):.2f}",
            couplings_seconds=f"{sum(host['block.couplings']):.2f}", seconds=f"{seconds:.2f}",
            launches=n, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            card=repr(card()))
        torch.cuda.empty_cache()
    return launches


def phase_thermalblock_online(dev, seed=17, count=8, bisections=14):
    """SWIPDG with the 2x2 thermalblock at 14 bisections (1,572,864 DoF, all
    Dirichlet) through make_solve_fn at ``count`` values of mu drawn from
    [0.1, 1]^4, each rechecked on the unscaled float64 system with the plain
    SparseMatrix.matvec; one mu also through stencil_cg.  The launch count
    is set to 0 just before and read just after.  Returns (launches, the
    kernel's max abs error on this operator, (the grid, the mu [count, 4],
    the solutions))."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    torch.cuda.reset_peak_memory_stats()
    plane_spmv.launches = 0
    t0 = time.perf_counter()
    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=bisections)
    t1 = time.perf_counter()
    d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    solve_fn, thetas = d.make_solve_fn(tol=1e-8, maxiter=50000, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log("thermalblock_setup", dofs=d.space.num_dofs, scheme=d.scheme,
        grid_host_seconds=f"{t1 - t0:.2f}", assembly_seconds=f"{t2 - t1:.2f}",
        block_ell_stack_seconds=f"{t3 - t2:.2f}")
    mus = np.random.default_rng(seed).uniform(0.1, 1.0, (count, 4))
    solutions = []
    for i, mu in enumerate(mus):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, res, iters = solve_fn(*thetas(mu))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        A, b = d.freeze_operator(mu), d.freeze_rhs(mu)
        recheck = (torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b)).item()
        del A, b
        log("thermalblock_solve", i=i, mu=repr([round(float(m), 6) for m in mu]),
            iterations=iters, seconds=f"{seconds:.3f}", recurrence_residual=f"{float(res):.3e}",
            residual_f64_recheck=f"{recheck:.3e}")
        if not (recheck <= 1e-7 and iters < 50000 and bool(torch.isfinite(u).all())):
            raise AssertionError(f"mu {mu}: residual {recheck:.3e}, {iters} iterations")
        solutions.append(u)
    first = solutions[0]
    t0 = time.perf_counter()
    u_st = d.solve(mus[0], options={"type": "stencil_cg", "precision": 1e-8, "max_iter": 50000})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = plane_spmv.launches
    info = d.last_solve_info
    diff = ((u_st - first).abs().max() / first.abs().max()).item()
    if not (info["type"] == "stencil_cg" and diff <= 1e-5 and launches > 0):
        raise AssertionError(f"stencil_cg: {info}, rel diff {diff:.3e}, {launches} launches")
    peak = torch.cuda.max_memory_allocated() / 1e9
    err = check_plane_spmv_at(d.stencil_system(mus[0]), "thermalblock 14 bisections")
    time_general_spmvs(d, mus[0], first)
    log("thermalblock_stencil_cg", iterations=info["iterations"], seconds=f"{seconds:.3f}",
        rel_max_diff_vs_block_cg=f"{diff:.3e}", launches=launches, peak_gb=f"{peak:.2f}",
        plane_spmv_f64_max_abs_err=f"{err:.3e}", card=repr(card()))
    phase_thermalblock_estimators(d, mus[0], first)
    return launches, err, (grid, mus, solutions)


def phase_thermalblock_estimators(d, mu, u):
    """RT0 local conservation and eta_ESV2007 (mu_hat = 1) on the 1.57M-DoF
    thermalblock at mu.  The 2x2 thermalblock has no affine part, so the
    discretization runs the penalty_mu scheme: its assembled flux is the
    frozen diffusion's with the scheme's fixed weights (``weight_diffusion``),
    and that reconstruction must be conservative; the per-component
    reconstruction="scheme" (the reference scheme's flux) is logged beside
    it, not gated."""
    from dune_hdd_tpu_torch.estimators import SWIPDGEstimators, scheme_flux_parts

    if d.scheme != "penalty_mu":
        raise AssertionError(f"thermalblock scheme {d.scheme}, expected penalty_mu")
    wlam, wkap = d._weight_diffusion
    conservation, rt0_seconds = rt0_conservation(d, u, mu, weight_lam_fn=wlam, weight_kap_fn=wkap)
    if not conservation <= 1e-5:
        raise AssertionError(f"thermalblock: div t_h != P0 f ({conservation:.3e})")
    other, _ = rt0_conservation(d, u, mu, flux_parts=scheme_flux_parts(d.problem, mu))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eta = SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, u, "eta_ESV2007", mu=mu,
                                    mu_hat=np.ones(4), weight_diffusion=d._weight_diffusion)
    seconds = time.perf_counter() - t0
    if not (np.isfinite(eta) and eta > 0):
        raise AssertionError(f"thermalblock eta_ESV2007 = {eta}")
    log("thermalblock_estimators", dofs=d.space.num_dofs, mu=repr([round(float(m), 6) for m in mu]),
        rt0_conservation_max_rel_dev=f"{conservation:.3e}",
        rt0_reconstruction_seconds=f"{rt0_seconds:.3f}",
        per_component_reconstruction_max_rel_dev=f"{other:.3e}",
        eta_ESV2007_mu_hat_1=f"{eta:.6e}", eta_ESV2007_seconds=f"{seconds:.3f}",
        card=repr(card()))


RB_TRAINING = 64      # random training parameters from [0.1, 1]^4
RB_EXTENSIONS = 10
LRBMS_EXTENSIONS = 4
RB_ONLINE_MUS = 1024  # the batched online sweep
# the largest relative h1_semi error of each reduced model at the 8 test mu:
# the reference's generalization bar (tests/test_mor.py:79) made relative for
# the RB model (8.98e-3 on the card); 4 LRBMS extensions reach 1.349e-1 there
# (PERF.md §6), so its bar is that measurement with a 1.5x margin
RB_REL_H1_BAR = 1e-2
LRBMS_REL_H1_BAR = 2e-1


def rel_norm(e, u, matrix) -> float:
    """sqrt(e A e) / sqrt(u A u)."""
    return float(torch.sqrt(e @ matrix.matvec(e)) / torch.sqrt(u @ matrix.matvec(u)))


def block_supported(d, basis) -> bool:
    """Every basis row is nonzero on one subdomain's DoFs only."""
    sub = torch.as_tensor(np.asarray(d.ms_grid.subdomain_of, dtype=np.int64)).to(basis.device)
    sub = sub.repeat_interleave(d.space.shape_count)
    nz = basis != 0
    big, small = torch.iinfo(torch.int64).max, -1
    lo = torch.where(nz, sub[None, :], big).min(dim=1).values
    hi = torch.where(nz, sub[None, :], small).max(dim=1).values
    return bool((nz.any(dim=1) & (lo == hi)).all())


def phase_rb_thermalblock(dev, grid, mus, solutions, seed=6):
    """The reference's RB workflow (perform_standard_rb / perform_lrbms /
    test_quality) on the 2x2 thermalblock BlockSWIPDG [2 2] at 1,572,864
    DoF, on ``thermalblock_online``'s grid: greedy_rb (Riesz h1_semi
    estimator with min-theta coercivity, gram_schmidt, RB_EXTENSIONS) and
    greedy_lrbms (Riesz, LRBMS_EXTENSIONS) over RB_TRAINING random mu, every
    snapshot by stencil_cg on plane_spmv; both models against the detailed
    solutions at ``mus`` (relative h1_semi and mu-energy errors); one
    selected snapshot reproduced to 1e-6; the batched online sweep over
    RB_ONLINE_MUS mu timed beside single solves and held to the loop at
    1e-10 on 16 of them; save/load bitwise.  The launch count is set to 0
    just before and read just after.  Returns the launches."""
    import tempfile

    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.mor import (
        greedy_lrbms, greedy_rb, load_reduced_model, sample_randomly, save_reduced_model)
    from dune_hdd_tpu_torch.mor.batch import (
        batched_estimates, batched_reduced_solve, stack_parameters)
    from dune_hdd_tpu_torch.problems import ThermalblockProblem
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    torch.cuda.reset_peak_memory_stats()
    reset_timings()
    t_phase = time.perf_counter()
    d = BlockSWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                  ThermalblockProblem((2, 2)), num_partitions=(2, 2), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    infos = []
    uncached = d.uncached_solve

    def recording_solve(mu, options=None):
        u = uncached(mu, options)
        infos.append(dict(d.last_solve_info))
        return u

    d.uncached_solve = recording_solve
    training = sample_randomly(d.parameter_type, 0.1, 1.0, RB_TRAINING, seed=seed)
    opts = {"type": "stencil_cg", "precision": 1e-8, "max_iter": 50000}
    plane_spmv.launches = 0
    results, seconds = {}, {}
    for name, fn, kw in (
            ("rb", greedy_rb, dict(max_extensions=RB_EXTENSIONS, extension_algorithm="gram_schmidt",
                                   coercivity="min_theta")),
            ("lrbms", greedy_lrbms, dict(max_extensions=LRBMS_EXTENSIONS))):
        t0 = time.perf_counter()
        res = fn(d, training, use_estimator="riesz", error_norm="h1_semi", solver_options=opts,
                 **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        results[name] = res
        split = {k[4:]: sum(v) for k, v in timings().items() if k.startswith("mor.")}
        reset_timings()
        log("rb_greedy", model=name, dofs=d.space.num_dofs, training=len(training),
            extensions=res.extensions, basis_size=res.basis.shape[0],
            selected=repr([next(i for i, m in enumerate(training) if m is mu)
                           for mu in res.selected_mus]),
            max_errors=repr([float(f"{e:.6e}") for e in res.max_errors]),
            seconds=f"{seconds[name]:.2f}",
            **{f"{k}_seconds": f"{v:.2f}" for k, v in split.items()},
            riesz_row_cache_hits=res.estimator.cache_hits,
            riesz_row_cache_misses=res.estimator.cache_misses,
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    launches = plane_spmv.launches
    d.uncached_solve = uncached
    rb, lrbms = results["rb"], results["lrbms"]
    if not (rb.extensions == RB_EXTENSIONS and lrbms.extensions == LRBMS_EXTENSIONS):
        raise AssertionError(f"extensions {rb.extensions}, {lrbms.extensions}")
    if not (infos and all(i["type"] == "stencil_cg" and i["iterations"] < 50000 for i in infos)
            and launches > 0):
        raise AssertionError(f"snapshot solves {infos}, {launches} plane_spmv launches")
    if not block_supported(d, lrbms.basis):
        raise AssertionError("an LRBMS basis row spans two subdomains")

    # quality at thermalblock_online's mu against its detailed solutions
    h1 = d.product_matrix("h1_semi")
    errors = {name: {"h1_semi": [], "energy": []} for name in results}
    for mu, u in zip(mus, solutions):
        mp = d.problem.parse_parameter(mu)
        A = d.freeze_operator(mp)
        for name, res in results.items():
            rm = res.reduced_model
            e = u - rm.reconstruct(rm.solve(mp))
            errors[name]["h1_semi"].append(rel_norm(e, u, h1))
            errors[name]["energy"].append(rel_norm(e, u, A))
        del A
    mu0 = rb.selected_mus[0]
    snapshot = d.solve(mu0, options=opts)  # cached
    u_rb = rb.reduced_model.reconstruct(rb.reduced_model.solve(mu0))
    reproduction = rel_norm(snapshot - u_rb, snapshot, h1)
    for name in results:
        log("rb_quality", model=name, test_mu=len(mus),
            rel_h1_semi=repr([float(f"{e:.4e}") for e in errors[name]["h1_semi"]]),
            rel_energy=repr([float(f"{e:.4e}") for e in errors[name]["energy"]]),
            max_rel_h1_semi=f"{max(errors[name]['h1_semi']):.4e}")
    log("rb_snapshot_reproduction", rel_h1_semi=f"{reproduction:.3e}")
    if not (max(errors["rb"]["h1_semi"]) <= RB_REL_H1_BAR
            and max(errors["lrbms"]["h1_semi"]) <= LRBMS_REL_H1_BAR and reproduction <= 1e-6):
        raise AssertionError(f"RB quality: {errors}, reproduction {reproduction:.3e}")

    # the online payoff: batched sweep against single solves
    rm = rb.reduced_model
    online = rb.estimator.offline(rb.basis)  # every row cached
    sweep = [{"diffusion_factor": m}
             for m in np.random.default_rng(seed + 1).uniform(0.1, 1.0, (RB_ONLINE_MUS, 4))]
    stacked = stack_parameters(d.problem, sweep)
    t0 = time.perf_counter()
    # alpha_LB per mu, evaluated once per parameter set as greedy_rb does
    coercivities = np.asarray([float(online.coercivity(d.problem.parse_parameter(mu)))
                               for mu in sweep])
    coercivity_s = time.perf_counter() - t0

    def timed_call(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    C, solve_s = timed_call(lambda: batched_reduced_solve(rm, stacked))
    etas, estimate_s = timed_call(lambda: batched_estimates(online, rm, stacked, coercivities))
    _, single_s = timed_call(lambda: [rm.solve(mu) for mu in sweep[:16]])
    loop_C = torch.stack([rm.solve(mu) for mu in sweep[:16]])
    loop_eta = np.asarray([online.estimate(mu, rm.solve(mu)) for mu in sweep[:16]])
    rel_C = ((C[:16] - loop_C).abs().max() / loop_C.abs().max()).item()
    rel_eta = float(np.abs(etas[:16] - loop_eta).max() / np.abs(loop_eta).max())
    log("rb_online", mus=RB_ONLINE_MUS, basis_size=rm.dim,
        batched_solve_seconds=f"{solve_s:.4f}",
        batched_solve_us_per_mu=f"{solve_s / RB_ONLINE_MUS * 1e6:.2f}",
        batched_estimate_seconds=f"{estimate_s:.4f}",
        batched_estimate_us_per_mu=f"{estimate_s / RB_ONLINE_MUS * 1e6:.2f}",
        single_solve_us_per_mu=f"{single_s / 16 * 1e6:.2f}",
        coercivity_us_per_mu=f"{coercivity_s / RB_ONLINE_MUS * 1e6:.2f}",
        rel_diff_batched_vs_loop_solve=f"{rel_C:.3e}",
        rel_diff_batched_vs_loop_estimate=f"{rel_eta:.3e}", card=repr(card()))
    if not (rel_C <= 1e-10 and rel_eta <= 1e-10 and np.isfinite(etas).all()):
        raise AssertionError(f"batched vs loop: solve {rel_C:.3e}, estimate {rel_eta:.3e}")

    with tempfile.TemporaryDirectory() as tmp:
        path = save_reduced_model(rm, f"{tmp}/rb_thermalblock")
        back = load_reduced_model(path, device=dev)
    if not all(torch.equal(back.solve(mu), rm.solve(mu)) for mu in sweep[:4]):
        raise AssertionError("the reloaded reduced model solves differently")
    log("rb_thermalblock_done", build_seconds=f"{build_s:.2f}",
        rb_seconds=f"{seconds['rb']:.2f}", lrbms_seconds=f"{seconds['lrbms']:.2f}",
        snapshot_solves=len(infos), snapshot_iterations=repr([i["iterations"] for i in infos]),
        launches=launches, save_load="bitwise",
        seconds=f"{time.perf_counter() - t_phase:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    return launches


def phase_adaptive_spe10(dev):
    """The recorded adaptive LRBMS trajectory: SPE10 parametric [20 4 1] at
    level 0 (24,000 DoF) with 2 oversampling layers, snapshot bases at
    mu = 1, Doerfler(0.85) enrichment at mu = 0.1, two enrichments, direct
    solves; true_h1_semi, eta_OS2014_* and rb_bound_energy (the energy-
    product Riesz bound at mu_bar with min-theta coercivity) within 5% of
    the recorded values (studies/expectations.py), the rb bound falling, the
    first Doerfler set meeting the channel subdomains 46-55."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.mor import adaptive_lrbms, snapshot_local_bases
    from dune_hdd_tpu_torch.studies import expected_results
    from dune_hdd_tpu_torch.testcases.spe10 import Spe10ParametricBlockModel1TestCase

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mu = {"mu": 0.1, "mu_bar": 0.1, "mu_hat": 0.1, "mu_minimizing": 0.1}
    tc = Spe10ParametricBlockModel1TestCase(mu, num_partitions=(20, 4), num_refinements=0,
                                            oversampling_layers=2)
    d = BlockSWIPDGDiscretization(tc.level_grid(0), tc.boundary_info(), tc.problem,
                                  num_partitions=(20, 4), oversampling_layers=2, device=dev)
    init = snapshot_local_bases(d, 1.0)
    res = adaptive_lrbms(d, 0.1, tc.estimator_parameters(), initial_local_bases=init,
                         max_enrichments=2, target_estimate=1e-6, marking=("doerfler", 0.85),
                         track_true_errors=True, solver_options={"type": "direct"})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    key = "Spe10.adaptive.[20 4 1].mu0.1"
    got = {"true_h1_semi": res.true_errors, "eta_OS2014_*": res.estimates,
           "rb_bound_energy": res.rb_bounds}
    log("adaptive_spe10", dofs=d.space.num_dofs, subdomains=d.num_subdomains(),
        **{k: repr([round(float(v), 6) for v in vals]) for k, vals in got.items()},
        enriched=repr([len(s) for s in res.enriched_subdomains]),
        first_set=repr(sorted(res.enriched_subdomains[0])), seconds=f"{seconds:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    for k, vals in got.items():
        want = expected_results(key, "alu_conforming", 1, k)
        if not np.allclose(vals, want, rtol=0.05, atol=0):
            raise AssertionError(f"{key} {k}: {vals} != recorded {want} (rel 5e-2)")
    if not (np.all(np.diff(res.rb_bounds) < 0)
            and set(res.enriched_subdomains[0]) & set(range(46, 56))):
        raise AssertionError(f"{key}: rb bounds {res.rb_bounds}, "
                             f"first set {res.enriched_subdomains[0]}")


def phase_adaptive_os2014(dev):
    """The reference test's adaptive enrichment: OS2014 multiscale [2 2] at
    level 0 with 3 oversampling layers, six worst-subdomain enrichments at
    mu = 0.3: the true error below 0.25x and the estimate below 0.5x their
    first values, the rb bound falling to below 0.15x, and at least 0.3x
    the true error throughout."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.mor import adaptive_lrbms
    from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase

    t0 = time.perf_counter()
    tc = OS2014MultiscaleTestCase({"mu": 0.3, "mu_bar": 0.3, "mu_hat": 0.1,
                                   "mu_minimizing": 0.1},
                                  num_partitions=(2, 2), num_refinements=0, oversampling_layers=3)
    d = BlockSWIPDGDiscretization(tc.level_grid(0), tc.boundary_info(), tc.problem,
                                  num_partitions=(2, 2), oversampling_layers=3, device=dev)
    res = adaptive_lrbms(d, tc.parameters["mu"], tc.estimator_parameters(), max_enrichments=6,
                         target_estimate=1e-6, track_true_errors=True)
    torch.cuda.synchronize()
    true, est, rb = (np.asarray(v) for v in (res.true_errors, res.estimates, res.rb_bounds))
    log("adaptive_os2014", dofs=d.space.num_dofs, layers=3,
        true_h1_semi=repr([round(float(v), 6) for v in true]),
        eta_OS2014_star=repr([round(float(v), 6) for v in est]),
        rb_bound_energy=repr([round(float(v), 6) for v in rb]),
        enriched=repr(res.enriched_subdomains), seconds=f"{time.perf_counter() - t0:.2f}",
        card=repr(card()))
    if not (true[-1] < 0.25 * true[0] and est[-1] < 0.5 * est[0]
            and len(res.enriched_subdomains) == 6 and set(res.enriched_subdomains) <= set(range(4))
            and rb.shape == (7,) and np.all(np.diff(rb) < 0) and rb[-1] < 0.15 * rb[0]
            and np.all(rb >= 0.3 * true)):
        raise AssertionError(f"adaptive OS2014: true {true}, estimates {est}, rb {rb}, "
                             f"enriched {res.enriched_subdomains}")


def count_device_ops(fn):
    """Kernels and copies one call puts on the card, from torch.profiler's
    device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def time_general_spmvs(d, mu, like):
    """Device time of the general path's two plain-torch SpMVs (candidates
    for later hand kernels) on the frozen float64 operator: the scalar ELL
    SparseMatrix.matvec and the block-ELL BlockEllMatrix.matvec; bytes =
    values + column indices + x + y."""
    from dune_hdd_tpu_torch.la.block_ell import block_ell_from_sparse

    A = d.freeze_operator(mu)
    Ab = block_ell_from_sparse(d.space, A)
    gen = torch.Generator(device="cpu").manual_seed(18)
    x = torch.randn(like.shape, generator=gen, dtype=like.dtype).to(like.device)
    rel_check("BlockEllMatrix.matvec vs SparseMatrix.matvec", Ab.matvec(x), A.matvec(x), 1e-12)
    n, k = A.ell.shape
    cases = {"SparseMatrix.matvec": (lambda: A.matvec(x), n * k * 16 + 2 * n * 8),
             "BlockEllMatrix.matvec": (lambda: Ab.matvec(x),
                                       Ab.blocks.numel() * 8 + Ab.neighbors.size * 8 + 2 * n * 8)}
    for name, (fn, nbytes) in cases.items():
        ms = time_calls(fn)
        log("plain_spmv_timing", op=name, dofs=n, float64=True, us=f"{ms * 1e3:.2f}",
            device_ops_per_call=count_device_ops(fn),
            bytes=nbytes, gbps=f"{nbytes / ms / 1e6:.1f}",
            bound_us=f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f}", card=repr(card()))


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    bench6, S6, B6, plane_err = phase_plane_vs_plain(dev)
    A6, b6, structured_err = phase_structured_vs_plain(dev, bench6, S6, B6)
    probe_err = phase_probe_vs_plain(dev)

    launches = {"plane_spmv": 0}
    _, _, n = phase_main_path(dev, 6, repeats=3)
    launches["plane_spmv"] += n
    launches["structured_spmv"] = phase_structured_path(A6, S6, B6)
    launches["probe"] = phase_probe_path(dev)
    phase_kernel_path_vs_plain_path(dev)
    structured_ms, probe_ms, err = phase_timing_768k(dev, S6, B6, A6, b6)
    plane_err = max(plane_err, err)
    del bench6, S6, B6, A6, b6

    r, (S8, _), n = phase_main_path(dev, 8, repeats=3)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, phase_symmetric_checks(S8))
    del r, S8
    torch.cuda.empty_cache()

    r, (S10, B10), n = phase_main_path(dev, 10, repeats=3)
    launches["plane_spmv"] += n
    del r
    plane_times, err = time_plane_spmv(S10, B10, "12.29M symmetric", W=S10.sym_planes)
    plane_ms, plane_err = plane_times["float32"], max(plane_err, err)
    del S10, B10
    torch.cuda.empty_cache()

    n, err, tc = phase_esv2007_study(dev)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    phase_esv2007_cg(dev, tc)
    n, err = phase_block_esv2007_table(dev, tc)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, err)
    del tc
    torch.cuda.empty_cache()
    phase_os2014_parametric(dev)
    phase_spe10_parametric_block(dev)
    torch.cuda.empty_cache()
    launches["plane_spmv"] += phase_block_provenance(dev)
    n, err, thermalblock = phase_thermalblock_online(dev)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    launches["plane_spmv"] += phase_rb_thermalblock(dev, *thermalblock)
    del thermalblock
    torch.cuda.empty_cache()
    phase_adaptive_spe10(dev)
    phase_adaptive_os2014(dev)
    log("done", seconds=f"{time.perf_counter() - _T0:.1f}")

    rows = [("plane_spmv", plane_err, plane_ms), ("structured_spmv", structured_err, structured_ms),
            ("probe", probe_err, probe_ms)]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
        launches=launches[name], max_abs_err=err, **times) for name, err, times in rows]}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
