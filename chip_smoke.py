#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the three CUDA
kernels, checks each against its plain PyTorch version, drives the SPE10
SWIPDG assemble-and-solve bench at 768k, 3.07M and 12.29M DoF (6, 8 and 10
bisections) through the plane SpMV kernel, drives the structured SpMV and
the probe through their own entry points, times every kernel beside its
plain version and one library call that computes the same function, then
runs the ESV2007 EOC study (levels 0-6, up to 1.57M DoF) and 8 online
thermalblock solves at 1.57M DoF through the general parametric SWIPDG
path.  Exits non-zero if any phase fails or there is no card.

    python3 chip_smoke.py

Phases (one line of output each, each with its seconds): device, build,
kernel vs plain (plane SpMV at 6 and 2 bisections; structured SpMV on the
768k-DoF operator and on random blocks; probe), main path at 6 bisections,
structured path, probe path, kernel path vs plain path at 4 bisections,
kernel timing at 768k DoF, main path at 8 bisections with the symmetric
operator's checks, main path at 10 bisections with the plane SpMV checked
against its plain version and timed on the symmetric 12.29M-DoF planes, the
ESV2007 study (stencil_cg with the 4x4 macro: the table at levels 0-3, EOC
at 4-6) and the thermalblock online solves (block_cg through make_solve_fn,
each rechecked in float64, and one stencil_cg solve).  Then a JSON line of
the kernels, the card's name and power limit, and last {"ok": true, ...}.
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
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference

    rng = np.random.default_rng(13)
    err = 0.0
    for shape in ((64, 128), (1 << 24) + 3):
        x, y = (torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                for _ in range(2))
        o, o_ref = probe(x, y), probe_reference(x, y)
        err = max(err, rel_check("probe vs 2x + y", o, o_ref, 0.0))
        if not torch.equal(o, o_ref):
            raise AssertionError(f"probe differs from 2x + y bitwise at {shape}")
    log("kernel_vs_plain", kernel="probe", shapes=repr([(64, 128), (1 << 24) + 3]),
        max_abs_err=err, bitwise_equal=True)
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
    return st, pr[(64, 128)], plane_err


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


def phase_esv2007_study(dev):
    """The ESV2007 ALU-conforming SWIPDG EOC study through EocStudy with the
    stencil_cg option (plane_spmv in float64), levels 0-6; levels 0-3 against
    the published table, EOC above 1.9 (L2) and 0.95 (H1_semi) up to the
    last level.  The launch count is set to 0 just before and read just
    after.  Returns (launches, the kernel's max abs error at level 6)."""
    from types import SimpleNamespace

    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.studies import EocStudy, check_eoc_study_for_success
    from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    max_iter = 50000
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": max_iter, "macro": (4, 4)}
    reset_timings()
    torch.cuda.reset_peak_memory_stats()
    plane_spmv.launches = 0
    t0 = time.perf_counter()
    tc = ESV2007TestCase(num_refinements=ESV_LEVELS)
    hierarchy_s = time.perf_counter() - t0
    study = EocStudy(tc, SWIPDGDiscretization, solver_options=options, device=dev)
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
            solve_seconds=f"{info['solve_seconds']:.3f}")
        if not (info["type"] == "stencil_cg" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"level {r}: {info}")
    check_eoc_study_for_success(SimpleNamespace(results={k: v[:4] for k, v in results.items()}),
                                "ESV2007", "alu_conforming", 1)
    eoc_l2, eoc_h1 = study.eoc("L2"), study.eoc("H1_semi")
    if not (min(eoc_l2[3:]) > 1.9 and min(eoc_h1[3:]) > 0.95):
        raise AssertionError(f"EOC L2 {eoc_l2}, H1_semi {eoc_h1}")
    if launches <= 0:
        raise AssertionError("the study did not launch plane_spmv")
    err = check_plane_spmv_at(study.discretizations[-1].stencil_system(),
                              f"ESV2007 level {ESV_LEVELS}")
    log("esv2007_eoc", table_levels="0-3 ok", eoc_L2=repr([round(e, 4) for e in eoc_l2]),
        eoc_H1_semi=repr([round(e, 4) for e in eoc_h1]), plane_spmv_f64_max_abs_err=f"{err:.3e}",
        card=repr(card()))
    return launches, err


def phase_thermalblock_online(dev, seed=17, count=8, bisections=14):
    """SWIPDG with the 2x2 thermalblock at 14 bisections (1,572,864 DoF, all
    Dirichlet) through make_solve_fn at ``count`` values of mu drawn from
    [0.1, 1]^4, each rechecked on the unscaled float64 system with the plain
    SparseMatrix.matvec; one mu also through stencil_cg.  The launch count
    is set to 0 just before and read just after.  Returns (launches, the
    kernel's max abs error on this operator)."""
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
    first = None
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
        if first is None:
            first = u
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
    return launches, err


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

    n, err = phase_esv2007_study(dev)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    n, err = phase_thermalblock_online(dev)
    launches["plane_spmv"] += n
    plane_err = max(plane_err, err)
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
