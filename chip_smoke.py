#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the three CUDA
kernels, checks each against its plain PyTorch version, drives the SPE10
SWIPDG assemble-and-solve bench at 768k, 3.07M and 12.29M DoF (6, 8 and 10
bisections) through the plane SpMV kernel, drives the structured SpMV and
the probe through their own entry points, and times every kernel beside its
plain version.  Exits non-zero if any phase fails or there is no card.

    python3 chip_smoke.py

Phases (one line of output each, each with its seconds): device, build,
kernel vs plain (plane SpMV at 6 and 2 bisections; structured SpMV on the
768k-DoF operator and on random blocks; probe), main path at 6 bisections,
structured path, probe path, kernel path vs plain path at 4 bisections,
kernel timing at 768k DoF, main path at 8 bisections with the symmetric
operator's checks, main path at 10 bisections with the plane SpMV checked
against its plain version and timed on the symmetric 12.29M-DoF planes.  Then a JSON line of the kernels, the card's name and power
limit, and last {"ok": true, "device": {...}}.
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


def timed(kernel, label, fn, plain_fn, nbytes, **fields):
    """Times a kernel and its plain version; logs µs and GB/s under the
    bytes model; returns (ms, plain_ms)."""
    ms, plain_ms = time_calls(fn), time_calls(plain_fn)
    log("timing", kernel=kernel, case=label, kernel_us=f"{ms * 1e3:.2f}",
        kernel_gbps=f"{nbytes / ms / 1e6:.1f}", plain_us=f"{plain_ms * 1e3:.2f}",
        plain_gbps=f"{nbytes / plain_ms / 1e6:.1f}", bytes=nbytes, **fields, card=repr(card()))
    return ms, plain_ms


def time_plane_spmv(S, B, label, W=None):
    """Checks the plane SpMV against its plain version on these planes and
    times both, in f32 and f64.  Returns ({dtype name: (ms, plain_ms)}, the
    max abs error over both dtypes); bytes = planes + 2 vectors."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out, err = {}, 0.0
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        Wd, X = (S.planes if W is None else W).to(dtype), B.to(dtype)
        name = str(dtype).replace("torch.", "")
        e = rel_check(f"plane_spmv vs plain ({label} {name})", plane_spmv(Wd, X, S.plan),
                      plane_spmv_reference(Wd, X, S.plan), rel)
        err = max(err, e)
        out[name] = timed("plane_spmv", f"{label} {name}", lambda: plane_spmv(Wd, X, S.plan),
                          lambda: plane_spmv_reference(Wd, X, S.plan),
                          (Wd.numel() + 2 * X.numel()) * Wd.element_size(), dofs=X.numel(),
                          max_abs_err=f"{e:.3e}")
        del Wd, X
    return out, err


def phase_timing_768k(dev, S, B, A, b_flat):
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)

    _, plane_err = time_plane_spmv(S, B, "768k")
    st = timed("structured_spmv", "768k f32", lambda: structured_spmv(A.planes, b_flat, A.offsets),
               lambda: structured_spmv_reference(A.planes, b_flat, A.offsets),
               (A.planes.numel() + 2 * b_flat.numel()) * 4, dofs=b_flat.numel())
    pr = {}
    for shape in ((64, 128), 1 << 24):
        x = torch.ones(shape, device=dev)
        pr[shape] = timed("probe", repr(shape), lambda: probe(x, x), lambda: probe_reference(x, x),
                          3 * x.numel() * 4)
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
    log("done", seconds=f"{time.perf_counter() - _T0:.1f}")

    rows = [("plane_spmv", plane_err, plane_ms), ("structured_spmv", structured_err, structured_ms),
            ("probe", probe_err, probe_ms)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
        "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, err, (ms, plain_ms) in rows]}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
