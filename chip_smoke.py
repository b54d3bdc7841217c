#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the CUDA kernel,
checks it against its plain PyTorch version, drives the SPE10 SWIPDG
assemble-and-solve bench at 768k DoF (6 bisections) through the kernel, and
times the SpMV.  Exits non-zero if any phase fails or there is no card.

    python3 chip_smoke.py

Phases (one line of output each): device, build, kernel vs plain (6 and 2
bisections), main path (768k DoF, true residual <= 1e-6, rechecked in
float64), kernel path vs plain path at 4 bisections, SpMV timing.  Then a
JSON line of the kernels, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import time

import torch

SOURCE = "dune_hdd_tpu_torch/csrc/plane_spmv.cu"
REPLACES = "dune_hdd_tpu/la/pallas_spmv.py:32"


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a card")
    from dune_hdd_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log("device", card=repr(card()), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), count=torch.cuda.device_count())


def phase_build():
    from dune_hdd_tpu_torch.kernels import build

    lib, seconds, compiler_log = build.build("plane_spmv")
    ptxas = [ln.strip() for ln in compiler_log.splitlines() if "registers" in ln]
    log("build", library=lib.name, compiled_now=bool(compiler_log), seconds=f"{seconds:.2f}",
        ptxas=repr("; ".join(ptxas)))


def compare(W, X, plan, rel):
    """Kernel against plain version on the card; returns the max abs error."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    Y = plane_spmv(W, X, plan)
    Y_ref = plane_spmv_reference(W, X, plan)
    torch.cuda.synchronize()
    err = (Y - Y_ref).abs().max().item()
    bound = rel * Y_ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"kernel disagrees with plain version: {err:.3e} > {bound:.3e}")
    return err


def phase_kernel_vs_plain(dev):
    """Returns the 768k-DoF scaled system (S, B) and the f32 max abs error."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench

    out = {}
    for bisections in (6, 2):
        bench = build_spe10_bench(bisections=bisections, device=dev)
        S, B, _ = bench.assemble(bench.field)
        gen = torch.Generator(device="cpu").manual_seed(bisections)
        X = torch.randn(tuple(B.shape), generator=gen, dtype=torch.float64).to(dev)
        e32 = compare(S.planes, X.float().contiguous(), S.plan, 1e-5)
        e64 = compare(S.planes.double(), X, S.plan, 1e-12)
        out[bisections] = (S, B, e32)
        log("kernel_vs_plain", bisections=bisections, dofs=bench.num_dofs,
            f32_max_abs_err=f"{e32:.3e}", f64_max_abs_err=f"{e64:.3e}")
    torch.cuda.synchronize()
    return out[6]


def phase_main_path(dev):
    from dune_hdd_tpu_torch.bench_harness import run_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    plane_spmv.launches = 0
    r = run_spe10_bench(bisections=6, repeats=5, tol=1e-6, device=dev)
    launches = plane_spmv.launches
    if not r["residual"] <= 1e-6:
        raise AssertionError(f"residual {r['residual']:.3e} > 1e-6")
    bench = r["bench"]
    S, B, s = bench.assemble(r["field"])
    B64 = B.double()
    X = r["u"][bench.to_soa].reshape(B.shape) / s.double()
    res64 = ((B64 - plane_spmv_reference(S.planes.double(), X, S.plan)).norm()
             / B64.norm()).item()
    if not res64 <= 1.01e-6:
        raise AssertionError(f"float64 recheck: residual {res64:.3e} > 1.01e-6")
    per_solve = r["inner_iterations"] + r["outer_sweeps"]
    if launches < per_solve:
        raise AssertionError(f"{launches} kernel launches < {per_solve} SpMVs of one solve")
    log("main_path", dofs=r["num_dofs"], seconds=f"{r['seconds']:.6f}",
        mdof_per_s=f"{r['mdof_per_s']:.4f}", all_seconds=repr([round(t, 6) for t in r["all_times"]]),
        inner_iterations=r["inner_iterations"], outer_sweeps=r["outer_sweeps"],
        residual=f"{r['residual']:.3e}", residual_f64_recheck=f"{res64:.3e}",
        launches=launches, card=repr(card()))
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


def phase_spmv_timing(S, B):
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out = {}
    for dtype in (torch.float32, torch.float64):
        W, X = S.planes.to(dtype), B.to(dtype)
        nbytes = (W.numel() + 2 * X.numel()) * W.element_size()  # planes + 2 vectors
        ms = time_calls(lambda: plane_spmv(W, X, S.plan))
        plain_ms = time_calls(lambda: plane_spmv_reference(W, X, S.plan))
        name = str(dtype).replace("torch.", "")
        out[name] = (ms, plain_ms)
        log("spmv_timing", dtype=name, dofs=X.numel(), kernel_us=f"{ms * 1e3:.2f}",
            kernel_gbps=f"{nbytes / ms / 1e6:.1f}", plain_us=f"{plain_ms * 1e3:.2f}",
            plain_gbps=f"{nbytes / plain_ms / 1e6:.1f}", bytes=nbytes, card=repr(card()))
    return out["float32"]


def main():
    t0 = time.perf_counter()
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    S, B, max_err = phase_kernel_vs_plain(dev)
    launches = phase_main_path(dev)
    phase_kernel_path_vs_plain_path(dev)
    ms, plain_ms = phase_spmv_timing(S, B)
    log("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [{
        "name": "plane_spmv", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
