"""Where the time of one SPE10 bench call goes on the card.

    python -m dune_hdd_tpu_torch.profile_bench [--bisections 6]

After a warm call, times one call untraced, then one call while recording
the program's spans and counters (``utils/profiling.py``), then one call
recording under ``torch.profiler``, and prints one JSON line.  From the
recorded call: the layer split (the device durations of its ``assemble``,
``precond.build``, ``pcg`` and ``refine.residual`` spans), its iterations
and sweeps, and its host syncs (``host.syncs``: the PCG's per-``unroll``
convergence checks, the refinement's residual norms, the build's reads and
copies), its CUDA graph replays per iteration and the host time of its
graph capture.  From the profiled call: the traced wall time, the device busy
time (union of kernel and copy intervals) and idle share, the device time,
operations and idle time by ``hdd::`` span, the host time blocked in
``.item()`` and the device idle time in the gaps during which one
returned, the kernels with the most device time, the device time of the
plane SpMV kernels (full and half-storage) and their share of the busy
time, and the host ops with the most self time.  The profiler slows the
host, so the traced wall time is longer than the untraced one; the shares
are of the traced run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .bench_harness import build_spe10_bench
from .utils.profiling import SPAN_PREFIX, recording, span_breakdown

_SYNC_OPS = ("aten::_local_scalar_dense",)
LAYERS = ("assemble", "freeze", "precond.build", "pcg", "refine.residual")


def span_summary(rec, traced=None, breakdown=None) -> dict:
    """The per-layer numbers of the solves in ``rec`` (a ``Record``) and,
    given the record ``traced`` of a profiled pass over other solves and its
    ``span_breakdown``, of that pass: per PCG iteration the ``pcg`` spans'
    device time, the host syncs of the solves, the device operations
    launched in ``pcg`` spans and the device time of those launched in
    ``precond.apply`` spans; the mean device time of each coarse layer; and
    the idle seconds by innermost span."""
    iters = rec.total("pcg.iterations")
    out = {"solves": len(rec.seconds("solve")), "pcg_iterations": iters,
           "host_syncs": rec.total("host.syncs"),
           "layer_ms": {name: 1e3 * sum(s) / len(s) for name in LAYERS
                        if (s := rec.seconds(name))}}
    if iters:
        out["pcg_span_iter_ms"] = 1e3 * sum(rec.seconds("pcg")) / iters
        out["host_syncs_per_iter"] = rec.total("host.syncs") / iters
        out["graph_replays_per_iter"] = rec.total("pcg.graph.replays") / iters
    if captures := rec.seconds("pcg.graph.capture"):
        out["graph_capture_ms"] = 1e3 * sum(captures) / len(captures)
        out["graph_eager_fallbacks"] = rec.total("pcg.graph.eager_fallbacks")
    traced_iters = traced.total("pcg.iterations") if traced is not None else 0
    if breakdown is not None and traced_iters:
        def inside(name):
            return [k for k in breakdown.ops if name in k]

        out["launches_per_iter"] = sum(breakdown.ops[k] for k in inside("pcg")) / traced_iters
        out["precond_apply_ms"] = 1e3 * sum(breakdown.device_s[k]
                                            for k in inside("precond.apply")) / traced_iters
        attributed = sum(n for k, n in breakdown.ops.items() if k)
        out["ops_in_spans"] = attributed / max(breakdown.device_ops, 1)
        idle: dict = {}
        for k, s in breakdown.idle_s.items():
            name = k[-1] if k else "(none)"
            idle[name] = idle.get(name, 0.0) + s
        out["span_idle_s"] = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        out["idle_s"] = sum(breakdown.idle_s.values())
        out["window_s"] = breakdown.window_s
        out["busy_s"] = breakdown.busy_s
    return out


def profile_call(bisections: int) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    bench = build_spe10_bench(bisections=bisections, device=dev)
    bench.fn(bench.field)  # warm-up: kernel library, allocator, cuBLAS handles
    field = bench.field * (1.0 + 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench.fn(field)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with recording() as rec:
        t0 = time.perf_counter()
        sol = bench.fn(field)
        torch.cuda.synchronize()
        recorded_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with recording() as traced_rec, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bench.fn(field)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = span_summary(rec, traced_rec,
                           span_breakdown(prof.profiler.kineto_results.events()))
    events = prof.events()
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN_PREFIX))
    syncs = [e for e in events if e.name in _SYNC_OPS]
    busy, gaps, end = 0.0, [], None
    for a, b in device:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    sync_ends = sorted(e.time_range.end for e in syncs)
    sync_idle = sum(g1 - g0 for g0, g1 in gaps
                    if any(g0 <= t <= g1 for t in sync_ends))
    by_name: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN_PREFIX):
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spmv = sum(t for name, t in by_name.items() if "plane_spmv" in name)
    host_ops = sorted(((a.key, a.self_cpu_time_total, a.count) for a in prof.key_averages()),
                      key=lambda t: -t[1])[:10]
    span = (device[-1][1] - device[0][0]) if device else 0.0
    return {
        "bisections": bisections,
        "dofs": bench.num_dofs,
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()[0],
        "residual": sol.residual,
        "inner_iterations": sol.iterations,
        "outer_sweeps": sol.sweeps,
        "untraced_call_s": untraced_s,
        "recorded_call_s": recorded_s,
        "peak_gb": peak_gb,
        "spans": summary,
        "traced_wall_ms": wall_us / 1e3,
        "device_events": len(device),
        "device_busy_ms": busy / 1e3 if device else None,
        "device_span_ms": span / 1e3 if device else None,
        "device_idle_share_of_wall": (1.0 - busy / wall_us) if device else None,
        "host_blocked_in_syncs_ms": sum(e.time_range.end - e.time_range.start
                                        for e in syncs) / 1e3,
        "device_idle_in_sync_gaps_ms": sync_idle / 1e3 if device else None,
        "sync_gap_share_of_wall": (sync_idle / wall_us) if device else None,
        "top_kernels_ms": [(name[:80], t / 1e3) for name, t in top],
        "plane_spmv_kernels_ms": spmv / 1e3,
        "plane_spmv_share_of_device_busy": spmv / busy if busy else None,
        "top_host_ops_self_ms_count": [(name[:60], t / 1e3, n) for name, t, n in host_ops],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bisections", type=int, default=6)
    args = ap.parse_args()
    print(json.dumps(profile_call(args.bisections)))


if __name__ == "__main__":
    main()
