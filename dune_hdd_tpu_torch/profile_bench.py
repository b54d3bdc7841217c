"""Where the time of one SPE10 bench call goes on the card.

    python -m dune_hdd_tpu_torch.profile_bench [--bisections 6]

Traces one warm call of the bench with ``torch.profiler`` and prints one
JSON line: the traced wall time, the device busy time (union of kernel and
copy intervals) and idle share, the number of host syncs (``.item()``
calls: the PCG's per-``unroll`` convergence checks and the refinement's
per-sweep residual norm), the host time blocked in them, the device idle
time in the gaps during which a sync returned, and the kernels with the
most device time, the device time of the plane SpMV kernels (full and
half-storage) and their share of the busy time, and the host ops with the
most self time.  The profiler slows the host, so the traced wall time is
longer than the untraced one; the shares are of the traced run.  Before the
trace, one untraced call is timed by layer: assembly + scaling,
preconditioner build, and the refined solve, each with its peak device
memory (the set-up's tensors included).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .bench_harness import build_spe10_bench

_SYNC_OPS = ("aten::_local_scalar_dense",)


def layer_seconds(bench, field) -> tuple:
    """Seconds of one untraced call, split by layer (a sync after each), and
    the peak device memory (GB) of each layer with what it finds allocated."""
    marks = [time.perf_counter()]
    peaks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    S, B, s = bench.assemble(field)
    mark()
    bench.precondition(S, s)
    mark()
    bench.solve(S, B, s)
    mark()
    bench.precondition(S, s)  # solve built M again: take it off
    mark()
    asm, pre, solve, pre2 = (b - a for a, b in zip(marks, marks[1:]))
    return ({"assemble": asm, "precondition": pre, "refined_solve": solve - pre2,
             "call": asm + solve},
            {"assemble": peaks[0], "precondition": peaks[1], "solve": peaks[2]})


def profile_call(bisections: int) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    bench = build_spe10_bench(bisections=bisections, device=dev)
    bench.fn(bench.field)  # warm-up: kernel library, allocator, cuBLAS handles
    field = bench.field * (1.0 + 1e-6)
    layers, peaks = layer_seconds(bench, field)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sol = bench.fn(field)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA)
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
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spmv = sum(t for name, t in by_name.items() if "plane_spmv" in name)
    host_ops = sorted(((a.key, a.self_cpu_time_total, a.count) for a in prof.key_averages()),
                      key=lambda t: -t[1])[:10]
    span = (device[-1][1] - device[0][0]) if device else 0.0
    return {
        "bisections": bisections,
        "dofs": bench.num_dofs,
        "untraced_layer_seconds": layers,
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()[0],
        "residual": sol.residual,
        "inner_iterations": sol.iterations,
        "outer_sweeps": sol.sweeps,
        "traced_wall_ms": wall_us / 1e3,
        "device_events": len(device),
        "device_busy_ms": busy / 1e3 if device else None,
        "device_span_ms": span / 1e3 if device else None,
        "device_idle_share_of_wall": (1.0 - busy / wall_us) if device else None,
        "host_syncs": len(syncs),
        "host_blocked_in_syncs_ms": sum(e.time_range.end - e.time_range.start
                                        for e in syncs) / 1e3,
        "device_idle_in_sync_gaps_ms": sync_idle / 1e3 if device else None,
        "sync_gap_share_of_wall": (sync_idle / wall_us) if device else None,
        "top_kernels_ms": [(name[:80], t / 1e3) for name, t in top],
        "plane_spmv_kernels_ms": spmv / 1e3,
        "plane_spmv_share_of_device_busy": spmv / busy if busy else None,
        "untraced_layer_peak_gb": peaks,
        "top_host_ops_self_ms_count": [(name[:60], t / 1e3, n) for name, t, n in host_ops],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bisections", type=int, default=6)
    args = ap.parse_args()
    print(json.dumps(profile_call(args.bisections)))


if __name__ == "__main__":
    main()
