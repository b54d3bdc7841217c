"""Run one cell of the benchmark once.

    python3 hddbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
BENCHMARK.json) names its configuration (``hddbench/configs/<config>.json``,
whose "entry" is the system's module under ``hddbench/entries`` and whose
"reference" is the plain reference's module under ``hddbench/reference``)
and its traffic (``hddbench/workloads/<cell>.json``: the generator under
``hddbench/traffic``, its parameters, the sample the check compares and the
limits).  Each metric of the cell is read by ``hddbench/metrics/<metric>.py``.

A run: set up the system, warm up with one solve of the cell's own shapes,
then a closed loop of solves for ``--seconds``, one caller, each on a fresh
input drawn from the seed; with ``--trace 1`` the loop times its layers in
spans, and a few more solves run: untraced, then the same again under
``torch.profiler`` tracing the device alone (the busy time and the kernels'
times), then fresh ones traced with the host's operations (the labels of
the idle gaps).  Then the answers
sampled from the window are compared with the float64 reference, and one
JSON line is printed: the end-to-end metrics (``--trace 0``) or the
per-layer metrics (``--trace 1``).  Needs an NVIDIA GPU: without one it
exits with status 2 and prints no result.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hddbench.lib import trace as tracing  # noqa: E402
from hddbench.lib.check import probe_vector, program_readings, readings, verdict  # noqa: E402
from hddbench.lib.window import Sample, Spans, run_traced, run_window, sync  # noqa: E402

BENCH = ROOT / "hddbench"


def load_cell(name: str) -> dict:
    """The cell's entry, configuration and workload, and its metrics with
    their units, from BENCHMARK.json and the cell's files."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "cell": cell,
        "config": json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text()),
        "workload": json.loads((BENCH / "workloads" / f"{name}.json").read_text()),
        "end_to_end": mine(spec["end_to_end"]),
        "per_layer": mine(spec["per_layer"]),
    }


def reader(metric: str):
    return importlib.import_module(f"hddbench.metrics.{metric}").read


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, overrides=None,
             system_factory=None, t0=None) -> dict:
    """One run of cell ``name``; returns the result record.  ``setup_s``
    counts from ``t0`` (default: now).  ``overrides`` replace configuration
    keys (the tests' small sizes); ``system_factory`` replaces the entry's
    System (the tests' broken systems)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_cell(name)
    config = dict(spec["config"], **(overrides or {}))
    wl = spec["workload"]
    entry = importlib.import_module(f"hddbench.entries.{config['entry']}")
    system = (system_factory or entry.System)(config, device)
    traffic = importlib.import_module(f"hddbench.traffic.{wl['generator']}").Traffic(
        wl["traffic"], seed, device)
    warm = system.solve(traffic.next())
    sample = Sample(wl["sample"], seed, warm.u)
    del warm
    sync(device)
    setup_s = time.perf_counter() - t0

    spans = Spans(device) if trace else None
    window_s, outcomes, inputs = run_window(system, traffic, seconds, device, sample, spans)
    traced = None
    if trace:
        untraced_s, events, traced_s, traced_outs, labelled = run_traced(
            system, traffic, wl["traced_solves"], device)
        traced = SimpleNamespace(summary=tracing.summarize(events, traced_s, labelled),
                                 outcomes=traced_outs, untraced_s=untraced_s)
        del events, labelled
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # the check: the program's operator for every sampled input, then the
    # program's state released, then the float64 reference
    kept = sample.kept()
    v = probe_vector(seed, system.dofs, device)
    program = program_readings(system, kept, inputs, v)
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = importlib.import_module(f"hddbench.reference.{config['reference']}").Reference(
        config, device)
    numbers = readings(reference, kept, inputs, program, v)
    correct, rows = verdict(numbers, wl["limits"])

    run = SimpleNamespace(outcomes=outcomes, window_s=window_s, setup_s=setup_s,
                          peak_bytes=peak, spans=spans.seconds if spans else None,
                          trace=traced, config=config)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(outcomes),
        "failed": sum(1 for r in outcomes if not r["ok"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": int(spec["cell"]["chips"]), "memory_peak_bytes": peak},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.summary.busy_s, window_s=traced.summary.window_s)
        result["breakdown"] = {"device_ops": tracing.top(traced.summary.device_s),
                               "idle_gaps": tracing.top(traced.summary.idle_by_host)}
    result["card"] = card_power_limit() if on_card else "cpu"
    result["readings"] = {k: val for k, val in numbers.items() if k not in wl["limits"]}
    result["check"] = {k: {"value": val, "limit": lim} for k, val, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = int(load_cell(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # kernel caches at fixed paths inside the checkout (the program's own
    # nvcc builds go to dune_hdd_tpu_torch/_build)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                      t0=_T0)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
