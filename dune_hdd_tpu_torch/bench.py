"""The bench's entry point: SPE10 SWIPDG assemble + solve to a true 1e-6.

    python -m dune_hdd_tpu_torch.bench [--bisections 6] [--repeats 5]
        [--preconditioner stencil2] [--provenance auto|off|<n>]
        [--roofline auto|off|on] [--device cuda]

Prints ONE JSON line with the reference bench's keys (the root ``bench.py``,
converged mode): ``metric``, ``value`` (MDoF/s of the median timed call),
``unit``, ``vs_baseline`` (against the 5 MDoF/s north star), ``num_dofs``,
``seconds``, ``residual``, ``platform``, ``provenance`` (the block
provenance check at min(bisections, 6) bisections for ``auto``, at ``<n>``
otherwise) and ``roofline`` (``bench_harness.stencil2_roofline`` at the
bench's size; ``auto`` runs it up to 8 bisections).  Runs on the card
unless ``--device cpu`` is given; a failed provenance check or roofline
raises and the run exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys

from .bench_harness import (
    PRECONDITIONERS,
    block_provenance_check,
    run_spe10_bench,
    stencil2_roofline,
)

METRIC = "spe10_swipdg_assemble_solve_to_1e-6"
BASELINE_MDOF_PER_S = 5.0  # BASELINE.json's north star


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dune_hdd_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--bisections", type=int, default=6)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--preconditioner", default="stencil2", choices=PRECONDITIONERS)
    p.add_argument("--provenance", default="auto",
                   help="auto (min(bisections, 6)), off, or a number of bisections")
    p.add_argument("--roofline", default="auto", choices=("auto", "off", "on"))
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    """Runs the bench, prints its JSON line and returns it as a dict."""
    args = _parser().parse_args(argv)
    if args.provenance not in ("auto", "off") and not args.provenance.isdigit():
        raise SystemExit(f"--provenance must be auto, off or a number, got {args.provenance!r}")
    result = run_spe10_bench(bisections=args.bisections, repeats=args.repeats, tol=1e-6,
                             device=args.device, preconditioner=args.preconditioner)
    mdofs = result["mdof_per_s"]
    out = {
        "metric": METRIC,
        "value": round(mdofs, 3),
        "unit": "MDoF/s",
        "vs_baseline": round(mdofs / BASELINE_MDOF_PER_S, 3),
        "num_dofs": result["num_dofs"],
        "seconds": round(result["seconds"], 4),
        "residual": result["residual"],
        "platform": "gpu" if result["u"].device.type == "cuda" else result["u"].device.type,
    }
    if args.provenance != "off":
        bisections = (min(args.bisections, 6) if args.provenance == "auto"
                      else int(args.provenance))
        out["provenance"] = dict(block_provenance_check(bisections=bisections,
                                                        device=args.device), ok=True)
    if args.roofline == "on" or (args.roofline == "auto" and args.bisections <= 8):
        out["roofline"] = stencil2_roofline(bisections=args.bisections, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
