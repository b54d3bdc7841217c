"""Readings that the check's limits are set from: the program's numbers over
many seeds, and the controls' over a few.

    python3 hddbench/control.py --workload <cell> --seeds 12 --control-seeds 3 [--out FILE]

For each seed, the cell's traffic draws ``sample`` inputs as a run does; the
program solves each (the timed call) and the check's numbers are read as a
run reads them (``lib/check.py``).  The controls, on the first
``--control-seeds`` seeds, put in the program's place what is computed one
precision below the configuration's:

* ``res_ref`` and ``res_own``: the answers of the system's ``solve_lower``
  (the program's own solver one precision down: float32 PCG without the
  float64 refinement, or the float32 form of a float64 solve);
* ``op_rel`` / ``op_rel64`` / ``rhs_rel``: the reference's operator and rhs
  rounded to the next lower precision (bfloat16 for float32, float32 for
  float64), the product taken in that precision (``op_rel``) or in float64
  (``op_rel64``).

Prints one JSON line per seed and a summary line: for each number the
largest program reading (the lower reading) and the smallest control
reading (the upper one).  Needs the card at the cell's size; the tests run
the same functions on the CPU at a small size.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from hddbench.lib.check import (probe_vector, program_readings, readings, rel,  # noqa: E402
                                 scaled_residual)
from hddbench.run import load_cell  # noqa: E402

LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def setup(name: str, device, overrides=None):
    spec = load_cell(name)
    config = dict(spec["config"], **(overrides or {}))
    entry = importlib.import_module(f"hddbench.entries.{config['entry']}")
    system = entry.System(config, device)
    reference = importlib.import_module(f"hddbench.reference.{config['reference']}").Reference(
        config, device)
    return spec, config, system, reference


def seed_readings(spec, config, system, reference, seed: int, device, control: bool) -> dict:
    """The program's numbers (and the controls', if ``control``) on the
    inputs that seed ``seed`` draws, every one of them kept for the check."""
    wl = spec["workload"]
    traffic = importlib.import_module(f"hddbench.traffic.{wl['generator']}").Traffic(
        wl["traffic"], seed, device)
    inputs = [traffic.next() for _ in range(wl["sample"])]
    v = probe_vector(seed, system.dofs, device)
    outs = [system.solve(inp) for inp in inputs]
    kept = [(i, o.u) for i, o in enumerate(outs)]
    program = program_readings(system, kept, inputs, v)
    row = {"seed": seed, "iterations": [o.iterations for o in outs],
           "program": readings(reference, kept, inputs, program, v)}
    if control:
        row["control"] = control_readings(config, system, reference, inputs, v)
    return row


def control_readings(config, system, reference, inputs, v: torch.Tensor) -> dict:
    """Each number's smallest reading over ``inputs`` with the program's
    part done one precision below the configuration's: the answers of
    ``solve_lower`` for ``res_ref`` / ``res_own``, the reference's operator
    and rhs rounded for ``op_rel`` (the product in the lower precision),
    ``op_rel64`` (the product in float64) and ``rhs_rel``."""
    low = LOWER[config["precision"]["operator"]]
    own = hasattr(system, "own_residual")
    rows = []
    for inp in inputs:
        u = system.solve_lower(inp)
        op = reference.system(inp)
        Av, op_low = op.matvec(v), op.to(low)
        r = {"res_ref": scaled_residual(op, u),
             "op_rel": rel(op_low.matvec(v.to(low)).double(), Av),
             "op_rel64": rel(op_low.to(torch.float64).matvec(v), Av),
             "rhs_rel": rel(op_low.rhs.double(), op.rhs)}
        if own:
            r["res_own"] = system.own_residual(inp, u)
        rows.append(r)
    return {k: min(r[k] for r in rows) for k in rows[0]}


def summary(rows) -> dict:
    keys = rows[0]["program"].keys()
    lower = {k: max(r["program"][k] for r in rows) for k in keys}
    ctrl = [r["control"] for r in rows if "control" in r]
    upper = {k: min(c[k] for c in ctrl) for k in keys if k in ctrl[0]} if ctrl else {}
    return {"lower": lower, "upper": upper, "seeds": len(rows), "control_seeds": len(ctrl)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec, config, system, reference = setup(args.workload, device)
    rows = []
    for k in range(args.seeds):
        row = seed_readings(spec, config, system, reference, args.first_seed + 7919 * k, device,
                            control=k < args.control_seeds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"workload": args.workload, **summary(rows),
              "card": torch.cuda.get_device_name(device)}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for row in rows + [result]:
                fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
