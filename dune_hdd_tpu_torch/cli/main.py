"""CLI: config-driven solve drivers (cg_main.cc / swipdg_main.cc /
block-swipdg_main.cc / thermalblock_main.cc analogs, plus an RB greedy
subcommand in place of thermalblock_main.py).  Counterpart of
``dune_hdd_tpu/cli/main.py``.

Usage:
  dune-hdd-tpu-torch <example> [config.cfg] [--solver TYPE] [--visualize PREFIX]
  dune-hdd-tpu-torch rb [config.cfg]         # thermalblock greedy workflow
  dune-hdd-tpu-torch study [--case esv2007|os2014]
  python -m dune_hdd_tpu_torch.cli.main ...  # the same

Every run computes on the card unless ``--device cpu`` is given; without a
card the default raises.  The first run of an example without a config
writes the default config and exits (write-config-then-rerun pattern,
cg_main.cc:23-33).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from ..device import resolve_device


def _registry():
    from .examples import (
        LinearellipticExampleBlockSWIPDG,
        LinearellipticExampleCG,
        LinearellipticExampleSWIPDG,
        ThermalblockExample,
    )

    return {
        "cg": LinearellipticExampleCG,
        "swipdg": LinearellipticExampleSWIPDG,
        "block-swipdg": LinearellipticExampleBlockSWIPDG,
        "thermalblock": ThermalblockExample,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dune-hdd-tpu-torch")
    parser.add_argument("example", choices=list(_registry()) + ["rb", "study"])
    parser.add_argument("config", nargs="?", default=None)
    parser.add_argument("--visualize", default=None, metavar="PREFIX")
    parser.add_argument("--solver", default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to compute (default: the card; raises without one)")
    parser.add_argument(
        "--case", default="esv2007", choices=["esv2007", "os2014"],
        help="for 'study': esv2007 = SWIPDG fine-grid estimator study; "
             "os2014 = block-SWIPDG eta_OS2014 over partitionings "
             "(the OS2014-FVCA7 poster workflow)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.example == "rb":
        return _run_rb(args, device)
    if args.example == "study":
        return _run_study(args, device)

    cls = _registry()[args.example]
    cfg_file = args.config or (cls.static_id() + ".cfg")
    if not os.path.isfile(cfg_file):
        path = cls.write_config_file(cfg_file)
        print(f"wrote default config to {path!r}; edit it and rerun")
        return 0
    example = cls(device=device).initialize([cfg_file])
    disc = example.discretization()
    print(f"{type(disc).__name__}: {disc.space.num_dofs} DoF")
    options = {"type": args.solver} if args.solver else None
    mus = example.parameters() or [None]
    for i, mu in enumerate(mus):
        label = f"mu_{i}" if mu is not None else "solution"
        print(f"solving for parameter block {i}: {mu}")
        u = disc.solve(mu, options=options)
        print(f"  |u|_max = {float(torch.max(torch.abs(u))):.6e}")
        info = disc.last_solve_info
        if info:
            print("  solver: " + ", ".join(f"{k}={v}" for k, v in info.items()))
        if args.visualize:
            path = disc.visualize(u, f"{args.visualize}_{label}", "solution")
            print(f"  wrote {path}")
    return 0


def _run_study(args, device):
    """EOC / estimator study runner (the reference's gtest study
    executables, printed as a convergence table)."""
    if args.case == "os2014":
        return _run_block_study(device)
    from ..discretizations import SWIPDGDiscretization
    from ..estimators import SWIPDGEstimators
    from ..studies import EocStudy, eoc_rates
    from ..testcases.esv2007 import ESV2007TestCase

    tc = ESV2007TestCase(num_refinements=2)
    tc.print_header()

    def estimate(disc, u, type_, level):
        return SWIPDGEstimators.estimate(disc.space, disc.boundary_info, tc.problem, u, type_)

    study = EocStudy(
        tc, SWIPDGDiscretization,
        estimator_types=("eta_NC_ESV2007", "eta_R_ESV2007", "eta_DF_ESV2007", "eta_ESV2007"),
        estimate_fn=estimate, device=device,
    )
    results = study.run(verbose=True)
    print("\nEOC rates:")
    for t, vals in results.items():
        print(f"  {t}: " + "  ".join(f"{r:.2f}" for r in eoc_rates(vals)))
    eff = [e / h for e, h in zip(results["eta_ESV2007"], results["H1_semi"])]
    print("  eff_ESV2007: " + "  ".join(f"{v:.3f}" for v in eff))
    return 0


def fvca7_poster_study(partitionings=((1, 1), (2, 2), (4, 4), (8, 8)),
                       num_refinements: int = 1, device="cuda"):
    """The OS2014-FVCA7 poster workflow (test/OS2014-FVCA7-poster.cc:53-85):
    BlockSWIPDG on the ESV2007 test case over partitionings of 1 / 4 / 16 /
    64 subdomains, energy error, eta_OS2014 and efficiency per level.
    Returns {"[px py 1]": {"energy": [...], "eta_OS2014": [...],
    "eff_OS2014": [...]}}, which the recorded FVCA7.poster.* expectations
    hold."""
    from ..discretizations.block_swipdg import BlockSWIPDGDiscretization
    from ..estimators.block_swipdg import BlockSWIPDGEstimators
    from ..functions.esv2007 import Testcase1ExactSolution
    from ..ops.norms import error_norms
    from ..testcases.esv2007 import ESV2007TestCase

    device = resolve_device(device)
    tc = ESV2007TestCase(num_refinements=num_refinements)
    exact = Testcase1ExactSolution()
    out = {}
    for part in partitionings:
        key = f"[{part[0]} {part[1]} 1]"
        rows = {"energy": [], "eta_OS2014": [], "eff_OS2014": []}
        for lvl in range(tc.num_refinements + 1):
            d = BlockSWIPDGDiscretization(tc.level_grid(lvl), tc.boundary_info(), tc.problem,
                                          num_partitions=part, device=device)
            u = d.solve(options={"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000})
            eta = float(BlockSWIPDGEstimators.estimate(d, u, "eta_OS2014"))
            e = float(error_norms(d.space, u, exact)["H1_semi"])
            rows["energy"].append(e)
            rows["eta_OS2014"].append(eta)
            rows["eff_OS2014"].append(eta / e)
        out[key] = rows
    return out


def _run_block_study(device):
    """CLI face of the FVCA7-poster workflow."""
    print("BlockSWIPDG ESV2007: eta_OS2014 / eff by partitioning\n")
    print(f"{'partitioning':>14s} {'level':>5s} {'energy err':>12s} "
          f"{'eta_OS2014':>12s} {'eff':>8s}")
    for key, rows in fvca7_poster_study(device=device).items():
        for lvl, (e, eta, eff) in enumerate(zip(
                rows["energy"], rows["eta_OS2014"], rows["eff_OS2014"])):
            print(f"{key:>14s} {lvl:>5d} {e:>12.4e} {eta:>12.4e} {eff:>8.3f}")
    return 0


def _run_rb(args, device):
    from ..mor import greedy_rb, sample_randomly, sample_uniformly
    from .examples import ThermalblockExample

    cfg_file = args.config or (ThermalblockExample.static_id() + ".cfg")
    if not os.path.isfile(cfg_file):
        path = ThermalblockExample.write_config_file(cfg_file)
        print(f"wrote default config to {path!r}; edit it and rerun")
        return 0
    example = ThermalblockExample(device=device).initialize([cfg_file])
    disc = example.discretization()
    cfg = example.config
    n = int(cfg.get("pymor.num_training_samples", 10))
    if str(cfg.get("pymor.training_set", "random")) == "random":
        training = sample_randomly(disc.parameter_type, 0.1, 1.0, n)
    else:
        training = sample_uniformly(disc.parameter_type, 0.1, 1.0, n)
    print(f"greedy RB training on {len(training)} samples ...")
    res = greedy_rb(
        disc,
        training,
        target_error=float(cfg.get("pymor.target_error", 1e-6)),
        max_extensions=int(cfg.get("pymor.max_rb_size", 20)),
        extension_algorithm=str(cfg.get("pymor.extension_algorithm", "gram_schmidt")),
        error_norm=str(cfg.get("pymor.greedy_error_norm", "h1_semi")),
        verbose=True,
    )
    print(f"final basis size {res.basis.shape[0]}, max error {res.max_errors[-1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
