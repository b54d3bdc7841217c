"""Thermalblock reduced-basis demo: the reference's
examples/linearelliptic/thermalblock_main.py workflow (perform_standard_rb /
perform_lrbms / test_quality) on the port.

Runs the block-SWIPDG thermalblock, trains a standard RB and an LRBMS basis
with the greedy, checks the reduction's quality against detailed solves at
random test parameters, and saves the RB reduced model
(``thermalblock_rb_model.npz`` in the working directory).  Counterpart of
the root ``examples/thermalblock_rb_demo.py``, with ``--device`` in place of
``--platform``: it computes on the card unless ``--device cpu`` is given.

Usage:  python -m dune_hdd_tpu_torch.examples.thermalblock_rb_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

MODEL_PATH = "thermalblock_rb_model"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dune_hdd_tpu_torch.examples.thermalblock_rb_demo",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--num-blocks", type=int, nargs=2, default=[2, 2])
    p.add_argument("--num-partitions", type=int, nargs=2, default=[2, 2])
    p.add_argument("--refinements", type=int, default=2)
    p.add_argument("--training-samples", type=int, default=8)
    p.add_argument("--target-error", type=float, default=1e-6)
    p.add_argument("--max-rb-size", type=int, default=12)
    p.add_argument("--test-samples", type=int, default=5)
    return p


def main(argv=None) -> dict:
    """Runs the workflow; returns the two greedy results, the test errors
    per basis and the saved model's path."""
    args = _parser().parse_args(argv)

    from ..discretizations.block_swipdg import BlockSWIPDGDiscretization
    from ..grid.structured import alu_cube_grid
    from ..mor import RBReductor, greedy_lrbms, greedy_rb, sample_randomly, save_reduced_model
    from ..problems import ThermalblockProblem

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=args.refinements)
    problem = ThermalblockProblem(tuple(args.num_blocks))
    d = BlockSWIPDGDiscretization(
        grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}, problem,
        num_partitions=tuple(args.num_partitions), device=args.device)
    print(f"detailed model: {d.space.num_dofs} DoFs, "
          f"{d.num_subdomains()} subdomains, mu in R^{np.prod(args.num_blocks)}")

    training = sample_randomly(d.parameter_type, 0.1, 1.0, args.training_samples)

    print("\n== standard RB greedy (gram_schmidt extension, h1_semi norm) ==")
    t0 = time.perf_counter()
    rb = greedy_rb(d, training, target_error=args.target_error,
                   max_extensions=args.max_rb_size, verbose=True)
    print(f"  basis size {rb.basis.shape[0]} in {time.perf_counter() - t0:.1f}s")

    print("\n== LRBMS greedy (per-subdomain local bases, local h1_semi) ==")
    t0 = time.perf_counter()
    lrbms = greedy_lrbms(d, training, target_error=args.target_error,
                         max_extensions=args.max_rb_size, verbose=True)
    print(f"  basis size {lrbms.basis.shape[0]} in {time.perf_counter() - t0:.1f}s")

    print("\n== quality check vs detailed solves (random test parameters) ==")
    reductor = RBReductor(d)
    tests = sample_randomly(d.parameter_type, 0.1, 1.0, args.test_samples, seed=123)
    errors = {}
    for name, result in (("rb", rb), ("lrbms", lrbms)):
        errors[name] = [reductor.true_error(result.reduced_model, mu) for mu in tests]
        print(f"  {name:6s}: max err {max(errors[name]):.3e}  mean {np.mean(errors[name]):.3e}")

    path = save_reduced_model(rb.reduced_model, MODEL_PATH)
    print(f"\nsaved reduced model to {path}")
    return {"rb": rb, "lrbms": lrbms, "errors": errors, "path": path}


if __name__ == "__main__":
    main(sys.argv[1:])
