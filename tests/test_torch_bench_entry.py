"""The port's bench entry points on the CPU: ``stencil2_roofline`` against
the reference's keys and byte models, ``python -m dune_hdd_tpu_torch.bench``
(one JSON line with the root ``bench.py``'s keys, a true 1e-6), and the
thermalblock RB demo (``python -m dune_hdd_tpu_torch.examples.
thermalblock_rb_demo``): its saved model loads back and its greedy basis
sizes equal the JAX package's at the same arguments."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dune_hdd_tpu_torch.bench_harness import stencil2_roofline  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
ROOFLINE_KEYS = {"num_dofs", "copy_gbps", "matvec_ms", "matvec_gbps", "assembly_ms",
                 "assembly_gbps"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "num_dofs", "seconds", "residual",
              "platform", "provenance", "roofline"}


def test_roofline_keys_and_byte_models():
    r = stencil2_roofline(bisections=2, repeats=1, pcg_iters=2, device="cpu")
    assert set(r) == ROOFLINE_KEYS
    KY, KX = 10 << 1, 50 << 1  # the 2-bisection lattice
    n = 3 * 8 * KY * KX
    assert r["num_dofs"] == n == 48000
    plane_bytes = 4.0 * 4 * 3 * 3 * 8 * KY * KX
    # GB/s x ms = bytes / 1e6 under the reference's models
    assert r["matvec_gbps"] * r["matvec_ms"] * 1e6 == pytest.approx(0.5 * plane_bytes + 8.0 * n,
                                                                    rel=1e-12)
    assert r["assembly_gbps"] * r["assembly_ms"] * 1e6 == pytest.approx(plane_bytes + 8.0 * n,
                                                                        rel=1e-12)
    assert all(np.isfinite(v) and v > 0 for v in r.values())


def test_roofline_keys_are_the_reference_ones():
    pytest.importorskip("jax")
    from dune_hdd_tpu import bench_harness as jx_bench

    ref = jx_bench.stencil2_roofline(bisections=2, repeats=1, pcg_iters=2)
    assert set(ref) == ROOFLINE_KEYS and ref["num_dofs"] == 48000


def test_bench_module_prints_one_json_line():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dune_hdd_tpu_torch.bench", "--device", "cpu", "--bisections",
         "2", "--repeats", "1"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[-1])
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "spe10_swipdg_assemble_solve_to_1e-6" and out["unit"] == "MDoF/s"
    assert out["residual"] <= 1e-6 and out["num_dofs"] == 48000 and out["platform"] == "cpu"
    assert out["provenance"]["ok"] and out["provenance"]["bisections"] == 2
    assert set(out["roofline"]) == ROOFLINE_KEYS


def test_bench_module_rejects_a_bad_provenance_argument():
    from dune_hdd_tpu_torch import bench

    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--provenance", "sometimes"])


DEMO_ARGS = ["--refinements", "1", "--training-samples", "4", "--max-rb-size", "4",
             "--test-samples", "2"]


def test_rb_demo_saves_a_loadable_model_with_the_reference_basis_sizes(tmp_path, monkeypatch):
    from dune_hdd_tpu_torch.examples import thermalblock_rb_demo
    from dune_hdd_tpu_torch.mor import load_reduced_model

    monkeypatch.chdir(tmp_path)
    out = thermalblock_rb_demo.main(DEMO_ARGS + ["--device", "cpu"])
    assert Path(out["path"]).resolve() == tmp_path / "thermalblock_rb_model.npz"
    rm = out["rb"].reduced_model
    loaded = load_reduced_model(out["path"], device="cpu")
    for name in ("op_mats", "rhs_vecs", "basis"):
        assert torch.equal(getattr(loaded, name), getattr(rm, name))
    assert all(np.isfinite(e) for errs in out["errors"].values() for e in errs)

    pytest.importorskip("jax")
    from dune_hdd_tpu.discretizations.block_swipdg import BlockSWIPDGDiscretization
    from dune_hdd_tpu.grid import alu_cube_grid
    from dune_hdd_tpu.mor import greedy_lrbms, greedy_rb, sample_randomly
    from dune_hdd_tpu.problems import ThermalblockProblem

    d = BlockSWIPDGDiscretization(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=1),
                                  {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                  ThermalblockProblem((2, 2)), num_partitions=(2, 2))
    training = sample_randomly(d.parameter_type, 0.1, 1.0, 4)
    rb = greedy_rb(d, training, target_error=1e-6, max_extensions=4)
    lrbms = greedy_lrbms(d, training, target_error=1e-6, max_extensions=4)
    assert out["rb"].basis.shape[0] == rb.basis.shape[0]
    assert out["lrbms"].basis.shape[0] == lrbms.basis.shape[0]
