"""The PyTorch port imports no JAX: the machine with the card has none."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import dune_hdd_tpu_torch, dune_hdd_tpu_torch.bench_harness, dune_hdd_tpu_torch.convert\n"
        "import dune_hdd_tpu_torch.profile_bench, chip_smoke\n"
        "import dune_hdd_tpu_torch.kernels.probe, dune_hdd_tpu_torch.kernels.structured_spmv\n"
        "import dune_hdd_tpu_torch.parameters, dune_hdd_tpu_torch.affine, dune_hdd_tpu_torch.device\n"
        "import dune_hdd_tpu_torch.functions.base, dune_hdd_tpu_torch.functions.esv2007\n"
        "import dune_hdd_tpu_torch.problems, dune_hdd_tpu_torch.grid.hierarchy\n"
        "import dune_hdd_tpu_torch.grid.boundaryinfo, dune_hdd_tpu_torch.ops.quadrature\n"
        "import dune_hdd_tpu_torch.ops.spaces, dune_hdd_tpu_torch.ops.assembly\n"
        "import dune_hdd_tpu_torch.ops.swipdg, dune_hdd_tpu_torch.ops.norms\n"
        "import dune_hdd_tpu_torch.la.sparse, dune_hdd_tpu_torch.la.solvers\n"
        "import dune_hdd_tpu_torch.la.block_ell, dune_hdd_tpu_torch.la.stencil\n"
        "import dune_hdd_tpu_torch.utils.logging, dune_hdd_tpu_torch.discretizations\n"
        "import dune_hdd_tpu_torch.discretizations.cg, dune_hdd_tpu_torch.testcases.base\n"
        "import dune_hdd_tpu_torch.testcases.esv2007, dune_hdd_tpu_torch.studies\n"
        "assert not [m for m in sys.modules if m == 'dune_hdd_tpu' or m.startswith('dune_hdd_tpu.')]\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
