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
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
