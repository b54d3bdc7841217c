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
        "import dune_hdd_tpu_torch.estimators, dune_hdd_tpu_torch.estimators.swipdg\n"
        "from dune_hdd_tpu_torch.discretizations.cg import CGDiscretization\n"
        "import dune_hdd_tpu_torch.grid.multiscale, dune_hdd_tpu_torch.problems.zero_boundary\n"
        "import dune_hdd_tpu_torch.problems.os2014, dune_hdd_tpu_torch.problems.spe10\n"
        "import dune_hdd_tpu_torch.discretizations.block_swipdg, dune_hdd_tpu_torch.utils.vtk\n"
        "import dune_hdd_tpu_torch.estimators.block_swipdg, dune_hdd_tpu_torch.functions.spe10\n"
        "import dune_hdd_tpu_torch.studies.localization, dune_hdd_tpu_torch.testcases.os2014\n"
        "import dune_hdd_tpu_torch.testcases.thermalblock, dune_hdd_tpu_torch.testcases.spe10\n"
        "from dune_hdd_tpu_torch.bench_harness import block_provenance_check\n"
        "from dune_hdd_tpu_torch.convert import coupling_from_numpy\n"
        "import dune_hdd_tpu_torch.mor, dune_hdd_tpu_torch.mor.gram_schmidt\n"
        "import dune_hdd_tpu_torch.mor.reductor, dune_hdd_tpu_torch.mor.residual\n"
        "import dune_hdd_tpu_torch.mor.greedy, dune_hdd_tpu_torch.mor.batch\n"
        "import dune_hdd_tpu_torch.mor.io, dune_hdd_tpu_torch.mor.adaptive\n"
        "import dune_hdd_tpu_torch.mor.pymor_shim\n"
        "from dune_hdd_tpu_torch.convert import reduced_model_from_numpy\n"
        "import dune_hdd_tpu_torch.kernels.plane_spmv, dune_hdd_tpu_torch.grid.structured\n"
        "from dune_hdd_tpu_torch.grid.hierarchy import GridProviders\n"
        "from dune_hdd_tpu_torch.grid.structured import interval_grid\n"
        "from dune_hdd_tpu_torch.la.solvers import gmres\n"
        "from dune_hdd_tpu_torch.estimators.swipdg import rt1_flux_reconstruction\n"
        "assert not [m for m in sys.modules if m == 'dune_hdd_tpu' or m.startswith('dune_hdd_tpu.')]\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
