"""Times the host sparse LU that the PyTorch port's Riesz residual estimator
factors for the 3D thermalblock (``mor/residual.RieszResidualEstimator``:
the h1_semi product with its Dirichlet DoFs constrained and the 1e-12
diagonal shift, through ``scipy.sparse.linalg.splu``) and reports the
factor's fill, at n^3 Q1 cells, on the CPU:

    PYTHONPATH=. python scripts/torch_splu_fill.py 24 32 40

One line per size: DoF, product nonzeros, L+U nonzeros, splu seconds.
"""
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from dune_hdd_tpu_torch.cli.examples import ThermalblockExample


def h1_semi_system(cells: int) -> sp.csc_matrix:
    d = ThermalblockExample(device="cpu").initialize_tensor(
        dim=3, num_elements=cells, num_blocks=(2, 2, 2)).discretization()
    dirv = np.asarray(d.boundary_info.dirichlet_vertices)
    P = (d.product_matrix("h1_semi").with_constrained_rows(dirv, unit_diagonal=True)
         .with_constrained_cols(dirv, keep_unit_diag=True))
    p = P.pattern
    A = sp.csc_matrix((P.values.numpy(), (p.slot_rows, p.slot_cols)), shape=p.shape)
    return A + sp.identity(p.shape[0], format="csc") * (1e-12 * float(np.abs(A.diagonal()).max()))


if __name__ == "__main__":
    for n in [int(a) for a in sys.argv[1:]] or [24]:
        A = h1_semi_system(n)
        t0 = time.perf_counter()
        lu = spla.splu(A)
        seconds = time.perf_counter() - t0
        print(f"cells={n}^3 dofs={A.shape[0]} nnz={A.nnz} lu_nnz={lu.L.nnz + lu.U.nnz} "
              f"splu_seconds={seconds:.2f}", flush=True)
