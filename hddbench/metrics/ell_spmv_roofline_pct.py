"""Roofline share of the scalar-ELL SpMV (``SparseMatrix.matvec``,
la/sparse.py), %: the bytes that one float64 application must move, times
(iterations + 1) applications per traced solve (the initial residual and
one per CG iteration), over the SpMV's device time in the traced solves,
at 3.35 TB/s.

The device-alone trace holds no span of the program, so the SpMV's time is
that of its kernels, matched by name: the gather ``x[ell_cols]``
(``index_elementwise_kernel`` of ``index_kernel_impl``; not the
``index_put_kernel_impl`` of the ELL build), the [N, K] product
(``vectorized_elementwise_kernel`` of ``BinaryFunctor<double, double,
double, MulFunctor<double>>``) and the row sum (``reduce_kernel`` of
``sum_functor<double``); and a hand-written kernel of this SpMV, if its
name holds ``ell_spmv``.  So a change to how ``SparseMatrix.matvec`` is
lowered (another torch op, a library product, a fused reduction) has to
update ``KERNELS`` in the same change, or the share moves with no change
in the SpMV's work.  The product's kernel is shared by name with the
Jacobi apply ``inv_diag * r`` (N elements an iteration against the
product's N K): its time is counted whole, so the share reads about
1.5% (of itself) under the SpMV's own, never over it.  The gather of the
diagonal, once a solve, is counted whole too.  Each solve's few masked
iterations past the stopping test (at most 7, ``la/solvers.CHECK_EVERY``)
apply the SpMV in vain, and count as time, not as bytes.
"""
import math

from ._roofline import kernel_seconds, share_pct

KERNELS = (r"index_elementwise_kernel<.*index_kernel_impl<"
           r"|vectorized_elementwise_kernel<\d+, at::native::BinaryFunctor<double, double, "
           r"double, at::native::binary_internal::MulFunctor<double>"
           r"|reduce_kernel<.*sum_functor<double"
           r"|ell_spmv")


def stored_entries(cells):
    """Entries of the Q1 operator's pattern on a tensor grid of ``cells``
    cubes per axis: the Kronecker product of the axes' tridiagonal
    patterns, 3 c + 1 entries an axis (57,066,625 at 128^3)."""
    return math.prod(3 * c + 1 for c in cells)


def ell_bytes(dofs, nnz):
    """The ``nnz`` stored float64 values and their 4-byte column indices
    read once, x read and y written once: the configuration's sizes,
    whatever padding and index width the program stores."""
    return nnz * (8 + 4) + 2 * dofs * 8


def read(run):
    if run.trace is None:
        return None
    per = ell_bytes(run.config["dofs"], stored_entries(run.config["cells"]))
    need = sum((o["iterations"] + 1) * per for o in run.trace.outcomes)
    return share_pct(need, kernel_seconds(run, KERNELS))
