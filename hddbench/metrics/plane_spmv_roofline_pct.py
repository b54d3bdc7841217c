"""Roofline share of the plane SpMV (kernels/plane_spmv.py), %: the bytes
that one float64 application per PCG iteration must move (the full planes,
X and Y), over the device time of ``plane_spmv_kernel`` (not the
half-storage kernel) in the traced solves, at 3.35 TB/s."""
from ._roofline import kernel_seconds, share_pct


def plane_bytes(nd, lattice, itemsize):
    """Planes [4, nd, nd, 8, KY, KX] read once, X and Y [nd, 8, KY, KX]."""
    KY, KX = lattice
    return (4 * nd * nd + 2 * nd) * 8 * KY * KX * itemsize


def read(run):
    if run.trace is None:
        return None
    nd, lattice = run.config["nd"], run.config["lattice"]
    need = sum(o["iterations"] * plane_bytes(nd, lattice, 8) for o in run.trace.outcomes)
    return share_pct(need, kernel_seconds(run, r"(?<!sym_)\bplane_spmv_kernel"))
