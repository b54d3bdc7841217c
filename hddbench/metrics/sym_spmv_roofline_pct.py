"""Roofline share of the half-storage symmetric plane SpMV
(kernels/sym_plane_spmv.py), %: the bytes that one float32 application per
PCG iteration and one float64 application per refinement sweep must move,
over the device time of ``sym_plane_spmv_kernel`` in the traced solves, at
3.35 TB/s."""
from ._roofline import kernel_seconds, share_pct


def sym_plane_bytes(nd, lattice, itemsize):
    """Bytes one application must move once: per lattice site the upper
    triangles of the 8 self blocks, the 12 forward plane sets, X and Y
    (``kernels/sym_plane_spmv.sym_plane_bytes`` of the program)."""
    KY, KX = lattice
    per_site = 8 * nd * (nd + 1) // 2 + 12 * nd * nd + 2 * 8 * nd
    return per_site * KY * KX * itemsize


def read(run):
    if run.trace is None:
        return None
    nd, lattice = run.config["nd"], run.config["lattice"]
    need = sum(o["iterations"] * sym_plane_bytes(nd, lattice, 4)
               + o["sweeps"] * sym_plane_bytes(nd, lattice, 8) for o in run.trace.outcomes)
    return share_pct(need, kernel_seconds(run, r"\bsym_plane_spmv_kernel"))
