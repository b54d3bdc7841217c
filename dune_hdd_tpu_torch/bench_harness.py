"""Benchmark harness: SPE10 SWIPDG assemble + solve.

Counterpart of ``dune_hdd_tpu/bench_harness.py``.  The SPE10 model-1
problem (100 x 20 permeability cells on [0,5] x [0,1], channel-modulated
diffusion factor, three box forces, all-Dirichlet boundary) is discretized
with P1 SWIPDG on the ALU-bisected 100 x 20 cube grid.  Per call, from the
permeability field as a device tensor, ``preconditioner`` chooses the
branch:

* "stencil2" (default): assemble the operator directly into stencil planes
  and the rhs, scale it symmetrically by its diagonal, build the weighted
  deflation preconditioner (two-level onto the macro lattice up to 6
  bisections, three-level with a Chebyshev-accelerated middle level from 8
  on) or, with ``pc2="mg"``, the plane-layout aggregation V-cycle, and
  solve with float32 PCG inside float64 iterative refinement, applying the
  exactly symmetrized operator in half storage (``sym_plane_spmv``) from 8
  bisections on; ``smoother="cheb<k>"``
  smooths with a degree-k Chebyshev polynomial instead of block Jacobi;
* "stencil": the general block-ELL assembly in float32, permuted into
  planes, then the same deflation preconditioner and refined solve;
* "deflation": the general float32 block-ELL assembly in the structured
  numbering, two-level deflation on the structured SpMV inside float64
  refinement (``la/deflation.py``);
* "mg": the general block-ELL assembly in float64 and block CG with the
  geometric V-cycle over the bisection hierarchy (``la/multigrid.py``).

The first three reach a true relative residual ``tol``; "mg" stops on its
CG recurrence residual.  The host set-up is outside the timed call.  The
solver settings are the reference's size-dependent defaults
(``_solver_settings``); where the reference logs a warning and falls back
to another route (a macro lattice that does not tile the fine one), the
port raises ValueError.

``block_provenance_check`` holds the bench's operator and rhs against the
BlockSWIPDG [20 4 1] global system assembled from its local and coupling
parts (``block_system``).
"""
from __future__ import annotations

import statistics
import time
from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import highest_precision, resolve_device
from .discretizations.block_swipdg import BlockSWIPDGDiscretization
from .functions.base import (
    ConstantFunction,
    IndicatorFunction,
    ScaledFunction,
    SumFunction,
    nonparametric,
)
from .functions.spe10 import MODEL1_NX, MODEL1_NZ, Spe10Model1Function, _synthetic_model1_field
from .grid.boundaryinfo import make_boundary_info
from .grid.structured import alu_cube_grid
from .grid.structured_order import structured_cell_order
from .kernels.plane_spmv import plane_spmv
from .kernels.structured_spmv import structured_spmv
from .la.block_ell import (
    StructuredBlockEll,
    block_cg,
    build_block_ell,
    symmetric_diagonal_scaling,
)
from .la.deflation import refined_deflated_solve, structured_deflation_preconditioner
from .la.multigrid import MultigridHierarchy, mg_preconditioner
from .la.stencil import (
    StencilBlockEll,
    chebyshev_smoother,
    soa_index_maps,
    stencil_deflation_preconditioner,
    stencil_refined_solve,
)
from .la.stencil_multigrid import stencil_multigrid_preconditioner
from .la.stencil_assembly import (
    assemble_structured_spe10,
    assembly_tensors,
    build_structured_assembly,
    geometric_soa_maps,
    precompute_coefficient,
    scale_planes,
    structured_rhs,
)
from .ops.assembly import elliptic_cell_matrices, force_cell_vectors
from .ops.spaces import dg_space
from .ops.swipdg import swipdg_face_blocks
from .problems.default import DefaultProblem
from .testcases._spe10_channel import CHANNEL
from .utils.logging import timed
from .utils.profiling import span

__all__ = ["build_spe10_bench", "run_spe10_bench", "Spe10Bench", "BenchSolution",
           "stencil2_roofline", "block_provenance_check", "block_system",
           "spe10_block_discretization"]

_FORCES = [
    ((0.95, 0.30), (1.10, 0.45), 2000.0),
    ((3.00, 0.75), (3.15, 0.90), -1000.0),
    ((4.25, 0.25), (4.40, 0.40), -1000.0),
]
_MACRO = (MODEL1_NX, MODEL1_NZ)  # deflation aggregates = permeability cells
PRECONDITIONERS = ("stencil2", "stencil", "deflation", "mg")
# refinement sweeps of the "deflation" branch.  The reference's 6 are one
# short at 768k DoF once the float32 operator rounds differently: its own
# operator reaches 3.4e-7 in 6 sweeps, one 4.5e-7 apart (the port's, on the
# CPU) 2.5e-6 in 6 and 1.3e-7 in 7.  The loop stops at the tolerance, so
# the cap costs nothing where fewer sweeps suffice.
DEFLATION_OUTER_MAX = 12


class SolverSettings(NamedTuple):
    inner_iters: int     # PCG iterations per refinement sweep
    inner_rtol: float    # sweep exit: short sweeps, the f64 residual re-anchors
    outer_max: int       # refinement sweeps
    unroll: int          # PCG iterations between convergence checks
    newton_schulz: int   # polish passes of the dense coarse inverse
    mid_cheb: int        # Chebyshev degree of the middle-level inverse
    symmetric: bool      # apply the exactly symmetrized operator


def _solver_settings(bisections: int, lattice) -> SolverSettings:
    """The reference bench's size-dependent solver defaults: longer sweeps
    from 8 bisections on, a sweep exit tolerance that grows with size (the
    float32 true progress per sweep shrinks with size), and the symmetric
    operator once the lattice has >= 128000 cells per subclass (160 x 800,
    8 bisections)."""
    KY, KX = lattice
    inner_rtol = 7e-1 if bisections >= 10 else 3e-1 if bisections >= 8 else 1e-1
    return SolverSettings(
        inner_iters=300 if bisections >= 8 else 150,
        inner_rtol=inner_rtol,
        outer_max=500 if inner_rtol >= 3e-1 else 120,
        unroll=2, newton_schulz=2, mid_cheb=2,
        symmetric=KY * KX >= 128000)


def _select_mid_level(KY: int, KX: int, macro) -> Optional[object]:
    """Middle aggregation level(s) the reference inserts between the fine
    and the ``macro`` lattice once the aggregation factor reaches 8: None,
    one (mx, my), or a finest-first list.  None up to 6 bisections."""
    if macro is None or KX % macro[0] or KY % macro[1]:
        return None
    fx, fy = KX // macro[0], KY // macro[1]
    if min(fx, fy) < 8:
        return None
    mids = []
    mx, my = 4 * macro[0], 4 * macro[1]
    while mx < KX and my < KY and KX % mx == 0 and KY % my == 0:
        mids.append((mx, my))
        if KX // mx <= 4:
            break
        mx, my = 4 * mx, 4 * my
    if not mids:
        return None
    mids.reverse()  # finest mid first
    return mids[0] if len(mids) == 1 else mids


class BenchSolution(NamedTuple):
    u: torch.Tensor      # float64 solution, flat cell-major original order
    residual: float      # true relative residual of the scaled system ("mg": CG's recurrence one)
    iterations: int      # total inner PCG iterations ("mg": block CG iterations)
    sweeps: int          # outer refinement sweeps ("mg": 1)


class Spe10Bench(NamedTuple):
    fn: Callable         # permeability field -> BenchSolution (the timed call)
    field: torch.Tensor  # [MODEL1_NX, MODEL1_NZ] float32 example field
    num_dofs: int
    assemble: Callable   # field -> (A, b, s): assembly + scaling part of fn
    solve: Callable      # (A, b, s) -> BenchSolution: the rest of fn
    precondition: Callable  # (A, s) -> (the operator solve applies, its M)
    to_soa: Optional[torch.Tensor]  # flat original -> SoA [nd, 8, KY, KX] map (stencil branches)
    settings: SolverSettings
    mid_shape: object    # middle lattice(s) of the deflation preconditioner, or None
    offsets: tuple       # 8 x 3 flat cell offsets of the structured order
    preconditioner: str  # the branch


class _BenchGeometry(NamedTuple):
    grid: object             # the ALU-bisected 100 x 20 grid
    binfo: object            # its all-Dirichlet boundary info
    order: object            # its structured cell order (lattice (KY, KX))
    tensors: object          # AssemblyTensors on the device
    to_soa: torch.Tensor     # flat original -> SoA [nd, 8, KY, KX] index map
    from_soa: torch.Tensor   # flat SoA -> original
    broadcast: Callable      # [MODEL1_NX, MODEL1_NZ] field -> [8, KY, KX] cell field


def _diffusion_factor():
    channel = IndicatorFunction(CHANNEL, name="channel")
    return SumFunction([ConstantFunction(1.0), ScaledFunction(channel, -0.9)],
                       name="diffusion_factor")


@lru_cache(maxsize=1)
def _bench_geometry(bisections: int, device) -> _BenchGeometry:
    """The bench operator's host set-up on ``device``: grid, structured
    order, assembly plan with the static channel coefficient, SoA maps, and
    the broadcast of the permeability field onto the lattice, checked
    against the centroid binning.  The last one is kept, so a bench built
    again at the same size shares it."""
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=bisections)
    binfo = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    KY, KX = order.lattice
    splan = build_structured_assembly(grid, order, binfo)
    # the channel geometry is static: evaluate it once on the host
    tensors = assembly_tensors(splan, precompute_coefficient(splan, _diffusion_factor()), device)
    to_soa, from_soa = geometric_soa_maps(order, splan)
    # the macro grid tiles the lattice, so the cell-constant permeability in
    # SoA order is a pure broadcast cf[k, iy, ix] = field[ix // fx, iy // fy];
    # verify that layout against the centroid binning
    fy, fx = KY // MODEL1_NZ, KX // MODEL1_NX
    ij_cell = np.clip(
        (grid.cell_centroids / np.array([5.0, 1.0]) * np.array([MODEL1_NX, MODEL1_NZ]))
        .astype(np.int64), 0, np.array([MODEL1_NX - 1, MODEL1_NZ - 1]))
    ij_soa = ij_cell[np.asarray(order.inv)].reshape(8, KY, KX, 2)
    iyg, ixg = np.meshgrid(np.arange(KY), np.arange(KX), indexing="ij")
    if not ((ij_soa[..., 0] == (ixg // fx)[None]).all()
            and (ij_soa[..., 1] == (iyg // fy)[None]).all()):
        raise AssertionError("permeability broadcast does not match the centroid binning")

    def broadcast(field: torch.Tensor) -> torch.Tensor:
        cf2d = field.t()[:, None, :, None].expand(MODEL1_NZ, fy, MODEL1_NX, fx)
        return cf2d.reshape(KY, KX)[None].expand(8, KY, KX)

    return _BenchGeometry(grid, binfo, order, tensors,
                          torch.as_tensor(to_soa, dtype=torch.long, device=device),
                          torch.as_tensor(from_soa, dtype=torch.long, device=device), broadcast)


def _block_assembly(geo: _BenchGeometry, device, dtype: torch.dtype) -> Callable:
    """field -> (S A S, S b, S): the general SWIPDG assembly into block-ELL
    layout in ``dtype``, symmetrically scaled by the diagonal."""
    grid = geo.grid
    space = dg_space(grid, device=device, dtype=dtype)
    interior = np.nonzero(grid.interior_faces)[0]
    dirichlet = np.nonzero(geo.binfo.dirichlet_faces)[0]
    dfac, force = _diffusion_factor(), IndicatorFunction(_FORCES, name="force")

    def assemble(field: torch.Tensor):
        # the reference's _field_tensor_function: the cell lookup as an
        # isotropic tensor, its values in the points' dtype
        tensor = Spe10Model1Function.from_field(field, name="spe10_field")
        vol = elliptic_cell_matrices(space, dfac, tensor)
        ib, bb = swipdg_face_blocks(space, dfac, tensor, interior, dirichlet)
        A = build_block_ell(space, vol, ib, bb, interior, dirichlet)
        return symmetric_diagonal_scaling(A, force_cell_vectors(space, force).reshape(-1))

    return assemble


def _chebyshev_degree(smoother: str) -> int:
    """0 for "jacobi", k for "cheb<k>" (2 for "cheb")."""
    if smoother == "jacobi":
        return 0
    if smoother.startswith("cheb") and (smoother[4:].isdigit() or smoother == "cheb"):
        return int(smoother[4:] or 2)
    raise ValueError(f"smoother must be 'jacobi' or 'cheb<k>', got {smoother!r}")


def build_spe10_bench(bisections: int = 4, tol: float = 1e-6, device="cuda",
                      spmv: Callable = plane_spmv, macro=_MACRO,
                      preconditioner: str = "stencil2", smoother: str = "jacobi",
                      pc2: str = "deflation", maxiter: int = 300,
                      structured: Callable = structured_spmv) -> Spe10Bench:
    """Set up the bench at ``bisections`` (even) on ``device`` (the card
    unless the caller passes ``device="cpu"``; raises without one) for the
    ``preconditioner`` branch (module docstring).  ``spmv`` is the
    full-plane SpMV of the operator, ``plane_spmv`` or its plain version
    ``plane_spmv_reference``; where the settings use half storage (8
    bisections and more) the operator applies the half-storage SpMV of the
    same family (``kernels/sym_plane_spmv.half_storage``), so a substituted
    plain version stays plain.  ``structured`` is the structured SpMV, the
    kernel or its plain version; ``macro`` is
    the exact coarse lattice of the deflation preconditioners (the
    permeability grid by default; ValueError if it does not tile the
    lattice); ``smoother`` ("jacobi" or "cheb<k>") and ``pc2`` ("deflation"
    or "mg", stencil2 only) are the reference's BENCH_SMOOTHER / BENCH_PC2
    switches; ``maxiter`` bounds the "mg" branch's block CG."""
    if bisections % 2 or bisections < 2:
        raise ValueError(f"bench sizes need an even number >= 2 of bisections, "
                         f"got {bisections}")
    if preconditioner not in PRECONDITIONERS:
        raise ValueError(f"preconditioner must be one of {PRECONDITIONERS}, "
                         f"got {preconditioner!r}")
    cheb = _chebyshev_degree(smoother)
    if cheb and preconditioner not in ("stencil", "stencil2"):
        raise ValueError(f"smoother {smoother!r} is for the stencil branches, "
                         f"not {preconditioner!r}")
    if pc2 not in ("deflation", "mg") or (pc2 == "mg" and preconditioner != "stencil2"):
        raise ValueError(f"pc2 must be 'deflation', or 'mg' with stencil2; got {pc2!r} "
                         f"with {preconditioner!r}")
    # structured lattice of the bisected 100 x 20 criss grid (checked below)
    KY, KX = 10 << (bisections // 2), 50 << (bisections // 2)
    if preconditioner != "mg" and pc2 != "mg" and (KX % macro[0] or KY % macro[1]):
        raise ValueError(f"macro {tuple(macro)} does not tile the {KY} x {KX} lattice of "
                         f"{bisections} bisections (the reference falls back to another "
                         "route there; the port raises)")
    mid_shape = _select_mid_level(KY, KX, macro)
    settings = _solver_settings(bisections, (KY, KX))
    highest_precision()
    device = resolve_device(device)
    geo = _bench_geometry(bisections, device)
    order = geo.order
    if order.lattice != (KY, KX):
        raise AssertionError(f"structured lattice {order.lattice}, expected {(KY, KX)}")
    field = torch.as_tensor(_synthetic_model1_field(), dtype=torch.float32, device=device)
    num_dofs = geo.grid.num_cells * 3
    to_soa = None

    def deflation_pc(S, weight, sm):
        """The weighted deflation preconditioner of the stencil branches; the
        factored BCR's defect correction in float64, as the reference bench
        applies it (x64 on)."""
        return stencil_deflation_preconditioner(
            S, macro, weight=weight, smoother=sm, newton_schulz=settings.newton_schulz,
            mid_shape=mid_shape, mid_cheb=settings.mid_cheb, residual_dtype=torch.float64)

    def refined(S, B, M):
        return stencil_refined_solve(S, B, M, tol=tol, inner_iters=settings.inner_iters,
                                     inner_rtol=settings.inner_rtol,
                                     outer_max=settings.outer_max, unroll=settings.unroll)

    if preconditioner == "stencil2":
        force = IndicatorFunction(_FORCES)
        to_soa = geo.to_soa

        def assemble(field: torch.Tensor):
            with span("assemble", device=True):
                S = assemble_structured_spe10(geo.tensors,
                                              geo.broadcast(field.to(torch.float32)))
                S = StencilBlockEll(S.planes, S.plan, spmv)
                return scale_planes(S, structured_rhs(geo.tensors, force))

        def precondition(S: StencilBlockEll, s: torch.Tensor):
            if settings.symmetric:
                S = S.symmetrized()
            sm = chebyshev_smoother(S, degree=cheb) if cheb else None
            if pc2 == "mg":
                return S, stencil_multigrid_preconditioner(
                    S, newton_schulz=settings.newton_schulz, smoother=sm)
            # weighted deflation space Z_w = diag(1/s) Z: the scaled system
            # has near-kernel D^{1/2} 1, not constants
            return S, deflation_pc(S, 1.0 / s, sm)

        def solve(S: StencilBlockEll, B: torch.Tensor, s: torch.Tensor) -> BenchSolution:
            with span("precond.build", device=True):
                S, M = precondition(S, s)
            X, res, iters, sweeps = refined(S, B, M)
            return BenchSolution((X * s.to(X.dtype)).reshape(-1)[geo.from_soa], res, iters,
                                 sweeps)
    elif preconditioner == "stencil":
        maps = soa_index_maps(order, 3)
        to_soa = torch.as_tensor(maps.to_soa, dtype=torch.long, device=device)
        from_soa = torch.as_tensor(maps.from_soa, dtype=torch.long, device=device)
        assemble = _block_assembly(geo, device, torch.float32)

        def planes(v):
            return v[to_soa].reshape(3, 8, KY, KX)

        def precondition(A, s: torch.Tensor):
            S = StencilBlockEll.from_block_ell(A, order)
            S = StencilBlockEll(S.planes, S.plan, spmv)
            sm = chebyshev_smoother(S, degree=cheb) if cheb else None
            return S, deflation_pc(S, planes(1.0 / s), sm)

        def solve(A, b: torch.Tensor, s: torch.Tensor) -> BenchSolution:
            S, M = precondition(A, s)
            X, res, iters, sweeps = refined(S, planes(b), M)
            return BenchSolution(X.reshape(-1)[from_soa] * s.to(X.dtype), res, iters, sweeps)
    elif preconditioner == "deflation":
        nd = 3
        perm = torch.as_tensor((np.asarray(order.perm)[:, None] * nd
                                + np.arange(nd)).reshape(-1)).to(device)
        inv_flat = torch.as_tensor((np.asarray(order.inv)[:, None] * nd
                                    + np.arange(nd)).reshape(-1)).to(device)
        assemble = _block_assembly(geo, device, torch.float32)

        def precondition(A, s: torch.Tensor):
            A_st = StructuredBlockEll.from_block_ell(A, order, structured)
            return A_st, structured_deflation_preconditioner(A_st, order, macro,
                                                             coarse_dtype=torch.float32)

        def solve(A, b: torch.Tensor, s: torch.Tensor) -> BenchSolution:
            A_st, M = precondition(A, s)
            u_st, res, iters, sweeps = refined_deflated_solve(
                A_st, b[inv_flat], None, macro[0] * macro[1], tol=tol,
                inner_iters=settings.inner_iters, outer_max=DEFLATION_OUTER_MAX, M=M, unroll=4)
            return BenchSolution(u_st[perm] * s.to(u_st.dtype), res, iters, sweeps)
    else:  # "mg": float64, as the reference's assembly promotes under x64
        grids = [geo.grid] + [alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=b)
                              for b in range(bisections - 2, -1, -2)]
        assemble = _block_assembly(geo, device, torch.float64)

        def precondition(A, s: torch.Tensor):
            return A, mg_preconditioner(MultigridHierarchy(grids, A, pre=3, post=3))

        def solve(A, b: torch.Tensor, s: torch.Tensor) -> BenchSolution:
            A, M = precondition(A, s)
            u, res, iters = block_cg(A, b, tol=tol, maxiter=maxiter, M=M)
            return BenchSolution(u * s, float(res), iters, 1)

    def fn(field: torch.Tensor) -> BenchSolution:
        with span("solve", device=True):
            return solve(*assemble(field))

    return Spe10Bench(fn, field, num_dofs, assemble, solve, precondition, to_soa, settings,
                      mid_shape, order.offsets, preconditioner)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_spe10_bench(bisections: int = 4, repeats: int = 3, tol: float = 1e-6,
                    device="cuda", **options) -> dict:
    """Median wall time of ``repeats`` timed calls (after one warm-up call),
    each on the field perturbed by 1 + 1e-6 (i+1); ``options`` go to
    ``build_spe10_bench`` (the branch and its switches).  Besides the
    numbers (set-up and warm-up seconds included), the dict carries the
    bench object, the last field and the last solution."""
    t0 = time.perf_counter()
    bench = build_spe10_bench(bisections=bisections, tol=tol, device=device, **options)
    dev = bench.field.device
    _sync(dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = bench.fn(bench.field)  # warm-up
    _sync(dev)
    warmup_s = time.perf_counter() - t0
    times = []
    for i in range(repeats):
        f = bench.field * (1.0 + 1e-6 * (i + 1))
        _sync(dev)  # the input is ready outside the timed region
        t0 = time.perf_counter()
        sol = bench.fn(f)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    dt = float(statistics.median(times))
    return {
        "num_dofs": bench.num_dofs,
        "setup_seconds": setup_s,
        "warmup_seconds": warmup_s,
        "seconds": dt,
        "mdof_per_s": bench.num_dofs / dt / 1e6,
        "residual": sol.residual,
        "inner_iterations": sol.iterations,
        "outer_sweeps": sol.sweeps,
        "all_times": times,
        "bench": bench,
        "field": f if repeats else bench.field,
        "u": sol.u,
    }


def stencil2_roofline(bisections: int = 6, repeats: int = 7, pcg_iters: int = 100,
                      device="cuda") -> dict:
    """Achieved device-memory GB/s of the stencil2 hot phases at the bench's
    size (the reference's ``stencil2_roofline``), each the median over
    ``repeats`` loops timed between two synchronizations, after one
    untimed loop:

    * ``copy_gbps``: 100 chained ``y = y + 1`` over N float32 values, 8N
      bytes each (read and write);
    * ``matvec_ms`` / ``matvec_gbps``: ``pcg_iters`` chained half-storage
      symmetric matvecs of the scaled operator; bytes model per matvec:
      half the full plane array (the forward plane sets and the upper self
      triangles) plus the input and output vectors;
    * ``assembly_ms`` / ``assembly_gbps``: the direct-to-planes assembly,
      the rhs and the diagonal scaling; bytes model: the plane array
      written once plus two vectors.

    The models count the traffic the algorithm needs (the reference's; the
    exact half-storage read is 19.5 of 36 plane values per cell at nd 3, so
    the matvec model undercounts it by ~8%), so the GB/s are lower bounds
    of what the card moved.  The host set-up is the bench's cached
    ``_bench_geometry``; runs on ``device`` (the card unless the caller
    asks for the CPU).  Unlike the reference's, the numbers are not
    rounded."""
    highest_precision()
    device = resolve_device(device)
    geo = _bench_geometry(bisections, device)
    field = torch.as_tensor(_synthetic_model1_field(), dtype=torch.float32, device=device)
    force = IndicatorFunction(_FORCES)
    n = geo.grid.num_cells * 3

    def loop_seconds(fn, reps):
        fn()
        _sync(device)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            _sync(device)
            times.append(time.perf_counter() - t0)
        return float(statistics.median(times)) / reps

    def assemble():
        S = assemble_structured_spe10(geo.tensors, geo.broadcast(field))
        return scale_planes(S, structured_rhs(geo.tensors, force))

    t_asm = loop_seconds(assemble, 4)
    S, B, _ = assemble()
    Ssym = S.symmetrized()

    def matvecs():
        Y = B
        for _ in range(pcg_iters):
            Y = Ssym.matvec(Y)
        return Y

    t_mv = loop_seconds(matvecs, 1) / pcg_iters
    x = torch.arange(n, dtype=torch.float32, device=device)
    copy_reps = 100

    def copies():
        y = x
        for _ in range(copy_reps):
            y = y + 1.0
        return y

    t_copy = loop_seconds(copies, 1) / copy_reps
    plane_bytes = float(S.planes.numel()) * 4.0
    sym_read_bytes = plane_bytes * 0.5  # forward edges + upper-triangle self
    vec_bytes = 4.0 * n
    return {
        "num_dofs": int(n),
        "copy_gbps": 8.0 * n / t_copy / 1e9,
        "matvec_ms": t_mv * 1e3,
        "matvec_gbps": (sym_read_bytes + 2 * vec_bytes) / t_mv / 1e9,
        "assembly_ms": t_asm * 1e3,
        "assembly_gbps": (plane_bytes + 2 * vec_bytes) / t_asm / 1e9,
    }


def spe10_block_discretization(grid, field: torch.Tensor, partitioning=(20, 4), device="cuda"
                               ) -> BlockSWIPDGDiscretization:
    """The bench's SPE10 problem (channel-modulated diffusion factor, the
    permeability ``field`` as tensor, box forces, all Dirichlet) as a
    BlockSWIPDG discretization of ``grid`` with ``partitioning``, no
    products."""
    channel = IndicatorFunction(CHANNEL, name="channel")
    problem = DefaultProblem(
        diffusion_factor=nonparametric(SumFunction(
            [ConstantFunction(1.0), ScaledFunction(channel, -0.9)], name="diffusion_factor")),
        diffusion_tensor=nonparametric(Spe10Model1Function.from_field(field,
                                                                     name="spe10_field")),
        force=nonparametric(IndicatorFunction(_FORCES, name="force")))
    return BlockSWIPDGDiscretization(
        grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}, problem,
        num_partitions=tuple(partitioning), only_these_products=(), device=device)


def block_system(bdisc, mu=None):
    """(matvec, rhs) of the global system of a BlockSWIPDGDiscretization
    assembled from its parts: the per-subdomain local operators and
    functionals plus the pairwise coupling operators, frozen at ``mu`` and
    applied on the discretization's device.  Builds every part (spans
    "block.locals" and "block.couplings" of the record while recording)."""
    dev = bdisc.device
    S = bdisc.num_subdomains()
    dofs = [torch.as_tensor(bdisc._local_dof_map(ss)).to(dev) for ss in range(S)]
    with timed("block.locals", sync=dev):
        locals_ = [bdisc.get_local_operator(ss).freeze(mu) for ss in range(S)]
        rhs = torch.zeros(bdisc.space.num_dofs, dtype=bdisc.space.dtype, device=dev)
        for ss in range(S):
            rhs[dofs[ss]] += bdisc.get_local_rhs(ss).freeze(mu)
    with timed("block.couplings", sync=dev):
        couplings = [(ss, int(nn), bdisc.get_coupling_operator(ss, int(nn)).freeze(mu))
                     for ss in range(S) for nn in bdisc.neighbouring_subdomains(ss) if nn > ss]

    def matvec(x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for A, d in zip(locals_, dofs):
            y[d] += A.matvec(x[d])
        for ss, nn, c in couplings:
            ds, dn = dofs[ss], dofs[nn]
            xs, xn = x[ds], x[dn]
            y[ds] += c.in_in.matvec(xs)
            y[ds] += c.in_out.matvec(xn)
            y[dn] += c.out_in.matvec(xs)
            y[dn] += c.out_out.matvec(xn)
        return y

    return matvec, rhs


def block_provenance_check(bisections: int = 2, partitioning=(20, 4), nvec: int = 3,
                           seed: int = 0, device="cuda") -> dict:
    """Assert that the operator and rhs the bench assembles are the
    BlockSWIPDG global system: the bench's frozen stencil operator (its own
    builders, applied through ``plane_spmv`` in float32) against the sum of
    the per-subdomain local operators and pairwise couplings of
    ``BlockSWIPDGDiscretization`` on the [20 4 1] partitioning (float64), on
    ``nvec`` random vectors; rel_op and rel_rhs <= 1e-4.  Runs on ``device``
    (the card unless the caller asks for the CPU); raises AssertionError
    past the gate, else returns the record."""
    highest_precision()
    device = resolve_device(device)
    bisections -= bisections % 2  # the structured order needs even bisections
    geo = _bench_geometry(bisections, device)
    KY, KX = geo.order.lattice
    field = torch.as_tensor(_synthetic_model1_field(), dtype=torch.float32, device=device)
    force = IndicatorFunction(_FORCES, name="force")

    # the benched operator: the bench's builders, frozen at the example field
    S = assemble_structured_spe10(geo.tensors, geo.broadcast(field))
    b_bench = structured_rhs(geo.tensors, force).reshape(-1)[geo.from_soa].double()

    def bench_matvec(x: torch.Tensor) -> torch.Tensor:
        X = x.to(S.planes.dtype)[geo.to_soa].reshape(3, 8, KY, KX)
        return S.matvec(X).reshape(-1)[geo.from_soa].double()

    # the block artifact: per-subdomain locals + pairwise couplings
    bdisc = spe10_block_discretization(geo.grid, field, partitioning, device)
    block_matvec, b_block = block_system(bdisc, {})

    rng = np.random.default_rng(seed)
    n = bdisc.space.num_dofs
    rel_op = 0.0
    for _ in range(nvec):
        x = torch.as_tensor(rng.standard_normal(n)).to(device)
        yb, ys = block_matvec(x), bench_matvec(x)
        rel_op = max(rel_op, float(torch.linalg.norm(ys - yb)
                                   / max(float(torch.linalg.norm(yb)), 1e-30)))
    rel_rhs = float(torch.linalg.norm(b_bench - b_block)
                    / max(float(torch.linalg.norm(b_block)), 1e-30))
    if rel_op > 1e-4 or rel_rhs > 1e-4:
        raise AssertionError(f"bench operator != BlockSWIPDG global system: "
                             f"rel_op={rel_op:.3e} rel_rhs={rel_rhs:.3e}")
    return {
        "artifact": "block-swipdg",
        "partitioning": [int(partitioning[0]), int(partitioning[1]), 1],
        "num_subdomains": int(bdisc.num_subdomains()),
        "checked_dofs": int(n),
        "bisections": int(bisections),
        "rel_op": rel_op,
        "rel_rhs": rel_rhs,
    }
