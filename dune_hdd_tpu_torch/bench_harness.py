"""Benchmark harness: SPE10 SWIPDG assemble + solve to a true 1e-6 residual.

Counterpart of the ``preconditioner="stencil2"`` path of
``dune_hdd_tpu/bench_harness.py``.  The SPE10 model-1 problem (100 x 20
permeability cells on [0,5] x [0,1], channel-modulated diffusion factor,
three box forces, all-Dirichlet boundary) is discretized with P1 SWIPDG on
the ALU-bisected 100 x 20 cube grid.  Per call, from the permeability field
as a device tensor:

1. assemble the operator directly into stencil planes and the rhs;
2. scale it symmetrically by its diagonal;
3. build the weighted deflation preconditioner: two-level onto the macro
   lattice (the 100 x 20 permeability grid, dense BCR / LU coarse inverse)
   up to 6 bisections, three-level (a middle lattice of 4 x the macro's
   with a Chebyshev-accelerated two-level inverse) from 8 bisections on;
4. solve with float32 PCG inside float64 iterative refinement, applying the
   exactly symmetrized operator from 8 bisections on.

The host geometry plan, the static coefficient and the kernel build are
set-up, outside the timed call.  The solver settings are the reference's
size-dependent defaults (``_solver_settings``).
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device
from .functions.base import ConstantFunction, IndicatorFunction, ScaledFunction, SumFunction
from .functions.spe10 import MODEL1_NX, MODEL1_NZ, _synthetic_model1_field
from .grid.boundaryinfo import make_boundary_info
from .grid.structured import alu_cube_grid
from .grid.structured_order import structured_cell_order
from .kernels.plane_spmv import plane_spmv
from .la.stencil import (
    StencilBlockEll,
    stencil_deflation_preconditioner,
    stencil_refined_solve,
)
from .la.stencil_assembly import (
    assemble_structured_spe10,
    assembly_tensors,
    build_structured_assembly,
    geometric_soa_maps,
    precompute_coefficient,
    scale_planes,
    structured_rhs,
)
from .testcases._spe10_channel import CHANNEL

__all__ = ["build_spe10_bench", "run_spe10_bench", "Spe10Bench", "BenchSolution"]

_FORCES = [
    ((0.95, 0.30), (1.10, 0.45), 2000.0),
    ((3.00, 0.75), (3.15, 0.90), -1000.0),
    ((4.25, 0.25), (4.40, 0.40), -1000.0),
]
_MACRO = (MODEL1_NX, MODEL1_NZ)  # deflation aggregates = permeability cells


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
    residual: float      # true relative residual of the scaled system
    iterations: int      # total inner PCG iterations
    sweeps: int          # outer refinement sweeps


class Spe10Bench(NamedTuple):
    fn: Callable         # permeability field -> BenchSolution (the timed call)
    field: torch.Tensor  # [MODEL1_NX, MODEL1_NZ] float32 example field
    num_dofs: int
    assemble: Callable   # field -> (S, B, s): assembly + scaling part of fn
    solve: Callable      # (S, B, s) -> BenchSolution: the rest of fn
    precondition: Callable  # (S, s) -> (S, M): the operator solve applies, its M
    to_soa: torch.Tensor  # flat original -> SoA [nd, 8, KY, KX] index map
    settings: SolverSettings
    mid_shape: object    # middle lattice(s) of the preconditioner, or None
    offsets: tuple       # 8 x 3 flat cell offsets of the structured order


def _highest_precision() -> None:
    """Full float32 products everywhere: TF32 assembles an asymmetric
    operator (~1e-3 relative), which breaks CG."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build_spe10_bench(bisections: int = 4, tol: float = 1e-6, device="cuda",
                      spmv: Callable = plane_spmv, macro=_MACRO) -> Spe10Bench:
    """Set up the bench at ``bisections`` (even) on ``device`` (the card
    unless the caller passes ``device="cpu"``; raises without one).  ``spmv`` is
    the SpMV the operator applies (the CUDA kernel's plain version can be
    substituted for comparison); ``macro`` is the exact coarse lattice of
    the preconditioner (the permeability grid by default)."""
    if bisections % 2 or bisections < 2:
        raise ValueError(f"bench sizes need an even number >= 2 of bisections, "
                         f"got {bisections}")
    # structured lattice of the bisected 100 x 20 criss grid (checked below)
    KY, KX = 10 << (bisections // 2), 50 << (bisections // 2)
    mid_shape = _select_mid_level(KY, KX, macro)
    settings = _solver_settings(bisections, (KY, KX))
    _highest_precision()
    device = resolve_device(device)
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=bisections)
    binfo = make_boundary_info(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"})
    order = structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0))
    if order.lattice != (KY, KX):
        raise AssertionError(f"structured lattice {order.lattice}, expected {(KY, KX)}")
    channel = IndicatorFunction(CHANNEL)
    diffusion_factor = SumFunction([ConstantFunction(1.0), ScaledFunction(channel, -0.9)])
    force = IndicatorFunction(_FORCES)
    splan = build_structured_assembly(grid, order, binfo)
    # the channel geometry is static: evaluate it once on the host
    tensors = assembly_tensors(splan, precompute_coefficient(splan, diffusion_factor),
                               device)
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
    from_soa_t = torch.as_tensor(from_soa, dtype=torch.long, device=device)
    to_soa_t = torch.as_tensor(to_soa, dtype=torch.long, device=device)

    def broadcast_field(field32: torch.Tensor) -> torch.Tensor:
        cf2d = field32.t()[:, None, :, None].expand(MODEL1_NZ, fy, MODEL1_NX, fx)
        return cf2d.reshape(KY, KX)[None].expand(8, KY, KX)

    def assemble(field: torch.Tensor):
        S = assemble_structured_spe10(tensors, broadcast_field(field.to(torch.float32)))
        S = StencilBlockEll(S.planes, S.plan, spmv)
        return scale_planes(S, structured_rhs(tensors, force))

    def precondition(S: StencilBlockEll, s: torch.Tensor):
        if settings.symmetric:
            S = S.symmetrized()
        # weighted deflation space Z_w = diag(1/s) Z: the scaled system has
        # near-kernel D^{1/2} 1, not constants
        return S, stencil_deflation_preconditioner(
            S, macro, weight=1.0 / s, newton_schulz=settings.newton_schulz,
            mid_shape=mid_shape, mid_cheb=settings.mid_cheb)

    def solve(S: StencilBlockEll, B: torch.Tensor, s: torch.Tensor) -> BenchSolution:
        S, M = precondition(S, s)
        X, res, iters, sweeps = stencil_refined_solve(
            S, B, M, tol=tol, inner_iters=settings.inner_iters,
            inner_rtol=settings.inner_rtol, outer_max=settings.outer_max,
            unroll=settings.unroll)
        u = (X * s.to(X.dtype)).reshape(-1)[from_soa_t]
        return BenchSolution(u, res, iters, sweeps)

    def fn(field: torch.Tensor) -> BenchSolution:
        return solve(*assemble(field))

    field = torch.as_tensor(_synthetic_model1_field(), dtype=torch.float32, device=device)
    return Spe10Bench(fn, field, grid.num_cells * 3, assemble, solve, precondition, to_soa_t,
                      settings, mid_shape, order.offsets)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_spe10_bench(bisections: int = 4, repeats: int = 3, tol: float = 1e-6,
                    device="cuda") -> dict:
    """Median wall time of ``repeats`` timed calls (after one warm-up call),
    each on the field perturbed by 1 + 1e-6 (i+1).  Besides the numbers
    (set-up and warm-up seconds included), the dict carries the bench
    object, the last field and the last solution."""
    t0 = time.perf_counter()
    bench = build_spe10_bench(bisections=bisections, tol=tol, device=device)
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
