#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: builds the four CUDA
kernels, checks each against its plain PyTorch version, drives the SPE10
SWIPDG assemble-and-solve bench at 768k, 3.07M and 12.29M DoF (6, 8 and 10
bisections) through the plane SpMV kernel (from 3.07M on its half-storage
symmetric form, ``sym_plane_spmv``), runs ``stencil2_roofline`` at 3.07M
DoF and ``python -m dune_hdd_tpu_torch.bench`` at 768k in a process of its
own, drives the structured SpMV and
the probe through their own entry points, times every kernel beside its
plain version and one library call that computes the same function, then
runs the bench's other branches at 768k DoF (two-level deflation on the
structured SpMV, the stencil branch, geometric multigrid in float64, the
Chebyshev smoother and the plane multigrid) and the (200, 40) coarse space
at 3.07M DoF through the factored BCR, then
runs the ESV2007 EOC study with its a-posteriori estimators (levels 0-6, up
to 1.57M DoF), the CG-P1 EOC study on the same hierarchy, the BlockSWIPDG /
OS2014 path (the published block table at four partitionings, [8 8 1] to
1.57M DoF, the OS2014 parametric and SPE10 parametric block studies, the
bench's block provenance check at 768k and 3.07M DoF), 8 online
thermalblock solves at 1.57M DoF through the general parametric SWIPDG
path, and model order reduction: the RB / LRBMS greedy workflow on that
1.57M-DoF thermalblock and the adaptive LRBMS enrichment; and the higher
orders and other cells: SWIPDG P2 to 3.15M DoF and P3 to 1.31M DoF on the
ESV2007 hierarchy (stencil_cg on the plane SpMV at 6 and 10 DoF per cell,
the RT1 estimators for P2), Q1 / Q2 on the ESV2007 cube (quad) hierarchy,
CG P2 / P3 / Q2, interval SWIPDG orders 1-3 and gmres; then the
command-line entry point (every example, the ESV2007 level-6 grid through
--solver stencil_cg, rb, both studies) and the tensor Q1 CG path: the
manufactured-sine EOC in d = 1, 2, 3 up to 128^3 cells and the 3D
parametric thermalblock at 2,146,689 DoF through the RB greedy; and the
sharded layer on 4 virtual shards of the card: the 12.29M system in 4
x-slabs through the plane SpMV's slab mode (matvec bitwise, to a true 1e-6
against the stencil2 solution), the native connectivity at 12.29M, the
1.57M-DoF BlockSWIPDG [2 2] through as_sharded (per-shard assembly, the halo
and all-gather solves), the 2 x 2 parameter sweeps and the 3-stage pipeline
at 98,304 DoF, and the process group without an environment; last the RB
demo (``examples/thermalblock_rb_demo``) at its defaults.  Exits non-zero
if any phase fails or there is no card.

    python3 chip_smoke.py

Phases (one line of output each, each with its seconds): device, build
(registers, shared memory and spills per kernel function; the plane SpMV's
tile, ring and dynamic shared memory per instantiation), kernel vs plain
(plane SpMV at 6 and 2 bisections, and bitwise at every nd and dtype on
random planes with nonzero wrapped blocks; the half-storage SpMV bitwise at
every nd and dtype on random planes under the bench's plan; structured SpMV on the
768k-DoF operator and on random blocks; probe bitwise at three sizes and on
offset views, both of its paths), main path at 6 bisections, the other
branches from one block-ELL assembly of the bench field (deflation three
times, the median, its structured SpMV launches counted; stencil against
the stencil2 solution; mg with its levels, damping and V-cycle seconds;
stencil2 with cheb2 and with pc2=mg; each preconditioner apply first held
against its twin on the plain SpMVs; every solve to a true 1e-6 rechecked
in float64, mg's block CG to 1e-5), structured path (a power iteration),
probe path, kernel path vs plain path at 4 bisections, kernel timing at
768k DoF (the probe at [64, 128] and 2^24, and its scalar path), main
path at 8 bisections with the symmetric operator's checks (the
half-storage kernel bitwise its plain version in f32 and f64, within 1e-6 /
1e-14 x max of plane_spmv on the materialized symmetric planes, timed), the
roofline, the same size
with macro (200, 40) (the factored BCR from the coarse bands, to a true
1e-6; then the factored solve of its dense E against torch.linalg.solve in
float64), the bench entry point, main path at 10
bisections with the half-storage kernel and the plane SpMV (on the
materialized symmetric planes) checked against their plain versions and
timed, the ESV2007 study (stencil_cg with the
4x4 macro and the six ESV2007 estimators: the table of errors, estimates
and efficiencies at levels 0-3, EOC at 4-6, RT0 local conservation at level
6), the CG study (Jacobi CG, EOC from level 2 on), the block ESV2007 table
(stencil_cg at [1 1 1] ... [8 8 1], levels 0-3 against the published OS2014
columns, [8 8 1] to level 6 with EOC and efficiency), the OS2014 parametric
[4 4 1] study at four (mu, mu_bar, mu_hat) triples, the SPE10 parametric
[20 4 1] study against its 384,000-DoF reference, the block provenance
check (768k and 3.07M DoF) and the
thermalblock online solves (block_cg through make_solve_fn, each rechecked
in float64, one stencil_cg solve, the plane SpMV timed on its (256, 256)
f64 operator, RT0 local conservation and eta_ESV2007),
the RB workflow on the same grid (BlockSWIPDG [2 2]: the RB and LRBMS greedy
with the Riesz estimator and stencil_cg snapshots, their errors at the 8
solved mu, the batched online sweep over 1,024 mu against single solves,
save/load), the recorded adaptive LRBMS trajectory on SPE10 [20 4 1] and
the adaptive OS2014 [2 2] enrichment with 3 oversampling layers.  After the
block table: the P2 study (levels 0-6, the four RT1-based estimators,
div t_h = Pi_P1 f at level 6) and the P3 study (levels 0-5), each followed
by both SpMV kernels at its nd (against their plain versions, timed beside
the BSR library call, and an f32 power iteration through each); the cube
Q1 study (levels 0-6, the recorded cube table, RT0 conservation) and Q2
(levels 0-5); CG P2 / P3 / Q2 (levels 0-5); interval SWIPDG; gmres and
gmres.jacobi at ESV2007 level 3; the CLI in a temporary directory
(write-config-then-solve for cg, swipdg, block-swipdg and thermalblock with
VTU output, each default config's text against the reference writer's
digest; swipdg on the ESV2007 level-6 grid with --solver stencil_cg, its
plane SpMV launches counted; rb; study --case esv2007 and --case os2014,
the FVCA7 poster rows within 2e-3 of the recorded table); the tensor sine
EOC (d = 1 to 1,024 cells, d = 2 to 512^2, d = 3 to 128^3; EOC 1.9 / 0.95);
the 3D thermalblock at 128^3 cells (set-up by step, 8 cg.jacobi solves
rechecked in float64 to 1e-8, mu = 1 against constant diffusion, the
true-error greedy); the scalar-ELL SpMV kernel against its plain version,
timed against its bound and the CSR library call, on that operator and on
the 1.57M-DoF SWIPDG thermalblock operator in f32 and f64, and its launches
in one 3D solve; the block-Jacobi apply bitwise against its plain version
and timed at the two cells' shapes and at nd 6 and 10, and its launches in
one 1.57M-DoF snapshot solve; the 3D thermalblock at 24^3
with the Riesz-estimator greedy, its certification and the batched online
sweep; the 2D TensorCG batched-online cases.  Then the plane SpMV's launches per
instantiation and lattice with each one's share, a JSON line of the kernels
(one row per plane_spmv instantiation, nd in {3, 6, 10} x {f32, f64}, one
for its (256, 256) f64 lattice, one per structured_spmv nd, the nd-3 row's
launches the deflation branch's, sym_plane_spmv at nd 3 in f32 and f64
at 12.29M DoF, ell_spmv on the 3D operator with its solve's launches, and
block_jacobi at (256, 256) f64 with the snapshot solve's),
the card's name and power limit, and last
{"ok": true, ...}.

    python3 chip_smoke.py --plane-rows [--library]

builds the plane SpMV only and times it at the driven paths' lattices on
random planes, against its bound (with --library also its plain version and
the BSR call).

    python3 chip_smoke.py --ell-spmv

builds the scalar-ELL SpMV and runs its phase only (about two minutes).

    python3 chip_smoke.py --block-jacobi

builds the block-Jacobi apply and runs its phase only: bitwise against its
plain version and timed at the two cells' shapes and at nd 6 and 10, and
its launches in one 1.57M-DoF snapshot solve (about a minute).

    python3 chip_smoke.py --alt-solvers

builds the two SpMVs and runs the main path at 768k DoF, the other branches
there, the main path at 3.07M DoF and the (200, 40) coarse space there
(about a minute).

    python3 chip_smoke.py --sharded

builds the plane SpMV and runs the sharded layer's phases with the paths
they follow (the 12.29M main path, the 1.57M online thermalblock; about
five minutes), and the same slab solve on the assembled planes.

    python3 chip_smoke.py --symmetric

builds both plane SpMVs and runs the half-storage kernel's phases with the
paths they follow (the 3.07M and 12.29M main paths, the roofline, the bench
entry point, the 12.29M timing and sharded solve, the RB demo).
"""
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dune_hdd_tpu_torch.utils.profiling import recording

KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "plane_spmv": ("dune_hdd_tpu_torch/csrc/plane_spmv.cu", "scripts/pallas_plane_repro.py:83"),
    # the same kernel in its slab mode, on the sharded main path
    "plane_spmv_slab": ("dune_hdd_tpu_torch/csrc/plane_spmv.cu",
                        "scripts/pallas_plane_repro.py:83"),
    "structured_spmv": ("dune_hdd_tpu_torch/csrc/structured_spmv.cu",
                        "dune_hdd_tpu/la/pallas_spmv.py:32"),
    "probe": ("dune_hdd_tpu_torch/csrc/probe.cu", "scripts/pallas_minimal_repro.py:7"),
    # not a Pallas kernel: the reference's XLA half-storage symmetric matvec
    "sym_plane_spmv": ("dune_hdd_tpu_torch/csrc/sym_plane_spmv.cu",
                       "dune_hdd_tpu/la/stencil.py:227"),
    # not a Pallas kernel: the reference's XLA gather, product and row sum
    "ell_spmv": ("dune_hdd_tpu_torch/csrc/ell_spmv.cu", "dune_hdd_tpu/la/sparse.py:164"),
    # not a Pallas kernel: the reference's XLA block-Jacobi apply
    "block_jacobi": ("dune_hdd_tpu_torch/csrc/block_jacobi.cu",
                     "dune_hdd_tpu/la/stencil.py:277"),
}
_T0 = time.perf_counter()
_LAST = [_T0]
# plane_spmv and sym_plane_spmv launches on the paths driven, by
# instantiation ("nd3_f32", ...) and by instantiation and lattice
# ("nd3_f64 256x256", ...), from the program's record
PATH_LAUNCHES = Counter()
PATH_LATTICE_LAUNCHES = Counter()
SYM_PATH_LAUNCHES = Counter()
SYM_PATH_LATTICE_LAUNCHES = Counter()
_PATH = []  # the recording of the path being driven: [(context, record)]
_DONE = []  # the record of the last path driven


def start_path():
    """Starts recording the program's spans and counters
    (``utils/profiling.py``) just before a path is driven."""
    context = recording()
    _PATH.append((context, context.__enter__()))


def end_path() -> int:
    """Ends the path's recording, adds the plane SpMVs' launches in it to
    (SYM_)PATH_LAUNCHES by instantiation and to (SYM_)PATH_LATTICE_LAUNCHES
    by instantiation and lattice, and returns their sum (the path's plane
    matvecs, full or half-storage)."""
    context, rec = _PATH.pop()
    context.__exit__(None, None, None)
    _DONE[:] = [rec]
    total = 0
    for kernel, cases, lattices in (("plane_spmv", PATH_LAUNCHES, PATH_LATTICE_LAUNCHES),
                                    ("sym_plane_spmv", SYM_PATH_LAUNCHES,
                                     SYM_PATH_LATTICE_LAUNCHES)):
        for key, n in rec.totals_under(f"kernel.{kernel}.").items():
            lattices[key] += n
            cases[key.split()[0]] += n
        total += rec.total(f"kernel.{kernel}")
    return total


def sym_launches() -> int:
    """sym_plane_spmv's launches since the last ``start_path``."""
    return _PATH[-1][1].total("kernel.sym_plane_spmv")


def last_path_launches(kernel: str, case: str) -> int:
    """``kernel``'s launches of instantiation ``case`` ("nd3_f32", ...) on
    the last path driven."""
    return sum(n for key, n in _DONE[0].totals_under(f"kernel.{kernel}.").items()
               if key.split()[0] == case)


def log(phase, **fields):
    now = time.perf_counter()
    fields["phase_seconds"] = f"{now - _LAST[0]:.2f}"
    _LAST[0] = now
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_check(what, y, y_ref, rel):
    """max |y - y_ref|, raising if it exceeds rel * max |y_ref|."""
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    bound = rel * y_ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"{what}: {err:.3e} > {bound:.3e}")
    return err


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke test needs a card")
    from dune_hdd_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log("device", card=repr(card()), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), count=torch.cuda.device_count())


def ptxas_summary(compiler_log):
    """Per kernel function of an ``nvcc -Xptxas -v`` log: registers, static
    shared memory, stack frame and spill bytes.  Template instantiations
    ``<nd, float|double, ...>`` are named ``nd<nd>_<f32|f64>``."""
    out, name = {}, None
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ILi(\d+)E([fd])", m.group(1))
            name = f"nd{t.group(1)}_{'f32' if t.group(2) == 'f' else 'f64'}" if t else m.group(1)
            out[name] = {"registers": 0, "smem": 0, "stack": 0, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def phase_build(names=("plane_spmv", "structured_spmv", "probe", "sym_plane_spmv", "ell_spmv",
                       "block_jacobi")):
    """One nvcc per source, all started together; prints each kernel
    function's registers, static shared memory, stack and spills, and fails
    on a spill or a stack frame of the plane SpMVs, the ELL SpMV or the
    block-Jacobi apply."""
    from dune_hdd_tpu_torch.kernels import build

    with ThreadPoolExecutor(len(names)) as pool:
        results = dict(zip(names, pool.map(build.build, names)))
    for name, (lib, seconds, compiler_log) in results.items():
        log("build", kernel=name, library=lib.name, compiled_now=bool(compiler_log),
            nvcc_seconds=f"{seconds:.2f}")
        for fn, info in ptxas_summary(compiler_log).items():
            log("ptxas", kernel=name, function=fn, **info)
            if name in ("plane_spmv", "sym_plane_spmv", "ell_spmv", "block_jacobi") and (
                    info["stack"] or info["spill_stores"] or info["spill_loads"]):
                raise AssertionError(f"{name} {fn}: stack frame or spills {info}")
    if "plane_spmv" in names:
        log_plane_geometry()


def log_plane_geometry():
    """plane_spmv's tile, staged X box, ring and dynamic shared memory per
    instantiation under the ESV plan (the same at every lattice)."""
    from dune_hdd_tpu_torch.kernels import plane_spmv as mod

    if not hasattr(mod, "plane_geometry"):  # --plane-rows in a tree before the tiled kernel
        return
    plan = esv_plan()
    for nd, itemsize in sorted(mod.TILES):
        g = mod.plane_geometry(nd, itemsize, (256, 256), plan)
        blocks = min(2, mod.SMEM_PER_SM // (g.smem_bytes + mod.SMEM_RESERVED))
        log("plane_geometry", case=f"nd{nd}_f{8 * itemsize}", tile=f"{g.TY}x{g.TX}",
            x_box=f"{g.BY}x{g.BX}", stages=g.stages, dynamic_smem=g.smem_bytes,
            blocks_per_sm=blocks, threads=mod.THREADS)


def phase_plane_vs_plain(dev):
    """Returns the 6-bisection bench, its scaled system (S, B) and the max
    abs error of the plane SpMV there (f32 and f64)."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out = {}
    for bisections in (6, 2):
        bench = build_spe10_bench(bisections=bisections, device=dev)
        S, B, _ = bench.assemble(bench.field)
        gen = torch.Generator(device="cpu").manual_seed(bisections)
        X = torch.randn(tuple(B.shape), generator=gen, dtype=torch.float64).to(dev)
        errs = {}
        for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            W, Xd = S.planes.to(dtype), X.to(dtype)
            errs[dtype] = rel_check("plane_spmv vs plain", plane_spmv(W, Xd, S.plan),
                                    plane_spmv_reference(W, Xd, S.plan), rel)
        out[bisections] = (bench, S, B, max(errs.values()))
        log("kernel_vs_plain", kernel="plane_spmv", bisections=bisections, dofs=bench.num_dofs,
            f32_max_abs_err=f"{errs[torch.float32]:.3e}",
            f64_max_abs_err=f"{errs[torch.float64]:.3e}")
    return out[6]


def phase_plane_random(dev):
    """plane_spmv bitwise against its plain version at every nd and dtype on
    random planes whose wrapped blocks are nonzero: lattices smaller than a
    tile ((4, 4), (8, 8)) and ones no tile divides ((20, 100), (12, 44)),
    under the ESV plan and a plan whose shifts reach two rows and columns on
    every side."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    wide = tuple(tuple(((k + 3 * s + 1) % 8, (k % 5) - 2, ((k + s) % 5) - 2) for s in range(3))
                 for k in range(8))
    gen = torch.Generator(device=dev).manual_seed(19)
    cases = 0
    for plan in (esv_plan(), wide):
        for nd in (3, 6, 10):
            for dtype in (torch.float32, torch.float64):
                for lattice in ((4, 4), (8, 8), (20, 100), (12, 44)):
                    W = torch.randn((4, nd, nd, 8) + lattice, generator=gen, device=dev,
                                    dtype=dtype)
                    X = torch.randn((nd, 8) + lattice, generator=gen, device=dev, dtype=dtype)
                    if not torch.equal(plane_spmv(W, X, plan), plane_spmv_reference(W, X, plan)):
                        raise AssertionError(f"plane_spmv differs from its plain version: nd "
                                             f"{nd} {dtype} {lattice} plan {plan}")
                    cases += 1
    log("kernel_vs_plain", kernel="plane_spmv", random_planes_cases=cases, bitwise_equal=True)


def flat(X):
    """[nd, 8, KY, KX] plane-layout vector -> flat cell-major [nc * nd]."""
    return X.reshape(X.shape[0], -1).t().reshape(-1)


def phase_structured_vs_plain(dev, bench, S, B):
    """The structured SpMV against its plain version and against the plane
    SpMV on the 768k-DoF operator, and against its plain version on random
    blocks with random offsets at an nc that is not a multiple of 1024.
    Returns the repacked operator, the flat rhs and the max abs error."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)
    from dune_hdd_tpu_torch.la.block_ell import StructuredBlockEll

    # the planes' cells in subclass-major lattice order are the structured
    # numbering: the flat operator is a view of the planes
    nc = S.num_cells
    A = StructuredBlockEll(None, S.planes.reshape(4, 3, 3, nc).permute(3, 0, 1, 2), bench.offsets)
    gen = torch.Generator(device="cpu").manual_seed(11)
    X = torch.randn(tuple(B.shape), generator=gen).to(dev)
    x = flat(X)
    y = structured_spmv(A.planes, x, A.offsets)
    err = rel_check("structured_spmv vs plain", y,
                    structured_spmv_reference(A.planes, x, A.offsets), 1e-5)
    err_layout = rel_check("structured_spmv vs plane_spmv", y, flat(plane_spmv(S.planes, X, S.plan)),
                           1e-5)
    nr = 8 * 125_003  # 1,000,024 cells: not a multiple of 1024
    rng = np.random.default_rng(12)
    offsets = tuple(tuple(int(o) for o in row)
                    for row in rng.integers(-nr // 2, nr // 2, size=(8, 3)))
    P = torch.as_tensor(rng.standard_normal((4, 3, 3, nr), dtype=np.float32)).to(dev)
    xr = torch.as_tensor(rng.standard_normal(nr * 3, dtype=np.float32)).to(dev)
    err_random = rel_check("structured_spmv vs plain (random)", structured_spmv(P, xr, offsets),
                           structured_spmv_reference(P, xr, offsets), 1e-5)
    log("kernel_vs_plain", kernel="structured_spmv", dofs=x.numel(),
        max_abs_err=f"{err:.3e}", max_abs_diff_vs_plane_spmv=f"{err_layout:.3e}",
        random_nc=nr, random_max_abs_err=f"{err_random:.3e}")
    return A, flat(B), err


def phase_probe_vs_plain(dev):
    """The probe bitwise against 2x + y at [64, 128], 2^24 and 2^24 + 3, and
    on views whose offsets take the float4 path with a scalar head (x[1:]
    with y[1:]) or the scalar path (x[1:] beside y[:-1] or y[3:])."""
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference

    rng = np.random.default_rng(13)
    n = 1 << 24

    def normal(size):
        return torch.as_tensor(rng.standard_normal(size, dtype=np.float32)).to(dev)

    cases = [(repr(shape), normal(shape), normal(shape)) for shape in ((64, 128), n, n + 3)]
    xb, yb = normal(n + 3), normal(n + 3)
    cases += [("x[1:] y[1:]", xb[1:n + 1], yb[1:n + 1]), ("x[1:] y[:-1]", xb[1:n + 1], yb[:n]),
              ("x[1:] y[3:]", xb[1:n + 1], yb[3:n + 3])]
    err = 0.0
    with recording() as rec:
        for label, x, y in cases:
            o, o_ref = probe(x, y), probe_reference(x, y)
            err = max(err, rel_check(f"probe vs 2x + y ({label})", o, o_ref, 0.0))
            if not torch.equal(o, o_ref):
                raise AssertionError(f"probe differs from 2x + y bitwise ({label})")
    scalar = rec.total("kernel.probe.scalar")
    vector = rec.total("kernel.probe") - scalar
    if (vector, scalar) != (4, 2):
        raise AssertionError(f"probe paths: {vector} vector and {scalar} scalar launches, "
                             "expected 4 and 2")
    log("kernel_vs_plain", kernel="probe", cases=repr([c[0] for c in cases]),
        max_abs_err=err, bitwise_equal=True, vector_launches=vector, scalar_launches=scalar)
    return err


def phase_main_path(dev, bisections, repeats):
    """The bench through its entry point, with the plane SpMVs' launch
    counts set to 0 just before and read just after, and the peak device
    memory of the path (set-up included).  From 8 bisections on every
    matvec of the solve is the half-storage kernel's.  Returns the run's
    dict, the scaled system (the symmetric operator where the bench applies
    it) and the launch count."""
    from dune_hdd_tpu_torch.bench_harness import run_spe10_bench

    torch.cuda.reset_peak_memory_stats()
    start_path()
    r = run_spe10_bench(bisections=bisections, repeats=repeats, tol=1e-6, device=dev)
    sym = sym_launches()
    launches = end_path()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not r["residual"] <= 1e-6:
        raise AssertionError(f"residual {r['residual']:.3e} > 1e-6")
    bench = r["bench"]
    S, B, s = bench.assemble(r["field"])
    if bench.settings.symmetric:
        S = S.symmetrized()
    res64 = plane_residual64(S, B, s, r["u"], bench.to_soa)
    if not res64 <= 1.01e-6:
        raise AssertionError(f"float64 recheck: residual {res64:.3e} > 1.01e-6")
    per_solve = r["inner_iterations"] + r["outer_sweeps"]
    if launches < per_solve:
        raise AssertionError(f"{launches} kernel launches < {per_solve} SpMVs of one solve")
    if bench.settings.symmetric and sym < per_solve:
        raise AssertionError(f"{sym} sym_plane_spmv launches < {per_solve} SpMVs of one solve")
    log("main_path", bisections=bisections, dofs=r["num_dofs"], mid_shape=repr(bench.mid_shape),
        symmetric=bench.settings.symmetric, setup_seconds=f"{r['setup_seconds']:.3f}",
        warmup_seconds=f"{r['warmup_seconds']:.3f}", seconds=f"{r['seconds']:.6f}",
        mdof_per_s=f"{r['mdof_per_s']:.4f}", all_seconds=repr([round(t, 6) for t in r["all_times"]]),
        inner_iterations=r["inner_iterations"], outer_sweeps=r["outer_sweeps"],
        residual=f"{r['residual']:.3e}", residual_f64_recheck=f"{res64:.3e}",
        launches=launches, sym_plane_spmv_launches=sym, peak_gb=f"{peak_gb:.3f}",
        card=repr(card()))
    return r, (S, B), launches


def power_lambda(matvec, v, iters=20):
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.norm(w)
    return torch.dot(v.reshape(-1), matvec(v).reshape(-1)).item()


def phase_structured_path(A, S, B):
    """StructuredBlockEll.matvec, the structured SpMV's entry point, in a
    power iteration on the 768k-DoF operator, its launch count set to 0 just
    before and read just after; the same iteration through the plane
    layout must give the same lambda_max."""
    from dune_hdd_tpu_torch.kernels.structured_spmv import structured_spmv

    with recording() as rec:
        lam = power_lambda(A.matvec, flat(B) / torch.linalg.norm(B))
    launches = rec.total("kernel.structured_spmv")
    lam_plane = power_lambda(S.matvec, B / torch.linalg.norm(B))
    if not abs(lam - lam_plane) <= 1e-5 * abs(lam_plane):
        raise AssertionError(f"structured path lambda {lam} != plane path {lam_plane}")
    log("structured_path", dofs=B.numel(), power_iterations=20, lambda_max=f"{lam:.8e}",
        lambda_max_plane=f"{lam_plane:.8e}", launches=launches)
    return launches


def phase_probe_path(dev):
    """The probe through its entry point at the reference script's shape and
    inputs (ones, expecting 3.0), launch count set to 0 just before."""
    from dune_hdd_tpu_torch.kernels.probe import probe

    x = torch.ones((64, 128), device=dev)
    with recording() as rec:
        o = probe(x, x)
    launches = rec.total("kernel.probe")
    if not torch.equal(o, torch.full_like(x, 3.0)):
        raise AssertionError("probe(ones, ones) != 3")
    log("probe_path", shape=(64, 128), value=o[0, 0].item(), launches=launches)
    return launches


def phase_kernel_path_vs_plain_path(dev):
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv_reference

    sols = []
    for spmv in (None, plane_spmv_reference):
        kw = {} if spmv is None else {"spmv": spmv}
        bench = build_spe10_bench(bisections=4, device=dev, **kw)
        sol = bench.fn(bench.field)
        if not sol.residual <= 1e-6:
            raise AssertionError(f"residual {sol.residual:.3e} > 1e-6")
        sols.append(sol)
    diff = ((sols[0].u - sols[1].u).abs().max() / sols[1].u.abs().max()).item()
    if not diff <= 1e-4:
        raise AssertionError(f"kernel and plain paths disagree: {diff:.3e} > 1e-4")
    log("kernel_path_vs_plain_path", bisections=4, rel_max_diff=f"{diff:.3e}",
        residuals=repr([f"{x.residual:.3e}" for x in sols]),
        iterations=repr([x.iterations for x in sols]))


def block_residual64(A, b, s, u):
    """True relative residual of the scaled block-ELL system (A, b) for the
    unscaled solution u, in float64 with the plain gather SpMV."""
    from dune_hdd_tpu_torch.la.block_ell import BlockEllMatrix

    b64 = b.double()
    r = b64 - BlockEllMatrix(A.neighbors, A.blocks.double()).matvec(u / s.double())
    return (r.norm() / b64.norm()).item()


def plane_residual64(S, B, s, u, to_soa):
    """The same for the plane system (S, B): float64, the plain version of
    the SpMV that S applies (the half-storage one where S is symmetric)."""
    from dune_hdd_tpu_torch.kernels.sym_plane_spmv import plain_version

    B64 = B.double()
    X = u[to_soa].reshape(B.shape) / s.double()
    plain = plain_version(S.spmv)
    return ((B64 - plain(S.planes.double(), X, S.plan)).norm() / B64.norm()).item()


def twin_check(what, M, M_plain, r, rel):
    """One preconditioner apply with the kernels against its twin on their
    plain versions, on the same input: bitwise, or within ``rel`` x max."""
    y, y_plain = M(r), M_plain(r)
    bitwise = torch.equal(y, y_plain)
    err = 0.0 if bitwise else rel_check(f"{what} vs its plain-SpMV twin", y, y_plain, rel)
    return bitwise, err, err / y_plain.abs().max().item()


def timed_bench_solve(bench, system):
    """bench.solve(*system) between two synchronizations: (solution, s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = bench.solve(*system)
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0


ALT_BISECTIONS = 6  # 768,000 DoF, the bench's own size


def phase_alt_solvers(dev, u_stencil2, bisections=ALT_BISECTIONS):
    """The bench's other branches at 768k DoF from one block-ELL assembly of
    the bench field: ``deflation`` (three solves, the median; every fine
    matvec the structured SpMV, its launches counted from 0 over the path),
    ``stencil`` (against the stencil2 solution ``u_stencil2``), ``mg`` (its
    float64 assembly, block CG to 1e-5 with the V-cycle) and ``stencil2``
    with the Chebyshev smoother and with the plane multigrid.  Before each
    solve, one preconditioner apply against its twin on the plain SpMVs.
    Gates: true relative residual <= 1e-6, rechecked in float64 with the
    plain SpMV, <= 1.01e-6; mg's CG residual <= 1e-5 within 300 iterations.
    Returns the structured SpMV's launches on the deflation path."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv_reference
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll

    def build(preconditioner, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench = build_spe10_bench(bisections, device=dev, preconditioner=preconditioner, **kw)
        return bench, time.perf_counter() - t0

    def assemble(bench):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system = bench.assemble(bench.field)
        torch.cuda.synchronize()
        return system, time.perf_counter() - t0

    gen = torch.Generator(device="cpu").manual_seed(21)
    bench, setup_s = build("deflation")
    (A, b, s), asm_s = assemble(bench)
    log("alt_assembly", bisections=bisections, dofs=bench.num_dofs, dtype=A.blocks.dtype,
        setup_seconds=f"{setup_s:.3f}", assembly_seconds=f"{asm_s:.3f}", card=repr(card()))

    # (a) deflation on the structured SpMV
    twin = build_spe10_bench(bisections, device=dev, preconditioner="deflation",
                             structured=structured_spmv_reference)
    A_st, M = bench.precondition(A, s)
    r = torch.randn(A.blocks.shape[0] * 3, generator=gen).to(dev)
    bitwise, err, rel = twin_check("structured deflation", M, twin.precondition(A, s)[1], r, 1e-5)
    del A_st, M, twin
    with recording() as rec:
        runs = [timed_bench_solve(bench, (A, b, s)) for _ in range(3)]
    launches = rec.total("kernel.structured_spmv")
    sol = runs[-1][0]
    res64 = block_residual64(A, b, s, sol.u)
    if not (sol.residual <= 1e-6 and res64 <= 1.01e-6):
        raise AssertionError(f"deflation: residual {sol.residual:.3e}, float64 {res64:.3e}")
    per_solve = launches // 3
    if not per_solve >= 3 * sol.iterations:
        raise AssertionError(f"deflation: {launches} structured_spmv launches in 3 solves "
                             f"of {sol.iterations} iterations")
    log("alt_deflation", dofs=bench.num_dofs,
        seconds=f"{statistics.median(t for _, t in runs):.4f}", all_seconds=repr([round(t, 4) for _, t in runs]), iterations=sol.iterations,
        sweeps=sol.sweeps, residual=f"{sol.residual:.3e}", residual_f64_recheck=f"{res64:.3e}",
        structured_spmv_launches=launches, twin_bitwise=bitwise, twin_max_abs_diff=f"{err:.3e}",
        twin_rel=f"{rel:.3e}", card=repr(card()))

    # (b) stencil: the same assembly, permuted into planes
    bench, _ = build("stencil")
    twin = build_spe10_bench(bisections, device=dev, preconditioner="stencil",
                             spmv=plane_spmv_reference)
    S, M = bench.precondition(A, s)
    R = torch.randn((3, 8) + tuple(S.lattice), generator=gen).to(dev)
    bitwise, err, rel = twin_check("stencil deflation", M, twin.precondition(A, s)[1], R, 1e-5)
    del S, M, twin
    start_path()
    sol, seconds = timed_bench_solve(bench, (A, b, s))
    n = end_path()
    res64 = block_residual64(A, b, s, sol.u)
    diff = ((sol.u - u_stencil2).norm() / u_stencil2.norm()).item()
    if not (sol.residual <= 1e-6 and res64 <= 1.01e-6 and n > 0):
        raise AssertionError(f"stencil: residual {sol.residual:.3e}, float64 {res64:.3e}, "
                             f"{n} plane_spmv launches")
    log("alt_stencil", dofs=bench.num_dofs, seconds=f"{seconds:.4f}", iterations=sol.iterations,
        sweeps=sol.sweeps, residual=f"{sol.residual:.3e}", residual_f64_recheck=f"{res64:.3e}",
        rel_diff_vs_stencil2=f"{diff:.3e}", plane_spmv_launches=n, twin_bitwise=bitwise,
        twin_max_abs_diff=f"{err:.3e}", twin_rel=f"{rel:.3e}", card=repr(card()))
    del A, b, s

    # (c) mg: float64 assembly, block CG with the geometric V-cycle
    bench, _ = build("mg", tol=1e-5)
    (A, b, s), asm_s = assemble(bench)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, M = bench.precondition(A, s)
    torch.cuda.synchronize()
    hierarchy_s = time.perf_counter() - t0
    h = M.__self__
    vcycle = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M(b)
        torch.cuda.synchronize()
        vcycle.append(time.perf_counter() - t0)
    del M
    sol, seconds = timed_bench_solve(bench, (A, b, s))
    res64 = block_residual64(A, b, s, sol.u)
    if not (sol.residual <= 1e-5 and sol.iterations < 300):
        raise AssertionError(f"mg: CG residual {sol.residual:.3e} after {sol.iterations}")
    log("alt_mg", dofs=bench.num_dofs, dtype=A.blocks.dtype, assembly_seconds=f"{asm_s:.3f}",
        hierarchy_seconds=f"{hierarchy_s:.3f}", levels=len(h.grids),
        omegas=repr([round(float(w), 6) for w in h.omegas]),
        vcycle_seconds=f"{statistics.median(vcycle):.5f}", seconds=f"{seconds:.4f}",
        iterations=sol.iterations, residual=f"{sol.residual:.3e}",
        residual_f64_true=f"{res64:.3e}", card=repr(card()))
    del A, b, s, h

    # (d) stencil2 with the Chebyshev smoother, and with the plane multigrid
    for options in ({"smoother": "cheb2"}, {"pc2": "mg"}):
        bench, _ = build("stencil2", **options)
        S, B, s = bench.assemble(bench.field)
        _, M = bench.precondition(S, s)
        _, M_plain = bench.precondition(StencilBlockEll(S.planes, S.plan, plane_spmv_reference), s)
        R = torch.randn(tuple(B.shape), generator=gen).to(dev)
        bitwise, err, rel = twin_check(f"stencil2 {options}", M, M_plain, R, 1e-5)
        del M, M_plain
        start_path()
        sol, seconds = timed_bench_solve(bench, (S, B, s))
        n = end_path()
        res64 = plane_residual64(S, B, s, sol.u, bench.to_soa)
        if not (sol.residual <= 1e-6 and res64 <= 1.01e-6 and n > 0):
            raise AssertionError(f"stencil2 {options}: residual {sol.residual:.3e}, float64 "
                                 f"{res64:.3e}, {n} plane_spmv launches")
        log("alt_stencil2", **options, dofs=bench.num_dofs, seconds=f"{seconds:.4f}",
            iterations=sol.iterations, sweeps=sol.sweeps, residual=f"{sol.residual:.3e}",
            residual_f64_recheck=f"{res64:.3e}", plane_spmv_launches=n, twin_bitwise=bitwise,
            twin_max_abs_diff=f"{err:.3e}", twin_rel=f"{rel:.3e}", card=repr(card()))
        del S, B, s
    torch.cuda.empty_cache()
    return launches


FACTORED_MACRO = (200, 40)  # 8,000 aggregates


def phase_factored_bcr(dev, r_default, bisections=8):
    """build_spe10_bench(8, macro=(200, 40)): the two-level preconditioner's
    exact level has 8,000 aggregates, so its coarse solve is the factored
    BCR from the coarse bands (never dense).  Gate: true 1e-6, rechecked in
    float64.  Then the dense route of the multilevel inverse's last level,
    ``_coarse_inverse_bcr_factored`` on the (200, 40) dense E of this
    system (float32, 256 MB), against ``torch.linalg.solve`` in float64."""
    from dune_hdd_tpu_torch.bench_harness import build_spe10_bench
    from dune_hdd_tpu_torch.la import stencil as st

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench = build_spe10_bench(bisections, device=dev, macro=FACTORED_MACRO)
    setup_s = time.perf_counter() - t0
    if bench.mid_shape is not None:
        raise AssertionError(f"macro {FACTORED_MACRO}: a middle level {bench.mid_shape}")
    S, B, s = bench.assemble(bench.field)
    start_path()
    sol, seconds = timed_bench_solve(bench, (S, B, s))
    n = end_path()
    S_sym = S.symmetrized() if bench.settings.symmetric else S
    res64 = plane_residual64(S_sym, B, s, sol.u, bench.to_soa)
    if not (sol.residual <= 1e-6 and res64 <= 1.01e-6 and n > 0):
        raise AssertionError(f"factored BCR bench: residual {sol.residual:.3e}, float64 "
                             f"{res64:.3e}, {n} plane SpMV launches")
    log("factored_bcr_bench", bisections=bisections, dofs=bench.num_dofs,
        macro=repr(FACTORED_MACRO), setup_seconds=f"{setup_s:.3f}", seconds=f"{seconds:.4f}",
        iterations=sol.iterations, sweeps=sol.sweeps, residual=f"{sol.residual:.3e}",
        residual_f64_recheck=f"{res64:.3e}", plane_spmv_and_sym_launches=n,
        default_macro_iterations=r_default["inner_iterations"],
        default_macro_sweeps=r_default["outer_sweeps"],
        default_macro_seconds=f"{r_default['seconds']:.4f}", card=repr(card()))
    del sol
    # the dense route: E of the weighted (200, 40) aggregation
    w = 1.0 / s
    wnbr = S.neighbor_fields(w)
    Pw = torch.stack([(w[:, None] * S.planes[k] * wnbr[k][None, :]).sum(dim=(0, 1))
                      for k in range(4)])
    agg = st._aggregation(S, FACTORED_MACRO)
    E = st._coarse_E_banded(S, agg, Pw)
    del S, B, s, S_sym, wnbr, Pw
    mx, my = FACTORED_MACRO
    rc = torch.randn(mx * my, generator=torch.Generator(device="cpu").manual_seed(22)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve = st._coarse_inverse_bcr_factored(E, mx, my, residual_dtype=torch.float64)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    x = solve(rc)
    E64, rc64 = E.double(), rc.double()
    del E
    x_ref = torch.linalg.solve(E64, rc64)
    res = ((rc64 - E64 @ x.double()).norm() / rc64.norm()).item()
    res_ref = ((rc64 - E64 @ x_ref).norm() / rc64.norm()).item()
    diff = ((x.double() - x_ref).norm() / x_ref.norm()).item()
    if not (math.isfinite(res) and res <= 1e-2 and res_ref <= 1e-8):
        raise AssertionError(f"factored BCR on the dense E: residual {res:.3e}, "
                             f"linalg.solve {res_ref:.3e}")
    log("factored_bcr_dense", n_agg=mx * my, factor_seconds=f"{factor_s:.3f}",
        rel_residual_f64=f"{res:.3e}", linalg_solve_rel_residual=f"{res_ref:.3e}",
        rel_diff_vs_linalg_solve=f"{diff:.3e}", card=repr(card()))
    del E64, x_ref
    torch.cuda.empty_cache()


# -- the sharded layer -------------------------------------------------------

SHARDS = 4                 # virtual shards of the one card
SHARDED_MACRO = (100, 20)  # the reference test's macro: 25 aggregate columns per slab
SHARDED_INNER_ITERS = 600  # the reference's 150 / 6 do not reach 1e-6 at 12.29M
SHARDED_OUTER_MAX = 20
BLOCK_SHARDED_TOL = 1e-8   # the online thermalblock's tolerance
SWEEP_BISECTIONS = 10      # 98,304 DoF
PIPELINE_MUS = 6
PIPELINE_CG_ITERS = 3000


def rel_diff(a, b) -> float:
    """||a - b|| / ||b||, the reference dry run's measure."""
    return ((a - b).norm() / b.norm()).item()


def shard_mesh(dev, mu_axis=1):
    from dune_hdd_tpu_torch.parallel import make_device_mesh

    return make_device_mesh(mu_axis, SHARDS // mu_axis, devices=[dev] * SHARDS)


def phase_sharded_main_path(dev, r, S, B):
    """The 12.29M-DoF main path split into SHARDS x-slabs of one card
    (la/stencil_sharded.py) on the bench's own system (B and the operator
    the bench solves, S's symmetric operator materialized as full planes:
    the assembled planes are another operator, see
    ``phase_sharded_operator_gap``): the
    slab matvec bitwise equal to the single-shard plane_spmv in float32 and
    float64; the slab kernel against its plain version and timed beside
    the BSR call at one slab; the two-level weighted deflation (the bench's
    weight 1/s, macro SHARDED_MACRO) to a true 1e-6, rechecked in float64
    with the plain SpMV, within 5e-3 of the bench's stencil2 solution
    ``r["u"]``.  The slab launch counts are set to 0 just before the solve
    and read just after.  Returns the kernels line's slab rows."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import (
        SLAB_HALO, plane_spmv, plane_spmv_reference, plane_spmv_slab, plane_spmv_slab_reference)
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll, symmetric_planes
    from dune_hdd_tpu_torch.la.stencil_sharded import ShardedStencilSystem

    bench = r["bench"]
    _, _, s = bench.assemble(r["field"])  # the scaling of (S, B): the deflation weight is 1/s
    S = StencilBlockEll(symmetric_planes(S), S.plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system = ShardedStencilSystem(S, B, shard_mesh(dev), macro=SHARDED_MACRO,
                                  weight=(1.0 / s).to(B.dtype))
    setup_s = time.perf_counter() - t0
    X = torch.randn(B.shape, generator=torch.Generator(device="cpu").manual_seed(31)).to(dev)
    rows, errs = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        Ws = [W.to(dtype) for W in system.planes]
        Xd = X.to(dtype)
        y = torch.cat(system._matvec_local(Ws, system._split(Xd)), dim=-1)
        if not torch.equal(y, plane_spmv(S.planes.to(dtype), Xd, S.plan)):
            raise AssertionError(f"{SHARDS}-slab matvec != single-shard plane_spmv ({name})")
        W0, E0 = Ws[0], system._halo_ext(system._split(Xd))[0]
        y0, y0_ref = plane_spmv_slab(W0, E0, S.plan), plane_spmv_slab_reference(W0, E0, S.plan)
        errs[name] = rel_check(f"plane_spmv_slab vs plain ({name})", y0, y0_ref,
                               {torch.float32: 1e-5, torch.float64: 1e-12}[dtype])
        A = bsr_operator(W0, S.plan, halo=SLAB_HALO)
        e_lib = rel_check(f"BSR library call vs plane_spmv_slab ({name})", A @ flat(E0), flat(y0),
                          1e-4 if dtype == torch.float32 else 1e-11)
        rows[name] = timed("plane_spmv_slab", f"12.29M slab 1/{SHARDS} {name}",
                           lambda: plane_spmv_slab(W0, E0, S.plan),
                           lambda: plane_spmv_slab_reference(W0, E0, S.plan), lambda: A @ flat(E0),
                           (W0.numel() + E0.numel() + y0.numel()) * W0.element_size(),
                           2 * W0.numel(), dtype, lattice="x".join(map(str, W0.shape[-2:])),
                           max_abs_err=f"{errs[name]:.3e}",
                           bitwise_equal=torch.equal(y0, y0_ref),
                           library_max_abs_diff=f"{e_lib:.3e}")
        del Ws, Xd, y, W0, E0, y0, y0_ref, A
    torch.cuda.synchronize()
    with recording() as rec:
        t0 = time.perf_counter()
        X_sh, res = system.solve(tol=1e-6, inner_iters=SHARDED_INNER_ITERS,
                                 outer_max=SHARDED_OUTER_MAX)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = Counter()
    for key, n in rec.totals_under("kernel.plane_spmv_slab.").items():
        launches[key.split()[0]] += n
    launches = dict(launches)
    B64 = B.double()
    res64 = ((B64 - plane_spmv_reference(S.planes.double(), X_sh, S.plan)).norm()
             / B64.norm()).item()
    X_ref = r["u"][bench.to_soa].reshape(B.shape) / s.double()
    diff = rel_diff(X_sh, X_ref)
    if not (float(res) <= 1e-6 and res64 <= 1.01e-6 and diff <= 5e-3
            and launches.get("nd3_f32", 0) > 0 and launches.get("nd3_f64", 0) > 0):
        raise AssertionError(f"sharded solve: residual {float(res):.3e}, float64 {res64:.3e}, "
                             f"rel diff vs stencil2 {diff:.3e}, slab launches {launches}")
    log("sharded_main_path", shards=SHARDS, slab_width=system.width,
        macro=repr(SHARDED_MACRO), inner_iters=SHARDED_INNER_ITERS,
        outer_max=SHARDED_OUTER_MAX, setup_seconds=f"{setup_s:.3f}", seconds=f"{seconds:.3f}",
        inner_iterations=system.last_inner_iterations, outer_sweeps=system.last_outer_sweeps,
        residual=f"{float(res):.3e}", residual_f64_recheck=f"{res64:.3e}",
        rel_diff_vs_stencil2=f"{diff:.3e}", stencil2_iterations=r["inner_iterations"],
        stencil2_seconds=f"{r['seconds']:.4f}", slab_launches=repr(launches),
        matvec_bitwise_f32_f64=True, card=repr(card()))
    del system, X_sh
    torch.cuda.empty_cache()
    return {f"plane_spmv_slab_nd3_{k}": (dict(rows[n], launches=launches[f"nd3_{k}"]), errs[n])
            for k, n in (("f32", "float32"), ("f64", "float64"))}


def phase_sharded_operator_gap(dev, r, S, B):
    """The same sharded solve on the assembled planes, against the bench's
    stencil2 solution of the symmetrized operator: how far apart the two
    operators' 1e-6 solutions lie at this contrast (``--sharded`` only)."""
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll
    from dune_hdd_tpu_torch.la.stencil_sharded import ShardedStencilSystem

    bench = r["bench"]
    _, _, s = bench.assemble(r["field"])
    system = ShardedStencilSystem(StencilBlockEll(S.planes, S.plan), B, shard_mesh(dev),
                                  macro=SHARDED_MACRO, weight=(1.0 / s).to(B.dtype))
    X, res = system.solve(tol=1e-6, inner_iters=SHARDED_INNER_ITERS, outer_max=SHARDED_OUTER_MAX)
    X_ref = r["u"][bench.to_soa].reshape(B.shape) / s.double()
    log("sharded_operator_gap", operator="assembled planes", residual=f"{float(res):.3e}",
        inner_iterations=system.last_inner_iterations,
        rel_diff_vs_stencil2_symmetrized=f"{rel_diff(X, X_ref):.3e}", card=repr(card()))


def same_connectivity(native, grid) -> bool:
    """The native faces are the grid's (numbered by first touch, not
    sorted), with the same cells, cell faces and inside orientation."""
    faces, cell_faces, face_cells, face_local = native
    if len(faces) != grid.num_faces:
        return False
    nv = grid.num_vertices

    def keys(f):
        s = np.sort(f, axis=1).astype(np.int64)
        return s[:, 0] * nv + s[:, 1]

    grid_keys = keys(grid.faces)
    order = np.argsort(grid_keys)
    to_grid = order[np.clip(np.searchsorted(grid_keys[order], keys(faces)), 0, len(order) - 1)]
    nvc = grid.cells.shape[1]
    cells = grid.cells[face_cells[:, 0]]
    at = np.arange(len(faces))
    return bool((grid_keys[to_grid] == keys(faces)).all()
                and (to_grid[cell_faces] == grid.cell_faces).all()
                and (np.sort(face_cells, axis=1) == np.sort(grid.face_cells[to_grid], axis=1)).all()
                and (faces[:, 0] == cells[at, face_local[:, 0]]).all()
                and (faces[:, 1] == cells[at, (face_local[:, 0] + 1) % nvc]).all())


def phase_native_connectivity(dev, bisections=10):
    """native.build_connectivity on the bench grid at ``bisections`` (the
    12.29M-DoF grid's 4,096,000 cells) against the port's np.unique
    connectivity, with both host times (and the g++ build's)."""
    from dune_hdd_tpu_torch import native
    from dune_hdd_tpu_torch.bench_harness import _bench_geometry
    from dune_hdd_tpu_torch.grid.structured import _build_connectivity

    grid = _bench_geometry(bisections, dev).grid
    t0 = time.perf_counter()
    native._load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = native.build_connectivity(grid.cells)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build_connectivity(grid.cells, grid.cell_type)
    numpy_s = time.perf_counter() - t0
    if not same_connectivity(out, grid):
        raise AssertionError("native connectivity != the grid's np.unique connectivity")
    log("native_connectivity", cells=grid.num_cells, faces=grid.num_faces,
        gxx_build_seconds=f"{build_s:.2f}", native_seconds=f"{native_s:.3f}",
        numpy_unique_seconds=f"{numpy_s:.3f}", equal=True)


def phase_process_group():
    """initialize_distributed() in an environment that describes no process
    group returns False, and process_info() reports one process."""
    import os

    from dune_hdd_tpu_torch.parallel import initialize_distributed, is_distributed, process_info

    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    try:
        engaged = initialize_distributed()
    finally:
        os.environ.update(saved)
    info = process_info()
    if engaged or is_distributed() or info["process_count"] != 1:
        raise AssertionError(f"process group without an environment: {engaged}, {info}")
    log("process_group", initialized=engaged, **info)


def phase_block_sharded(dev, grid, mus, solutions):
    """The thermalblock 2x2 BlockSWIPDG [2 2] at 1,572,864 DoF on SHARDS
    shards, at the first of ``mus``: the per-shard assembly bitwise equal
    to the host's; the halo layout on the contiguous row split bitwise
    equal to the all-gather solve (as_sharded(halo=False)); the
    subdomain-aligned halo solve and the all-gather solve within 5e-3 of
    the single-device solve ``solutions[0]``; the halo exchange volume
    against the all-gather volume."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.parallel import HaloShardedSystem, halo_exchange_spec
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = BlockSWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                  ThermalblockProblem((2, 2)), num_partitions=(2, 2),
                                  device=dev, only_these_products=())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mesh = shard_mesh(dev)
    t0 = time.perf_counter()
    host = d.as_sharded(mesh, halo=True)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_dev = d.as_sharded(mesh, halo=True, assemble_on_device=True)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(host.ell_vals[0], on_dev.ell_vals[0])):
        raise AssertionError("per-shard assembly != host assembly")
    del host
    rowsplit = d.as_sharded(mesh, halo=False)
    halo_rows = HaloShardedSystem(d.get_operator(), d.get_rhs(), mesh, dtype=d.space.dtype)
    mu, u_ref = d.problem.parse_parameter(mus[0]), solutions[0]
    results, iterations = {}, {}
    for name, system in (("all_gather", rowsplit), ("halo_row_split", halo_rows),
                         ("halo_subdomains", on_dev)):
        torch.cuda.synchronize()
        with recording() as rec:
            t0 = time.perf_counter()
            u = system.solve(mu, tol=BLOCK_SHARDED_TOL, maxiter=50000)
            torch.cuda.synchronize()
            results[name] = (u, time.perf_counter() - t0)
        # one all_gather per SpMV (and one of the solution), or one
        # ppermute per neighbour offset and SpMV
        iterations[name] = (rec.total("collective.all_gather") - 1 if name == "all_gather"
                            else rec.total("collective.ppermute") // len(system.plan.shifts))
    u_ag, u_hr, u_hs = (results[k][0] for k in ("all_gather", "halo_row_split",
                                                 "halo_subdomains"))
    spec = halo_exchange_spec(on_dev)
    gather_volume = (SHARDS - 1) * rowsplit.n_pad // SHARDS
    diffs = {"all_gather": rel_diff(u_ag, u_ref), "halo_subdomains": rel_diff(u_hs, u_ref)}
    if not (torch.equal(u_hr, u_ag) and max(diffs.values()) <= 5e-3
            and spec["elements_per_spmv"] < gather_volume):
        raise AssertionError(f"sharded block solves: row-split halo bitwise "
                             f"{torch.equal(u_hr, u_ag)}, rel diffs {diffs}, {spec}")
    log("block_sharded", dofs=d.space.num_dofs, shards=SHARDS, build_seconds=f"{build_s:.2f}",
        host_values_seconds=f"{host_s:.2f}", device_assembly_seconds=f"{dev_s:.2f}",
        assembly_bitwise=True, halo_row_split_bitwise_all_gather=True,
        **{f"{k}_seconds": f"{v[1]:.3f}" for k, v in results.items()},
        **{f"{k}_iterations": v for k, v in iterations.items()},
        **{f"{k}_rel_diff_vs_single": f"{v:.3e}" for k, v in diffs.items()},
        halo_subdomains_rel_diff_vs_all_gather=f"{rel_diff(u_hs, u_ag):.3e}",
        halo_elements_per_spmv=spec["elements_per_spmv"], all_gather_elements=gather_volume,
        shifts=repr(spec["shifts"]), peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        card=repr(card()))
    del d, on_dev, rowsplit, halo_rows, results
    torch.cuda.empty_cache()


def phase_sharded_sweeps_and_pipeline(dev, mus):
    """The thermalblock 2x2 SWIPDG at SWEEP_BISECTIONS (98,304 DoF): a
    2 x 2 (mu x domain) halo_parameter_sweep and sharded_parameter_sweep
    over the first 4 of ``mus`` against single-device solves (all to 1e-10:
    1e-8 relative); then the 3-stage pipeline over
    PIPELINE_MUS of them with the ESV2007 estimators against
    sequential_parameter_stages (the reference's 1e-5)."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.parallel import (
        HaloShardedSystem, ShardedAffineSystem, make_stage_mesh, pipeline_parameter_stages,
        sharded_parameter_sweep)
    from dune_hdd_tpu_torch.parallel.halo import halo_parameter_sweep
    from dune_hdd_tpu_torch.parallel.pipeline import EstimatorStage, sequential_parameter_stages
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=SWEEP_BISECTIONS)
    d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), device=dev, only_these_products=())
    op, rhs = d.get_operator(), d.get_rhs()
    params = [d.problem.parse_parameter(mu) for mu in mus[:PIPELINE_MUS]]
    th_op = torch.stack([op.with_expanded_affine_part().thetas(m) for m in params])
    th_rhs = torch.stack([rhs.with_expanded_affine_part().thetas(m) for m in params])
    opts = {"type": "block_cg.jacobi", "precision": 1e-10, "max_iter": 50000}
    refs = [d.solve(mu, options=opts) for mu in mus[:4]]
    mesh = shard_mesh(dev, mu_axis=2)
    sweeps = {}
    for name, system_cls, sweep in (("halo", HaloShardedSystem, halo_parameter_sweep),
                                    ("all_gather", ShardedAffineSystem, sharded_parameter_sweep)):
        system = system_cls(op, rhs, mesh, dtype=d.space.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U = sweep(system, th_op[:4], th_rhs[:4], tol=1e-10, maxiter=50000)
        torch.cuda.synchronize()
        diff = max(rel_diff(U[i, : d.space.num_dofs], refs[i]) for i in range(4))
        sweeps[name] = (time.perf_counter() - t0, diff)
        if not diff <= 1e-8:
            raise AssertionError(f"{name} parameter sweep: rel diff {diff:.3e} vs single")
    log("sharded_sweeps", dofs=d.space.num_dofs, mesh="2 mu x 2 domain", mus=4,
        **{f"{k}_seconds": f"{v[0]:.3f}" for k, v in sweeps.items()},
        **{f"{k}_max_rel_diff_vs_single": f"{v[1]:.3e}" for k, v in sweeps.items()},
        card=repr(card()))

    est = EstimatorStage(d.space, d.boundary_info, d.problem, params)
    out = {}
    for name, run in (("pipeline", lambda: pipeline_parameter_stages(
            op, rhs, th_op, th_rhs, mesh=make_stage_mesh([dev] * 3), cg_iters=PIPELINE_CG_ITERS,
            dtype=d.space.dtype, estimator=est)),
                      ("sequential", lambda: sequential_parameter_stages(
            op, rhs, th_op, th_rhs, cg_iters=PIPELINE_CG_ITERS, dtype=d.space.dtype,
            estimator=est))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, e = run()
        torch.cuda.synchronize()
        out[name] = (u, e, time.perf_counter() - t0)
    (u_pp, e_pp, s_pp), (u_seq, e_seq, s_seq) = out["pipeline"], out["sequential"]
    u_diff = max(rel_diff(u_pp[i], u_seq[i]) for i in range(PIPELINE_MUS))
    e_diff = rel_diff(e_pp.reshape(-1), e_seq.reshape(-1))
    if not (u_diff <= 1e-5 and e_diff <= 1e-5 and bool((e_pp[:, 0] <= 1e-8).all())
            and bool((e_pp[:, 2:] > 0).all())):
        raise AssertionError(f"pipeline vs sequential: {u_diff:.3e}, estimates {e_diff:.3e}, "
                             f"relative residuals {e_pp[:, 0].tolist()}")
    log("pipeline", stages=3, mus=PIPELINE_MUS, dofs=d.space.num_dofs, cg_iters=PIPELINE_CG_ITERS,
        estimators=repr(est.types), pipeline_seconds=f"{s_pp:.3f}",
        sequential_seconds=f"{s_seq:.3f}", max_rel_diff_u=f"{u_diff:.3e}",
        rel_diff_estimates=f"{e_diff:.3e}",
        max_relative_residual=f"{e_pp[:, 0].max().item():.3e}",
        estimates=repr([[round(v, 6) for v in row] for row in e_pp[:, 2:].tolist()]),
        card=repr(card()))


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA's data sheet)
# peak rates outside the tensor cores (NVIDIA's data sheet, H100 SXM at 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound(nbytes, flops, dtype):
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bsr_operator(planes, plan, halo=0):
    """The plane operator as a torch.sparse BSR tensor with 3x3 blocks over
    the flat cell-major vector in (subclass, iy, ix) order, which is also the
    structured numbering: the library yardstick of the SpMV kernels (timed
    here, used nowhere in the port).  ``halo``: the slab mode's, whose
    columns are those of X_ext [.., KY, KX + 2 halo], with no x-wrap."""
    _, nd, _, _, KY, KX = planes.shape
    We, dev = KX + 2 * halo, planes.device
    nc = 8 * KY * KX
    iy = torch.arange(KY, device=dev)[:, None]
    ix = torch.arange(KX, device=dev)[None, :]

    def col(ks, dy, dx):
        x = ix + dx + halo if halo else (ix + dx) % KX
        return ks * KY * We + ((iy + dy) % KY) * We + x

    cols = [torch.stack([col(k, 0, 0) for k in range(8)])]
    for s in range(3):
        cols.append(torch.stack([col(*plan[k][s]) for k in range(8)]))
    cols, order = torch.sort(torch.stack(cols, dim=-1).reshape(nc, 4), dim=1)
    if not bool((cols[:, 1:] != cols[:, :-1]).all()):
        raise AssertionError("two slots of one cell share a neighbour")
    vals = planes.permute(3, 4, 5, 0, 1, 2).reshape(nc, 4, nd, nd)
    vals = torch.gather(vals, 1, order[:, :, None, None].expand(-1, -1, nd, nd))
    crow = torch.arange(0, 4 * nc + 1, 4, device=dev)
    return torch.sparse_bsr_tensor(crow, cols.reshape(-1), vals.reshape(-1, nd, nd).contiguous(),
                                   size=(nc * nd, 8 * KY * We * nd), check_invariants=False)


def time_calls(fn, calls=100):
    """Device time of one call (ms): the median of ``calls`` chained calls,
    each between two CUDA events.  A device-side sleep queued first keeps
    the card busy while the host enqueues all calls, so the host's launch
    latency does not land between the events."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    torch.cuda._sleep(int(3 * calls * host_s * 2e9))  # cycles, >= 3x the enqueue time
    for a, b in zip(starts, ends):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def timed(kernel, label, fn, plain_fn, library_fn, nbytes, flops, dtype, **fields):
    """Times a kernel, its plain version and the one library call that
    computes the same function; logs µs and GB/s under the bytes model and
    the bound; returns the timing fields of the kernels line."""
    ms, plain_ms, library_ms = time_calls(fn), time_calls(plain_fn), time_calls(library_fn)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log("timing", kernel=kernel, case=label, kernel_us=f"{ms * 1e3:.2f}",
        kernel_gbps=f"{nbytes / ms / 1e6:.1f}", plain_us=f"{plain_ms * 1e3:.2f}",
        library_us=f"{library_ms * 1e3:.2f}", bound_us=f"{bound_ms * 1e3:.2f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / ms:.3f}", bytes=nbytes, flops=flops,
        **fields, card=repr(card()))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_plane_spmv(S, B, label, W=None, dtypes=(torch.float32, torch.float64)):
    """Checks the plane SpMV against its plain version on these planes (the
    max abs error within the tolerance, and whether the two are bitwise
    equal) and times both, and the BSR library call, in each of ``dtypes``.
    Returns ({dtype name: timing fields}, the max abs error over them);
    bytes = planes + 2 vectors, operations = one multiply-add per plane
    entry."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    out, err = {}, 0.0
    for dtype in dtypes:
        rel = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
        Wd, X = (S.planes if W is None else W).to(dtype), B.to(dtype)
        name = str(dtype).replace("torch.", "")
        y, y_ref = plane_spmv(Wd, X, S.plan), plane_spmv_reference(Wd, X, S.plan)
        e = rel_check(f"plane_spmv vs plain ({label} {name})", y, y_ref, rel)
        bitwise = torch.equal(y, y_ref)
        err = max(err, e)
        A, x = bsr_operator(Wd, S.plan), flat(X)
        e_lib = rel_check(f"BSR library call vs plane_spmv ({label} {name})", A @ x, flat(y),
                          10 * rel)
        out[name] = timed("plane_spmv", f"{label} {name}", lambda: plane_spmv(Wd, X, S.plan),
                          lambda: plane_spmv_reference(Wd, X, S.plan), lambda: A @ x,
                          (Wd.numel() + 2 * X.numel()) * Wd.element_size(), 2 * Wd.numel(),
                          dtype, dofs=X.numel(), lattice="x".join(map(str, S.lattice)),
                          max_abs_err=f"{e:.3e}", bitwise_equal=bitwise,
                          library_max_abs_diff=f"{e_lib:.3e}")
        del Wd, X, A, x, y, y_ref
    return out, err


# plane_spmv's rows: (case, nd, lattice) of the driven paths' operators
PLANE_ROWS = (("12.29M bench", 3, (320, 1600)), ("level 6 ESV / thermalblock", 3, (256, 256)),
              ("768k bench", 3, (80, 400)), ("P2 level 6", 6, (256, 256)),
              ("P3 level 5", 10, (128, 128)), ("level 4 ESV", 3, (64, 64)),
              ("P3 level 4", 10, (64, 64)))


def esv_plan():
    """The stencil plan of the ALU-conforming (4, 4) macro grid: that of every
    structured operator the driven paths build (the bench's too)."""
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order
    from dune_hdd_tpu_torch.la.stencil import stencil_plan

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2)
    return stencil_plan(structured_cell_order(grid, (0, 0), (1, 1)))


def plane_rows(dev, library=False):
    """plane_spmv at each row of PLANE_ROWS, f32 and f64, on random planes
    (seeded on the card; wrapped blocks nonzero) with the ESV plan: bitwise
    against its plain version, device time against the bytes bound, the
    host's time per call (200 calls enqueued back to back); with
    ``library`` also the plain version's and the BSR call's times.  The
    kernel's time does not depend on the planes' values, so these rows time
    the same work as the assembled operators of the same lattice."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    plan = esv_plan()
    gen = torch.Generator(device=dev)
    for label, nd, (KY, KX) in PLANE_ROWS:
        for dtype in (torch.float32, torch.float64):
            gen.manual_seed(nd * KY * KX)
            W = torch.randn((4, nd, nd, 8, KY, KX), generator=gen, device=dev, dtype=dtype)
            X = torch.randn((nd, 8, KY, KX), generator=gen, device=dev, dtype=dtype)
            y = plane_spmv(W, X, plan)
            bitwise = torch.equal(y, plane_spmv_reference(W, X, plan))
            nbytes = (W.numel() + 2 * X.numel()) * W.element_size()
            ms = time_calls(lambda: plane_spmv(W, X, plan))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):  # the host's side of a call: enqueued, not waited for
                plane_spmv(W, X, plan)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            bound_ms, bound_by = bound(nbytes, 2 * W.numel(), dtype)
            fields = {}
            if library:
                A, x = bsr_operator(W, plan), flat(X)
                plain_ms = time_calls(lambda: plane_spmv_reference(W, X, plan))
                fields = dict(plain_us=f"{plain_ms * 1e3:.2f}",
                              library_us=f"{time_calls(lambda: A @ x) * 1e3:.2f}")
                del A, x
            name = str(dtype).replace("torch.", "")
            log("plane_row", case=label, nd=nd, lattice=f"{KY}x{KX}", dtype=name,
                kernel_us=f"{ms * 1e3:.2f}", bound_us=f"{bound_ms * 1e3:.2f}", bound_by=bound_by,
                share=f"{bound_ms / ms:.3f}", bitwise_equal=bitwise,
                host_us_per_call=f"{host_us:.2f}", **fields, card=repr(card()))
            if not bitwise:
                raise AssertionError(f"plane_spmv differs from its plain version ({label} {name})")
            del W, X, y
            torch.cuda.empty_cache()


def phase_timing_768k(dev, S, B, A, b_flat):
    from dune_hdd_tpu_torch.kernels.probe import probe, probe_reference
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)

    _, plane_err = time_plane_spmv(S, B, "768k")
    lib = bsr_operator(S.planes, S.plan)  # the same operator: planes in structured order
    y = structured_spmv(A.planes, b_flat, A.offsets)
    e_lib = rel_check("BSR library call vs structured_spmv", lib @ b_flat, y, 1e-4)
    st = timed("structured_spmv", "768k f32", lambda: structured_spmv(A.planes, b_flat, A.offsets),
               lambda: structured_spmv_reference(A.planes, b_flat, A.offsets), lambda: lib @ b_flat,
               (A.planes.numel() + 2 * b_flat.numel()) * 4, 2 * A.planes.numel(), torch.float32,
               dofs=b_flat.numel(), library_max_abs_diff=f"{e_lib:.3e}")
    del lib, y
    pr = {}
    gen = torch.Generator(device="cpu").manual_seed(16)
    for shape in ((64, 128), 1 << 24):
        # two distinct inputs: the bytes model reads both
        x, y = (torch.rand(shape, generator=gen).to(dev) for _ in range(2))
        pr[shape] = timed("probe", repr(shape), lambda: probe(x, y), lambda: probe_reference(x, y),
                          lambda: torch.add(y, x, alpha=2), 3 * x.numel() * 4, 2 * x.numel(),
                          torch.float32)
    # the scalar path: x and y at different offsets modulo 16 bytes
    xs, ys = (torch.rand((1 << 24) + 1, generator=gen).to(dev) for _ in range(2))
    x, y = xs[1:], ys[:-1]
    timed("probe", "2^24 scalar path (x[1:], y[:-1])", lambda: probe(x, y),
          lambda: probe_reference(x, y), lambda: torch.add(y, x, alpha=2), 3 * x.numel() * 4,
          2 * x.numel(), torch.float32)
    # the kernels line: the 2^24 times, the [64, 128] ones beside them
    probe_row = dict(pr[1 << 24], **{f"{k}_64x128": v for k, v in pr[(64, 128)].items()
                                      if k != "bound_by"})
    return st, probe_row, plane_err


def time_sym_plane_spmv(S, B, label):
    """The half-storage kernel on the symmetric operator S: bitwise its plain
    version, within 1e-6 / 1e-14 x max (f32 / f64) of plane_spmv on the
    materialized symmetric planes (the same operator summed in another
    order), and timed beside its plain version, the BSR library call of the
    full symmetric operator and plane_spmv on those planes, in f32 and f64.
    Returns ({dtype name: timing fields}, the max abs error against the plain
    version); bytes = the exact half-storage read + 2 vectors, operations =
    one multiply-add per value of the full operator."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.kernels.sym_plane_spmv import (
        sym_plane_bytes, sym_plane_spmv, sym_plane_spmv_reference)
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll, symmetric_planes

    out, err = {}, 0.0
    for dtype, rel in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
        name = str(dtype).replace("torch.", "")
        W, X = S.planes.to(dtype), B.to(dtype)
        y, y_plain = sym_plane_spmv(W, X, S.plan), sym_plane_spmv_reference(W, X, S.plan)
        err = max(err, rel_check(f"sym_plane_spmv vs plain ({label} {name})", y, y_plain, 0.0))
        if not torch.equal(y, y_plain):
            raise AssertionError(f"sym_plane_spmv differs from its plain version ({label} {name})")
        Wsym = symmetric_planes(StencilBlockEll(W, S.plan))
        e_full = rel_check(f"sym_plane_spmv vs plane_spmv on symmetric planes ({label} {name})",
                           y, plane_spmv(Wsym, X, S.plan), rel)
        A, x = bsr_operator(Wsym, S.plan), flat(X)
        e_lib = rel_check(f"BSR library call vs sym_plane_spmv ({label} {name})", A @ x, flat(y),
                          1e-4 if dtype == torch.float32 else 1e-11)
        full_ms = time_calls(lambda: plane_spmv(Wsym, X, S.plan))
        out[name] = dict(timed(
            "sym_plane_spmv", f"{label} {name}", lambda: sym_plane_spmv(W, X, S.plan),
            lambda: sym_plane_spmv_reference(W, X, S.plan), lambda: A @ x,
            sym_plane_bytes(S.nd, S.lattice, W.element_size()), 2 * W.numel(), dtype,
            dofs=X.numel(), lattice="x".join(map(str, S.lattice)), bitwise_equal=True,
            max_abs_diff_vs_plane_spmv_on_symmetric_planes=f"{e_full:.3e}",
            plane_spmv_on_symmetric_planes_us=f"{full_ms * 1e3:.2f}",
            library_max_abs_diff=f"{e_lib:.3e}"), plane_spmv_symmetric_planes_ms=full_ms)
        del W, X, y, y_plain, Wsym, A, x
    torch.cuda.empty_cache()
    return out, err


def phase_sym_random(dev):
    """sym_plane_spmv bitwise against its plain version at every nd and
    dtype on random planes (every value nonzero, the wrapped ones too) under
    the bench's plan, on lattices smaller than the plan's shifts, smaller
    than a block row and not a multiple of one."""
    from dune_hdd_tpu_torch.kernels.sym_plane_spmv import sym_plane_spmv, sym_plane_spmv_reference

    plan = esv_plan()
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = 0
    for nd in (3, 6, 10):
        for dtype in (torch.float32, torch.float64):
            for lattice in ((2, 3), (4, 4), (20, 100), (12, 44)):
                W = torch.randn((4, nd, nd, 8) + lattice, generator=gen, device=dev, dtype=dtype)
                X = torch.randn((nd, 8) + lattice, generator=gen, device=dev, dtype=dtype)
                if not torch.equal(sym_plane_spmv(W, X, plan),
                                   sym_plane_spmv_reference(W, X, plan)):
                    raise AssertionError(f"sym_plane_spmv differs from its plain version: nd {nd} "
                                         f"{dtype} {lattice}")
                cases += 1
    log("kernel_vs_plain", kernel="sym_plane_spmv", random_planes_cases=cases, bitwise_equal=True)


def phase_symmetric_checks(S, B):
    """The half-storage kernel on the symmetric 3.07M-DoF operator
    (``time_sym_plane_spmv``), and the symmetric operator against the
    assembled one.  Returns the max abs error of the kernel against its
    plain version."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv

    _, err = time_sym_plane_spmv(S, B, "3.07M")
    gen = torch.Generator(device="cpu").manual_seed(14)
    X = torch.randn((3, 8) + tuple(S.lattice), generator=gen).to(S.planes.device)
    y, y_assembled = S.matvec(X), plane_spmv(S.planes, X, S.plan)
    diff = rel_check("symmetric vs assembled operator", y, y_assembled, 1e-5)
    log("symmetric_operator", dofs=X.numel(), kernel_vs_plain_max_abs_err=f"{err:.3e}",
        sym_vs_assembled_max_abs_diff=f"{diff:.3e}",
        rel=f"{diff / y_assembled.abs().max().item():.3e}")
    return err


ROOFLINE_BISECTIONS = 8


def phase_roofline(dev):
    """bench_harness.stencil2_roofline at 3.07M DoF (the bench's cached
    set-up of the main path before it): copy, half-storage matvec and
    assembly GB/s under the reference's byte models."""
    from dune_hdd_tpu_torch.bench_harness import stencil2_roofline

    r = stencil2_roofline(bisections=ROOFLINE_BISECTIONS, device=dev)
    if not all(math.isfinite(v) and v > 0 for v in r.values()):
        raise AssertionError(f"stencil2_roofline: {r}")
    log("roofline", bisections=ROOFLINE_BISECTIONS, **r, card=repr(card()))
    return r


def phase_bench_entry():
    """``python -m dune_hdd_tpu_torch.bench`` at 768k DoF as a user runs it,
    in a process of its own: its last line parses, with a true 1e-6."""
    cmd = [sys.executable, "-m", "dune_hdd_tpu_torch.bench", "--bisections", "6", "--repeats",
           "3", "--provenance", "off"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (out["residual"] <= 1e-6 and out["platform"] == "gpu" and "roofline" in out):
        raise AssertionError(f"bench entry: {out}")
    log("bench_entry", command=repr(" ".join(cmd[1:])), line=json.dumps(out), card=repr(card()))


def phase_rb_demo(dev):
    """``examples/thermalblock_rb_demo`` at its defaults on the card, in a
    temporary working directory: both greedy bases, finite test errors, the
    saved model loads back."""
    import tempfile
    from contextlib import chdir

    from dune_hdd_tpu_torch.examples import thermalblock_rb_demo
    from dune_hdd_tpu_torch.mor import load_reduced_model

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, chdir(tmp):
        out = thermalblock_rb_demo.main(["--device", "cuda"])
        loaded = load_reduced_model(out["path"], device=dev)
        if not torch.equal(loaded.basis, out["rb"].reduced_model.basis):
            raise AssertionError("the demo's saved model does not load back")
    errors = {k: max(v) for k, v in out["errors"].items()}
    if not all(math.isfinite(e) for e in errors.values()):
        raise AssertionError(f"rb demo: test errors {errors}")
    log("rb_demo", rb_basis=out["rb"].basis.shape[0], lrbms_basis=out["lrbms"].basis.shape[0],
        max_test_errors=repr({k: f"{v:.3e}" for k, v in errors.items()}),
        seconds=f"{time.perf_counter() - t0:.2f}", card=repr(card()))


def check_plane_spmv_at(system, what):
    """plane_spmv against its plain version on a discretization's scaled
    float64 plane operator (the shapes its stencil_cg path gives it)."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv, plane_spmv_reference

    S = system.S
    gen = torch.Generator(device="cpu").manual_seed(15)
    X = torch.randn(tuple(system.B.shape), generator=gen, dtype=torch.float64).to(S.planes.device)
    return rel_check(f"plane_spmv vs plain ({what})", plane_spmv(S.planes, X, S.plan),
                     plane_spmv_reference(S.planes, X, S.plan), 1e-12)


ESV_LEVELS = 6  # 384 to 1,572,864 DoF
ESV_ESTIMATORS = ("eta_NC_ESV2007", "eta_R_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007",
                  "eta_ESV2007", "eta_ESV2007_alt")


def rt0_conservation(d, u, mu=None, **reconstruction):
    """max_T |div t_h - P0 f| / |P0 f| of the RT0 reconstruction of u's
    SWIPDG flux (``reconstruction``: the keywords that make it the assembled
    scheme's flux), and the reconstruction's seconds."""
    from dune_hdd_tpu_torch.estimators import rt0_divergence, rt0_flux_reconstruction
    from dune_hdd_tpu_torch.functions.base import freeze_function
    from dune_hdd_tpu_torch.ops.assembly import cell_quadrature

    grid, problem = d.space.grid, (d.problem.with_mu(mu) if mu is not None else d.problem)
    lam, kap, force, g_d, g_n = (freeze_function(getattr(problem, name)) for name in (
        "diffusion_factor", "diffusion_tensor", "force", "dirichlet", "neumann"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flux = rt0_flux_reconstruction(d.space, u, lam, kap,
                                   np.nonzero(d.boundary_info.dirichlet_faces)[0],
                                   np.nonzero(d.boundary_info.neumann_faces)[0], g_d, g_n,
                                   **reconstruction)
    div = rt0_divergence(grid, flux)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    qp, qw = cell_quadrature(grid, 6, u.device)
    p0f = torch.sum(qw * force(qp), dim=1) / d.space.tensor(grid.cell_volumes)
    return ((div - p0f).abs() / p0f.abs()).max().item(), seconds


def phase_esv2007_study(dev):
    """The ESV2007 ALU-conforming SWIPDG EOC study through EocStudy with the
    stencil_cg option (plane_spmv in float64) and the six ESV2007
    estimators, levels 0-6; levels 0-3 against the published table (errors,
    estimators, efficiency), EOC above 1.9 (L2) and 0.95 (H1_semi, eta_NC,
    eta_DF, eta_ESV2007) up to the last level; RT0 local conservation at
    level 6.  The launch count is set to 0 just before and read just after.
    Returns (launches, the kernel's max abs error at level 6, the test case,
    the solutions per level)."""
    from types import SimpleNamespace

    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators import SWIPDGEstimators
    from dune_hdd_tpu_torch.studies import (
        EocStudy, check_eoc_study_for_success, expected_results)
    from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    estimator_seconds = {}

    def estimate_fn(disc, u, type_, level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eta = SWIPDGEstimators.estimate(disc.space, disc.boundary_info, disc.problem, u, type_)
        torch.cuda.synchronize()
        estimator_seconds.setdefault(level, {})[type_] = time.perf_counter() - t0
        return eta

    max_iter = 50000
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": max_iter, "macro": (4, 4)}
    reset_timings()
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    tc = ESV2007TestCase(num_refinements=ESV_LEVELS)
    hierarchy_s = time.perf_counter() - t0
    study = EocStudy(tc, SWIPDGDiscretization, estimator_types=ESV_ESTIMATORS,
                     estimate_fn=estimate_fn, solver_options=options, device=dev)
    results = study.run(verbose=False)
    launches = end_path()
    host = timings()
    log("esv2007_study", levels=f"0-{ESV_LEVELS}", hierarchy_host_seconds=f"{hierarchy_s:.2f}",
        reference_level_cells=tc.reference_grid.num_cells,
        pattern_host_seconds=repr([round(t, 3) for t in host.get("swipdg.pattern", [])]),
        block_ell_map_host_seconds=repr(
            [round(t, 3) for t in host.get("block_ell_from_sparse.slot_map", [])]),
        launches=launches, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    for r, info in enumerate(study.level_info):
        log("esv2007_level", level=r, dofs=info["num_dofs"],
            **{k: f"{results[k][r]:.6e}" for k in results},
            iterations=info["iterations"], time_to_solution=f"{study.time_to_solution[r]:.3f}",
            assembly_seconds=f"{info['assembly_seconds']:.3f}",
            solve_seconds=f"{info['solve_seconds']:.3f}",
            estimator_seconds=f"{sum(estimator_seconds[r].values()):.3f}",
            estimator_seconds_by_type=repr({k: round(v, 4)
                                            for k, v in estimator_seconds[r].items()}))
        if not (info["type"] == "stencil_cg" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"level {r}: {info}")
    check_eoc_study_for_success(SimpleNamespace(results={k: v[:4] for k, v in results.items()}),
                                "ESV2007", "alu_conforming", 1)
    eff = [e / h for e, h in zip(results["eta_ESV2007"][:4], results["H1_semi"])]
    eff_expected = expected_results("ESV2007", "alu_conforming", 1, "eff_ESV2007")
    if not np.allclose(eff, eff_expected, rtol=1e-2, atol=0):
        raise AssertionError(f"eff_ESV2007 {eff} != {eff_expected} (rel 1e-2)")
    eocs = {k: study.eoc(k) for k in ("L2", "H1_semi", "eta_NC_ESV2007", "eta_DF_ESV2007",
                                      "eta_ESV2007")}
    if not (min(eocs["L2"][3:]) > 1.9
            and all(min(v[3:]) > 0.95 for k, v in eocs.items() if k != "L2")):
        raise AssertionError(f"EOC {eocs}")
    if launches <= 0:
        raise AssertionError("the study did not launch plane_spmv")
    d, u = study.discretizations[-1], study.solutions[-1]
    conservation, rt0_seconds = rt0_conservation(d, u)
    if not conservation <= 1e-5:
        raise AssertionError(f"level {ESV_LEVELS}: div t_h != P0 f ({conservation:.3e})")
    err = check_plane_spmv_at(d.stencil_system(), f"ESV2007 level {ESV_LEVELS}")
    log("esv2007_eoc", table_levels="0-3 ok (errors, estimators)",
        eff_ESV2007=repr([round(e, 4) for e in eff]),
        **{f"eoc_{k}": repr([round(e, 4) for e in v]) for k, v in eocs.items()},
        rt0_conservation_max_rel_dev=f"{conservation:.3e}",
        rt0_reconstruction_seconds=f"{rt0_seconds:.3f}",
        plane_spmv_f64_max_abs_err=f"{err:.3e}", card=repr(card()))
    return launches, err, tc, list(study.solutions)


def phase_esv2007_cg(dev, tc):
    """The CG-P1 EOC study on the same ESV2007 hierarchy, levels 0-6 (up to
    263k vertex DoF), Jacobi CG to 1e-12: EOC above 1.85 (L2) and 0.95
    (H1_semi) from level 2 on."""
    from dune_hdd_tpu_torch.discretizations import CGDiscretization
    from dune_hdd_tpu_torch.studies import EocStudy

    max_iter = 100000
    options = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": max_iter}
    torch.cuda.reset_peak_memory_stats()
    study = EocStudy(tc, CGDiscretization, solver_options=options, device=dev)
    results = study.run(verbose=False)
    for r, info in enumerate(study.level_info):
        log("esv2007_cg_level", level=r, dofs=info["num_dofs"],
            **{k: f"{results[k][r]:.6e}" for k in results},
            iterations=info["iterations"], time_to_solution=f"{study.time_to_solution[r]:.3f}",
            assembly_seconds=f"{info['assembly_seconds']:.3f}",
            solve_seconds=f"{info['solve_seconds']:.3f}")
        if not (info["type"] == "cg.jacobi" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"level {r}: {info}")
    eoc_l2, eoc_h1 = study.eoc("L2"), study.eoc("H1_semi")
    if not (min(eoc_l2[2:]) >= 1.85 and min(eoc_h1[2:]) >= 0.95):
        raise AssertionError(f"CG EOC L2 {eoc_l2}, H1_semi {eoc_h1}")
    log("esv2007_cg_eoc", gated_from_level=2, eoc_L2=repr([round(e, 4) for e in eoc_l2]),
        eoc_H1_semi=repr([round(e, 4) for e in eoc_h1]),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))


BLOCK_PARTITIONS = ((1, 1), (2, 2), (4, 4), (8, 8))
BLOCK_TABLE_LEVELS = 4  # levels 0-3 against the published block table
BLOCK_TYPES = ("eta_NC_OS2014", "eta_R_OS2014", "eta_DF_OS2014", "eta_DF_OS2014_*", "eta_OS2014")


def partitioning(part) -> str:
    return f"[{part[0]} {part[1]} 1]"


def phase_block_esv2007_table(dev, tc, solutions):
    """BlockSWIPDG on the ESV2007 hierarchy (``tc``'s levels): the
    partitionings [1 1 1], [2 2 1], [4 4 1] and [8 8 1] at levels 0-3, and
    the OS2014 estimators and eff_OS2014 held to the published block table
    (6e-3).  The block solve is the global SWIPDG solve, which the
    partitioning does not enter: ``solutions`` are the ESV2007 study's
    (stencil_cg, plane_spmv in float64, the 4x4 macro, 1e-12: the options a
    block solve takes), one per level, and every partitioning reuses them.
    Then [8 8 1] at levels 4 to the last, with EOC(eta_OS2014) >= 0.95
    from level 3 on and eff_OS2014 within 1e-2 of 1.80.  Returns (0, the
    kernel's max abs error on the last level's operator): the solves, and
    their launches, are the study's."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.ops.norms import error_norms
    from dune_hdd_tpu_torch.studies import eoc_rates, expected_results

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    def build(level, part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = BlockSWIPDGDiscretization(tc.level_grid(level), tc.boundary_info(), tc.problem,
                                      num_partitions=part, device=dev)
        torch.cuda.synchronize()
        return d, solutions[level], {"assembly_seconds": time.perf_counter() - t0}

    def estimates(d, u):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals = {t: BlockSWIPDGEstimators.estimate(d, u, t) for t in BLOCK_TYPES}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        vals["eff_OS2014"] = vals["eta_OS2014"] / error_norms(d.space, u,
                                                              tc.exact_solution)["H1_semi"]
        return vals, seconds

    def log_level(part, level, d, vals, seconds, info):
        log("block_esv2007_level", partitioning=repr(partitioning(part)), level=level,
            dofs=d.space.num_dofs, subdomains=d.num_subdomains(),
            **{k: f"{v:.6e}" for k, v in vals.items()}, solution="esv2007_study",
            assembly_seconds=f"{info['assembly_seconds']:.3f}", estimator_seconds=f"{seconds:.3f}")

    table = {}
    for level in range(BLOCK_TABLE_LEVELS):
        for part in BLOCK_PARTITIONS:
            d, u, info = build(level, part)
            vals, seconds = estimates(d, u)
            table[part, level] = vals
            log_level(part, level, d, vals, seconds, info)
    for part in BLOCK_PARTITIONS:
        for t in BLOCK_TYPES + ("eff_OS2014",):
            got = [table[part, level][t] for level in range(BLOCK_TABLE_LEVELS)]
            want = expected_results(f"ESV2007Multiscale.{partitioning(part)}", "alu_conforming",
                                    1, t)
            if not np.allclose(got, want, rtol=6e-3, atol=0):
                raise AssertionError(f"{partitioning(part)} {t}: {got} != {want} (rel 6e-3)")

    deep = (8, 8)
    for level in range(BLOCK_TABLE_LEVELS, tc.num_refinements + 1):
        d, u, info = build(level, deep)
        vals, seconds = estimates(d, u)
        table[deep, level] = vals
        log_level(deep, level, d, vals, seconds, info)
        del u
    levels = range(BLOCK_TABLE_LEVELS - 1, tc.num_refinements + 1)
    eoc = eoc_rates([table[deep, level]["eta_OS2014"] for level in levels])
    eff = [table[deep, level]["eff_OS2014"] for level in levels]
    if not (min(eoc) >= 0.95 and max(abs(e - 1.80) for e in eff) <= 1e-2):
        raise AssertionError(f"[8 8 1]: EOC(eta_OS2014) {eoc}, eff_OS2014 {eff}")
    err = check_plane_spmv_at(d._global.stencil_system(), f"block ESV2007 level {level} [8 8 1]")
    log("block_esv2007_table", table_levels=f"0-{BLOCK_TABLE_LEVELS - 1} ok (6e-3)",
        partitionings=repr([partitioning(p) for p in BLOCK_PARTITIONS]),
        deep=f"[8 8 1] levels {BLOCK_TABLE_LEVELS}-{tc.num_refinements}",
        eoc_eta_OS2014=repr([round(e, 4) for e in eoc]),
        eff_OS2014=repr([round(e, 4) for e in eff]), solves="esv2007_study",
        plane_spmv_f64_max_abs_err=f"{err:.3e}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        seconds=f"{time.perf_counter() - t_phase:.2f}", card=repr(card()))
    return 0, err


OS2014_TRIPLES = ((0.1, 0.1, 0.1), (1.0, 1.0, 0.1), (0.1, 0.1, 1.0), (1.0, 1.0, 1.0))
# the published parametric block table at mu = 1, levels 0-1
# (test/linearelliptic-block-swipdg-expectations_os2014_2daluconform.cxx)
OS2014_PUBLISHED = {
    (1.0, 1.0, 0.1): {"eta_DF_OS2014": [1.36, 1.33], "eta_DF_OS2014_*": [0.413, 0.205],
                      "eta_OS2014": [4.71, 4.42], "eta_OS2014_*": [0.550, 0.271]},
    (1.0, 1.0, 1.0): {"eta_DF_OS2014": [0.355, 0.176], "eta_DF_OS2014_*": [0.355, 0.176],
                      "eta_OS2014": [0.774, 0.382], "eta_OS2014_*": [0.774, 0.382]},
}


def triple_key(triple) -> str:
    mu, bar, hat = (f"{v:g}" for v in triple)
    return f"mu{mu}_bar{bar}_hat{hat}"


def phase_os2014_parametric(dev, levels=2):
    """The OS2014 parametric [4 4 1] block study at levels 0-1 at the four
    (mu, mu_bar, mu_hat) triples, one direct solve per level and distinct
    mu: every recorded estimator within 2e-3 of the JAX-recorded values
    (studies/expectations.py) and, at mu = 1, within 3.5e-3 of the
    published ones."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.studies import expected_results
    from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase

    t_phase = time.perf_counter()
    types = ("eta_DF_OS2014", "eta_DF_OS2014_*", "eta_OS2014", "eta_OS2014_*")
    discs, solutions = {}, {}
    for triple in OS2014_TRIPLES:
        mu, bar, hat = triple
        tc = OS2014MultiscaleTestCase({"mu": mu, "mu_bar": bar, "mu_hat": hat,
                                       "mu_minimizing": 0.1}, num_partitions=(4, 4),
                                      num_refinements=levels - 1)
        pars = tc.estimator_parameters()
        values = {t: [] for t in types}
        for level in range(levels):
            if level not in discs:
                discs[level] = BlockSWIPDGDiscretization(
                    tc.level_grid(level), tc.boundary_info(), tc.problem, num_partitions=(4, 4),
                    device=dev)
            d = discs[level]
            if (level, mu) not in solutions:
                solutions[level, mu] = d.solve(tc.parameters["mu"], options={"type": "direct"})
            for t in types:
                values[t].append(BlockSWIPDGEstimators.estimate(d, solutions[level, mu], t, pars))
        key = f"OS2014.block.[4 4 1].{triple_key(triple)}"
        for t, got in values.items():
            want = expected_results(key, "alu_conforming", 1, t)
            if want is not None and not np.allclose(got, want, rtol=2e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != recorded {want} (rel 2e-3)")
            published = OS2014_PUBLISHED.get(triple, {}).get(t)
            if published is not None and not np.allclose(got, published, rtol=3.5e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != published {published} (rel 3.5e-3)")
        log("os2014_parametric", triple=repr(triple), scheme=discs[0]._scheme,
            dofs=repr([discs[r].space.num_dofs for r in range(levels)]),
            **{t: repr([round(v, 6) for v in vals]) for t, vals in values.items()})
    log("os2014_parametric_done", triples=len(OS2014_TRIPLES), solves=len(solutions),
        seconds=f"{time.perf_counter() - t_phase:.2f}", card=repr(card()))


def phase_spe10_parametric_block(dev, num_refinements=1):
    """The SPE10 parametric [20 4 1] block study at reference scale
    (tests/test_spe10_study.py): the 100 x 20 macro grid at levels 0-1
    against the level-2 reference solution (384,000 DoF), solver direct,
    through EocStudy once per distinct mu (0.1 and 1); the other two
    triples evaluate their estimators on the same solutions.  energy,
    eta_OS2014 and eta_OS2014_* within 2e-3 of the recorded values
    (studies/expectations.py); eta_OS2014 == eta_OS2014_* at mu_hat = mu;
    otherwise the plain estimate stagnates and the star one converges."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.estimators.block_swipdg import BlockSWIPDGEstimators
    from dune_hdd_tpu_torch.studies import EocStudy, expected_results
    from dune_hdd_tpu_torch.testcases.spe10 import Spe10ParametricBlockModel1TestCase

    t_phase = time.perf_counter()
    types = ("eta_OS2014", "eta_OS2014_*")
    part = (20, 4)
    studies = {}

    def factory(grid, bi, problem, device):
        return BlockSWIPDGDiscretization(grid, bi, problem, num_partitions=part, device=device)

    for triple in sorted(OS2014_TRIPLES, key=lambda t: t[0] != t[2]):  # mu_hat = mu first
        mu, bar, hat = triple
        tc = Spe10ParametricBlockModel1TestCase(
            {"mu": mu, "mu_bar": bar, "mu_hat": hat, "mu_minimizing": 0.1},
            num_partitions=part, num_refinements=num_refinements)
        pars = tc.estimator_parameters()
        t0 = time.perf_counter()
        solved_now = mu not in studies
        if solved_now:
            study = EocStudy(tc, factory, norms=("energy",), estimator_types=types,
                             estimate_fn=lambda d, u, t, level: BlockSWIPDGEstimators.estimate(
                                 d, u, t, pars),
                             mu=tc.parameters["mu"], energy_mu=tc.parameters["mu"],
                             solver_options={"type": "direct"}, device=dev)
            res = study.run(verbose=False)
            studies[mu] = study
        else:
            study = studies[mu]
            res = {"energy": study.results["energy"],
                   **{t: [BlockSWIPDGEstimators.estimate(d, u, t, pars)
                          for d, u in zip(study.discretizations, study.solutions)]
                      for t in types}}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        key = f"Spe10.parametric_block.{partitioning(part)}.{triple_key(triple)}"
        for t, got in res.items():
            want = expected_results(key, "alu_conforming", 1,
                                    "energy_mu" if t == "energy" else t)
            if not np.allclose(got, want, rtol=2e-3, atol=0):
                raise AssertionError(f"{key} {t}: {got} != recorded {want} (rel 2e-3)")
        if hat == mu:
            if not np.allclose(res["eta_OS2014"], res["eta_OS2014_*"], rtol=1e-6, atol=0):
                raise AssertionError(f"{key}: eta_OS2014 != eta_OS2014_* at mu_hat = mu")
        elif not (res["eta_OS2014"][1] / res["eta_OS2014"][0] > 0.8
                  and np.log2(res["eta_OS2014_*"][0] / res["eta_OS2014_*"][1]) > 0.9):
            raise AssertionError(f"{key}: the plain estimate does not stagnate or the star "
                                 f"one does not converge: {res}")
        info = study.level_info
        log("spe10_parametric_block", triple=repr(triple), scheme=study.discretizations[0]._scheme,
            dofs=repr([i["num_dofs"] for i in info]),
            reference_dofs=tc.reference_grid.num_cells * 3,
            **{t: repr([round(v, 6) for v in vals]) for t, vals in res.items()},
            solved_now=solved_now,
            level_solve_seconds=repr([round(i["solve_seconds"], 3) for i in info]),
            seconds=f"{seconds:.2f}")
    log("spe10_parametric_block_done", solves=len(studies),
        seconds=f"{time.perf_counter() - t_phase:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))


def phase_block_provenance(dev, bisections=6, larger=8):
    """block_provenance_check: the bench's stencil operator and rhs (f32,
    applied through plane_spmv) against the BlockSWIPDG [20 4 1] global
    system assembled from its 80 local operators and pairwise couplings
    (f64) at ``bisections`` (768,000 DoF) and at ``larger`` bisections
    (3,072,000 DoF), rel_op and rel_rhs <= 1e-4.  The launch count is set
    to 0 just before and read just after each check.  Returns the
    launches."""
    from dune_hdd_tpu_torch.bench_harness import block_provenance_check
    from dune_hdd_tpu_torch.utils.logging import reset_timings, timings

    launches = 0
    for b in (bisections, larger):
        reset_timings()
        torch.cuda.reset_peak_memory_stats()
        start_path()
        t0 = time.perf_counter()
        r = block_provenance_check(bisections=b, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = end_path()
        if n < 3:
            raise AssertionError(f"provenance at {b} bisections: {n} plane_spmv launches < 3")
        launches += n
        host = timings()
        log("block_provenance", **{k: v for k, v in r.items() if k not in ("rel_op", "rel_rhs")},
            rel_op=f"{r['rel_op']:.3e}", rel_rhs=f"{r['rel_rhs']:.3e}",
            locals_seconds=f"{sum(host['block.locals']):.2f}",
            couplings_seconds=f"{sum(host['block.couplings']):.2f}", seconds=f"{seconds:.2f}",
            launches=n, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
            card=repr(card()))
        torch.cuda.empty_cache()
    return launches


def phase_thermalblock_online(dev, seed=17, count=8, bisections=14):
    """SWIPDG with the 2x2 thermalblock at 14 bisections (1,572,864 DoF, all
    Dirichlet) through make_solve_fn at ``count`` values of mu drawn from
    [0.1, 1]^4, each rechecked on the unscaled float64 system with the plain
    SparseMatrix.matvec; one mu also through stencil_cg.  The launch count
    is set to 0 just before and read just after.  Returns (launches, the
    kernel's max abs error on this operator, (the grid, the mu [count, 4],
    the solutions), the kernel's f64 timing fields on this (256, 256)
    operator)."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=bisections)
    t1 = time.perf_counter()
    d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    solve_fn, thetas = d.make_solve_fn(tol=1e-8, maxiter=50000, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log("thermalblock_setup", dofs=d.space.num_dofs, scheme=d.scheme,
        grid_host_seconds=f"{t1 - t0:.2f}", assembly_seconds=f"{t2 - t1:.2f}",
        block_ell_stack_seconds=f"{t3 - t2:.2f}")
    mus = np.random.default_rng(seed).uniform(0.1, 1.0, (count, 4))
    solutions = []
    for i, mu in enumerate(mus):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, res, iters = solve_fn(*thetas(mu))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        A, b = d.freeze_operator(mu), d.freeze_rhs(mu)
        recheck = (torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b)).item()
        del A, b
        log("thermalblock_solve", i=i, mu=repr([round(float(m), 6) for m in mu]),
            iterations=iters, seconds=f"{seconds:.3f}", recurrence_residual=f"{float(res):.3e}",
            residual_f64_recheck=f"{recheck:.3e}")
        if not (recheck <= 1e-7 and iters < 50000 and bool(torch.isfinite(u).all())):
            raise AssertionError(f"mu {mu}: residual {recheck:.3e}, {iters} iterations")
        solutions.append(u)
    first = solutions[0]
    t0 = time.perf_counter()
    u_st = d.solve(mus[0], options={"type": "stencil_cg", "precision": 1e-8, "max_iter": 50000})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = end_path()
    info = d.last_solve_info
    diff = ((u_st - first).abs().max() / first.abs().max()).item()
    if not (info["type"] == "stencil_cg" and diff <= 1e-5 and launches > 0):
        raise AssertionError(f"stencil_cg: {info}, rel diff {diff:.3e}, {launches} launches")
    peak = torch.cuda.max_memory_allocated() / 1e9
    system = d.stencil_system(mus[0])
    err = check_plane_spmv_at(system, "thermalblock 14 bisections")
    row, _ = time_plane_spmv(system.S, system.B, "thermalblock 14 bisections",
                             dtypes=(torch.float64,))
    del system
    time_general_spmvs(d, mus[0], first)
    log("thermalblock_stencil_cg", iterations=info["iterations"], seconds=f"{seconds:.3f}",
        rel_max_diff_vs_block_cg=f"{diff:.3e}", launches=launches, peak_gb=f"{peak:.2f}",
        plane_spmv_f64_max_abs_err=f"{err:.3e}", card=repr(card()))
    phase_thermalblock_estimators(d, mus[0], first)
    return launches, err, (grid, mus, solutions), row["float64"]


def phase_thermalblock_estimators(d, mu, u):
    """RT0 local conservation and eta_ESV2007 (mu_hat = 1) on the 1.57M-DoF
    thermalblock at mu.  The 2x2 thermalblock has no affine part, so the
    discretization runs the penalty_mu scheme: its assembled flux is the
    frozen diffusion's with the scheme's fixed weights (``weight_diffusion``),
    and that reconstruction must be conservative; the per-component
    reconstruction="scheme" (the reference scheme's flux) is logged beside
    it, not gated."""
    from dune_hdd_tpu_torch.estimators import SWIPDGEstimators, scheme_flux_parts

    if d.scheme != "penalty_mu":
        raise AssertionError(f"thermalblock scheme {d.scheme}, expected penalty_mu")
    wlam, wkap = d._weight_diffusion
    conservation, rt0_seconds = rt0_conservation(d, u, mu, weight_lam_fn=wlam, weight_kap_fn=wkap)
    if not conservation <= 1e-5:
        raise AssertionError(f"thermalblock: div t_h != P0 f ({conservation:.3e})")
    other, _ = rt0_conservation(d, u, mu, flux_parts=scheme_flux_parts(d.problem, mu))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eta = SWIPDGEstimators.estimate(d.space, d.boundary_info, d.problem, u, "eta_ESV2007", mu=mu,
                                    mu_hat=np.ones(4), weight_diffusion=d._weight_diffusion)
    seconds = time.perf_counter() - t0
    if not (np.isfinite(eta) and eta > 0):
        raise AssertionError(f"thermalblock eta_ESV2007 = {eta}")
    log("thermalblock_estimators", dofs=d.space.num_dofs, mu=repr([round(float(m), 6) for m in mu]),
        rt0_conservation_max_rel_dev=f"{conservation:.3e}",
        rt0_reconstruction_seconds=f"{rt0_seconds:.3f}",
        per_component_reconstruction_max_rel_dev=f"{other:.3e}",
        eta_ESV2007_mu_hat_1=f"{eta:.6e}", eta_ESV2007_seconds=f"{seconds:.3f}",
        card=repr(card()))


RB_TRAINING = 64      # random training parameters from [0.1, 1]^4
RB_EXTENSIONS = 10
LRBMS_EXTENSIONS = 4
RB_ONLINE_MUS = 1024  # the batched online sweep
# the largest relative h1_semi error of each reduced model at the 8 test mu:
# the reference's generalization bar (tests/test_mor.py:79) made relative for
# the RB model (8.98e-3 on the card); 4 LRBMS extensions reach 1.349e-1 there
# (PERF.md §6), so its bar is that measurement with a 1.5x margin
RB_REL_H1_BAR = 1e-2
LRBMS_REL_H1_BAR = 2e-1


def rel_norm(e, u, matrix) -> float:
    """sqrt(e A e) / sqrt(u A u)."""
    return float(torch.sqrt(e @ matrix.matvec(e)) / torch.sqrt(u @ matrix.matvec(u)))


def block_supported(d, basis) -> bool:
    """Every basis row is nonzero on one subdomain's DoFs only."""
    sub = torch.as_tensor(np.asarray(d.ms_grid.subdomain_of, dtype=np.int64)).to(basis.device)
    sub = sub.repeat_interleave(d.space.shape_count)
    nz = basis != 0
    big, small = torch.iinfo(torch.int64).max, -1
    lo = torch.where(nz, sub[None, :], big).min(dim=1).values
    hi = torch.where(nz, sub[None, :], small).max(dim=1).values
    return bool((nz.any(dim=1) & (lo == hi)).all())


def phase_rb_thermalblock(dev, grid, mus, solutions, seed=6):
    """The reference's RB workflow (perform_standard_rb / perform_lrbms /
    test_quality) on the 2x2 thermalblock BlockSWIPDG [2 2] at 1,572,864
    DoF, on ``thermalblock_online``'s grid: greedy_rb (Riesz h1_semi
    estimator with min-theta coercivity, gram_schmidt, RB_EXTENSIONS) and
    greedy_lrbms (Riesz, LRBMS_EXTENSIONS) over RB_TRAINING random mu, every
    snapshot by stencil_cg on plane_spmv; both models against the detailed
    solutions at ``mus`` (relative h1_semi and mu-energy errors); one
    selected snapshot reproduced to 1e-6; the batched online sweep over
    RB_ONLINE_MUS mu timed beside single solves and held to the loop at
    1e-10 on 16 of them; save/load bitwise.  The launch count is set to 0
    just before and read just after.  Returns the launches."""
    import tempfile

    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.mor import (
        greedy_lrbms, greedy_rb, load_reduced_model, sample_randomly, save_reduced_model)
    from dune_hdd_tpu_torch.mor.batch import (
        batched_estimates, batched_reduced_solve, stack_parameters)
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    d = BlockSWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                                  ThermalblockProblem((2, 2)), num_partitions=(2, 2), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    infos = []
    uncached = d.uncached_solve

    def recording_solve(mu, options=None):
        u = uncached(mu, options)
        infos.append(dict(d.last_solve_info))
        return u

    d.uncached_solve = recording_solve
    training = sample_randomly(d.parameter_type, 0.1, 1.0, RB_TRAINING, seed=seed)
    opts = {"type": "stencil_cg", "precision": 1e-8, "max_iter": 50000}
    start_path()
    path = _PATH[-1][1]
    results, seconds = {}, {}
    for name, fn, kw in (
            ("rb", greedy_rb, dict(max_extensions=RB_EXTENSIONS, extension_algorithm="gram_schmidt",
                                   coercivity="min_theta")),
            ("lrbms", greedy_lrbms, dict(max_extensions=LRBMS_EXTENSIONS))):
        t0 = time.perf_counter()
        first = len(path.spans)
        res = fn(d, training, use_estimator="riesz", error_norm="h1_semi", solver_options=opts,
                 **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        results[name] = res
        split: dict = {}
        for sp in path.spans[first:]:
            if sp.name.startswith("mor."):
                split[sp.name[4:]] = split.get(sp.name[4:], 0.0) + sp.host_s
        log("rb_greedy", model=name, dofs=d.space.num_dofs, training=len(training),
            extensions=res.extensions, basis_size=res.basis.shape[0],
            selected=repr([next(i for i, m in enumerate(training) if m is mu)
                           for mu in res.selected_mus]),
            max_errors=repr([float(f"{e:.6e}") for e in res.max_errors]),
            seconds=f"{seconds[name]:.2f}",
            **{f"{k}_seconds": f"{v:.2f}" for k, v in split.items()},
            riesz_row_cache_hits=res.estimator.cache_hits,
            riesz_row_cache_misses=res.estimator.cache_misses,
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    launches = end_path()
    d.uncached_solve = uncached
    rb, lrbms = results["rb"], results["lrbms"]
    if not (rb.extensions == RB_EXTENSIONS and lrbms.extensions == LRBMS_EXTENSIONS):
        raise AssertionError(f"extensions {rb.extensions}, {lrbms.extensions}")
    if not (infos and all(i["type"] == "stencil_cg" and i["iterations"] < 50000 for i in infos)
            and launches > 0):
        raise AssertionError(f"snapshot solves {infos}, {launches} plane_spmv launches")
    if not block_supported(d, lrbms.basis):
        raise AssertionError("an LRBMS basis row spans two subdomains")

    # quality at thermalblock_online's mu against its detailed solutions
    h1 = d.product_matrix("h1_semi")
    errors = {name: {"h1_semi": [], "energy": []} for name in results}
    for mu, u in zip(mus, solutions):
        mp = d.problem.parse_parameter(mu)
        A = d.freeze_operator(mp)
        for name, res in results.items():
            rm = res.reduced_model
            e = u - rm.reconstruct(rm.solve(mp))
            errors[name]["h1_semi"].append(rel_norm(e, u, h1))
            errors[name]["energy"].append(rel_norm(e, u, A))
        del A
    mu0 = rb.selected_mus[0]
    snapshot = d.solve(mu0, options=opts)  # cached
    u_rb = rb.reduced_model.reconstruct(rb.reduced_model.solve(mu0))
    reproduction = rel_norm(snapshot - u_rb, snapshot, h1)
    for name in results:
        log("rb_quality", model=name, test_mu=len(mus),
            rel_h1_semi=repr([float(f"{e:.4e}") for e in errors[name]["h1_semi"]]),
            rel_energy=repr([float(f"{e:.4e}") for e in errors[name]["energy"]]),
            max_rel_h1_semi=f"{max(errors[name]['h1_semi']):.4e}")
    log("rb_snapshot_reproduction", rel_h1_semi=f"{reproduction:.3e}")
    if not (max(errors["rb"]["h1_semi"]) <= RB_REL_H1_BAR
            and max(errors["lrbms"]["h1_semi"]) <= LRBMS_REL_H1_BAR and reproduction <= 1e-6):
        raise AssertionError(f"RB quality: {errors}, reproduction {reproduction:.3e}")

    # the online payoff: batched sweep against single solves
    rm = rb.reduced_model
    online = rb.estimator.offline(rb.basis)  # every row cached
    sweep = [{"diffusion_factor": m}
             for m in np.random.default_rng(seed + 1).uniform(0.1, 1.0, (RB_ONLINE_MUS, 4))]
    stacked = stack_parameters(d.problem, sweep)
    t0 = time.perf_counter()
    # alpha_LB per mu, evaluated once per parameter set as greedy_rb does
    coercivities = np.asarray([float(online.coercivity(d.problem.parse_parameter(mu)))
                               for mu in sweep])
    coercivity_s = time.perf_counter() - t0

    def timed_call(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    C, solve_s = timed_call(lambda: batched_reduced_solve(rm, stacked))
    etas, estimate_s = timed_call(lambda: batched_estimates(online, rm, stacked, coercivities))
    _, single_s = timed_call(lambda: [rm.solve(mu) for mu in sweep[:16]])
    loop_C = torch.stack([rm.solve(mu) for mu in sweep[:16]])
    loop_eta = np.asarray([online.estimate(mu, rm.solve(mu)) for mu in sweep[:16]])
    rel_C = ((C[:16] - loop_C).abs().max() / loop_C.abs().max()).item()
    rel_eta = float(np.abs(etas[:16] - loop_eta).max() / np.abs(loop_eta).max())
    log("rb_online", mus=RB_ONLINE_MUS, basis_size=rm.dim,
        batched_solve_seconds=f"{solve_s:.4f}",
        batched_solve_us_per_mu=f"{solve_s / RB_ONLINE_MUS * 1e6:.2f}",
        batched_estimate_seconds=f"{estimate_s:.4f}",
        batched_estimate_us_per_mu=f"{estimate_s / RB_ONLINE_MUS * 1e6:.2f}",
        single_solve_us_per_mu=f"{single_s / 16 * 1e6:.2f}",
        coercivity_us_per_mu=f"{coercivity_s / RB_ONLINE_MUS * 1e6:.2f}",
        rel_diff_batched_vs_loop_solve=f"{rel_C:.3e}",
        rel_diff_batched_vs_loop_estimate=f"{rel_eta:.3e}", card=repr(card()))
    if not (rel_C <= 1e-10 and rel_eta <= 1e-10 and np.isfinite(etas).all()):
        raise AssertionError(f"batched vs loop: solve {rel_C:.3e}, estimate {rel_eta:.3e}")

    with tempfile.TemporaryDirectory() as tmp:
        path = save_reduced_model(rm, f"{tmp}/rb_thermalblock")
        back = load_reduced_model(path, device=dev)
    if not all(torch.equal(back.solve(mu), rm.solve(mu)) for mu in sweep[:4]):
        raise AssertionError("the reloaded reduced model solves differently")
    log("rb_thermalblock_done", build_seconds=f"{build_s:.2f}",
        rb_seconds=f"{seconds['rb']:.2f}", lrbms_seconds=f"{seconds['lrbms']:.2f}",
        snapshot_solves=len(infos), snapshot_iterations=repr([i["iterations"] for i in infos]),
        launches=launches, save_load="bitwise",
        seconds=f"{time.perf_counter() - t_phase:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    return launches


def phase_adaptive_spe10(dev):
    """The recorded adaptive LRBMS trajectory: SPE10 parametric [20 4 1] at
    level 0 (24,000 DoF) with 2 oversampling layers, snapshot bases at
    mu = 1, Doerfler(0.85) enrichment at mu = 0.1, two enrichments, direct
    solves; true_h1_semi, eta_OS2014_* and rb_bound_energy (the energy-
    product Riesz bound at mu_bar with min-theta coercivity) within 5% of
    the recorded values (studies/expectations.py), the rb bound falling, the
    first Doerfler set meeting the channel subdomains 46-55."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.mor import adaptive_lrbms, snapshot_local_bases
    from dune_hdd_tpu_torch.studies import expected_results
    from dune_hdd_tpu_torch.testcases.spe10 import Spe10ParametricBlockModel1TestCase

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mu = {"mu": 0.1, "mu_bar": 0.1, "mu_hat": 0.1, "mu_minimizing": 0.1}
    tc = Spe10ParametricBlockModel1TestCase(mu, num_partitions=(20, 4), num_refinements=0,
                                            oversampling_layers=2)
    d = BlockSWIPDGDiscretization(tc.level_grid(0), tc.boundary_info(), tc.problem,
                                  num_partitions=(20, 4), oversampling_layers=2, device=dev)
    init = snapshot_local_bases(d, 1.0)
    res = adaptive_lrbms(d, 0.1, tc.estimator_parameters(), initial_local_bases=init,
                         max_enrichments=2, target_estimate=1e-6, marking=("doerfler", 0.85),
                         track_true_errors=True, solver_options={"type": "direct"})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    key = "Spe10.adaptive.[20 4 1].mu0.1"
    got = {"true_h1_semi": res.true_errors, "eta_OS2014_*": res.estimates,
           "rb_bound_energy": res.rb_bounds}
    log("adaptive_spe10", dofs=d.space.num_dofs, subdomains=d.num_subdomains(),
        **{k: repr([round(float(v), 6) for v in vals]) for k, vals in got.items()},
        enriched=repr([len(s) for s in res.enriched_subdomains]),
        first_set=repr(sorted(res.enriched_subdomains[0])), seconds=f"{seconds:.2f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    for k, vals in got.items():
        want = expected_results(key, "alu_conforming", 1, k)
        if not np.allclose(vals, want, rtol=0.05, atol=0):
            raise AssertionError(f"{key} {k}: {vals} != recorded {want} (rel 5e-2)")
    if not (np.all(np.diff(res.rb_bounds) < 0)
            and set(res.enriched_subdomains[0]) & set(range(46, 56))):
        raise AssertionError(f"{key}: rb bounds {res.rb_bounds}, "
                             f"first set {res.enriched_subdomains[0]}")


def phase_adaptive_os2014(dev):
    """The reference test's adaptive enrichment: OS2014 multiscale [2 2] at
    level 0 with 3 oversampling layers, six worst-subdomain enrichments at
    mu = 0.3: the true error below 0.25x and the estimate below 0.5x their
    first values, the rb bound falling to below 0.15x, and at least 0.3x
    the true error throughout."""
    from dune_hdd_tpu_torch.discretizations import BlockSWIPDGDiscretization
    from dune_hdd_tpu_torch.mor import adaptive_lrbms
    from dune_hdd_tpu_torch.testcases.os2014 import OS2014MultiscaleTestCase

    t0 = time.perf_counter()
    tc = OS2014MultiscaleTestCase({"mu": 0.3, "mu_bar": 0.3, "mu_hat": 0.1,
                                   "mu_minimizing": 0.1},
                                  num_partitions=(2, 2), num_refinements=0, oversampling_layers=3)
    d = BlockSWIPDGDiscretization(tc.level_grid(0), tc.boundary_info(), tc.problem,
                                  num_partitions=(2, 2), oversampling_layers=3, device=dev)
    res = adaptive_lrbms(d, tc.parameters["mu"], tc.estimator_parameters(), max_enrichments=6,
                         target_estimate=1e-6, track_true_errors=True)
    torch.cuda.synchronize()
    true, est, rb = (np.asarray(v) for v in (res.true_errors, res.estimates, res.rb_bounds))
    log("adaptive_os2014", dofs=d.space.num_dofs, layers=3,
        true_h1_semi=repr([round(float(v), 6) for v in true]),
        eta_OS2014_star=repr([round(float(v), 6) for v in est]),
        rb_bound_energy=repr([round(float(v), 6) for v in rb]),
        enriched=repr(res.enriched_subdomains), seconds=f"{time.perf_counter() - t0:.2f}",
        card=repr(card()))
    if not (true[-1] < 0.25 * true[0] and est[-1] < 0.5 * est[0]
            and len(res.enriched_subdomains) == 6 and set(res.enriched_subdomains) <= set(range(4))
            and rb.shape == (7,) and np.all(np.diff(rb) < 0) and rb[-1] < 0.15 * rb[0]
            and np.all(rb >= 0.3 * true)):
        raise AssertionError(f"adaptive OS2014: true {true}, estimates {est}, rb {rb}, "
                             f"enriched {res.enriched_subdomains}")


# -- orders 2-3, quads, intervals and gmres ----------------------------------

HIGHER_LEVELS = {2: 6, 3: 5}  # P2 to 3,145,728 DoF, P3 to 1,310,720 DoF
P2_ESTIMATORS = ("eta_NC_ESV2007", "eta_R_ESV2007_*", "eta_DF_ESV2007", "eta_ESV2007")
CUBE_LEVELS = {1: 6, 2: 5}  # Q1 to 1,048,576 DoF, Q2 to 589,824 DoF
CUBE_VALUE_RTOL = 5e-3
CG_HIGHER_LEVELS = 5  # CG P2 / P3 / Q2 to 263,169 / 591,361 / 263,169 DoF
GMRES_LEVEL = 3  # 24,576 SWIPDG DoF


def truncated(tc, num_refinements):
    """The test case with its study stopped at ``num_refinements``; the
    hierarchy (and every table cached on its grids) is shared."""
    out = copy.copy(tc)
    out.num_refinements = num_refinements
    return out


def rates(study, keys):
    return {k: study.eoc(k) for k in keys}


def log_levels(tag, study, results, estimator_seconds=None):
    for r, info in enumerate(study.level_info):
        fields = dict(level=r, dofs=info["num_dofs"],
                      **{k: f"{results[k][r]:.6e}" for k in results},
                      solver=info["type"], iterations=info["iterations"],
                      time_to_solution=f"{study.time_to_solution[r]:.3f}",
                      assembly_seconds=f"{info['assembly_seconds']:.3f}",
                      solve_seconds=f"{info['solve_seconds']:.3f}")
        if estimator_seconds is not None:
            fields["estimator_seconds"] = f"{sum(estimator_seconds[r].values()):.3f}"
        log(tag, **fields)


def timed_estimates(types):
    """(estimate_fn for EocStudy that times each type, seconds by level)."""
    from dune_hdd_tpu_torch.estimators import SWIPDGEstimators

    seconds = {}

    def estimate_fn(disc, u, type_, level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eta = SWIPDGEstimators.estimate(disc.space, disc.boundary_info, disc.problem, u, type_)
        torch.cuda.synchronize()
        seconds.setdefault(level, {})[type_] = time.perf_counter() - t0
        return eta

    return estimate_fn, seconds


def rt1_projection_defect(d, u):
    """How far div t_h is from Pi_P1 f for the RT1 reconstruction t_h of u's
    SWIPDG flux: (mean defect, centred defect, seconds).  The mean defect is
    max_T |int_T (f - div t_h)| / int_T (|f| + |div t_h|): the scheme's local
    conservation, exact for the exact discrete solution and otherwise the
    solve's algebraic residual, as for RT0.  The centred defect is the same
    with the weights x - c_T and y - c_T (and |x - c_T|, |y - c_T| in the
    scale): the RT1 construction's interior moments, exact up to rounding
    whatever u is.  Also the reconstruction's seconds."""
    from dune_hdd_tpu_torch.estimators import rt1_divergence_at, rt1_flux_reconstruction
    from dune_hdd_tpu_torch.functions.base import freeze_function
    from dune_hdd_tpu_torch.ops.assembly import cell_quadrature

    lam, kap, force, g_d = (freeze_function(getattr(d.problem, n)) for n in (
        "diffusion_factor", "diffusion_tensor", "force", "dirichlet"))
    grid = d.space.grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coeffs = rt1_flux_reconstruction(d.space, u, lam, kap,
                                     np.nonzero(d.boundary_info.dirichlet_faces)[0],
                                     np.zeros(0, dtype=np.int64), g_d, force_fn=force)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    qp, qw = cell_quadrature(grid, 6, u.device)
    div = rt1_divergence_at(grid, coeffs, qp)
    f = force(qp)
    mag = qw * (f.abs() + div.abs())

    def defect(w):
        return (torch.sum(qw * (f - div) * w, dim=1).abs()
                / torch.sum(mag * w.abs(), dim=1)).max().item()

    centred = qp - d.space.tensor(grid.cell_centroids)[:, None, :]
    return (defect(torch.ones_like(f)), max(defect(centred[..., 0]), defect(centred[..., 1])),
            seconds)


def higher_nd_kernels(d, label):
    """The two SpMV kernels at this discretization's nd on its scaled plane
    operator (the shapes its stencil_cg path gives plane_spmv): plane_spmv
    against its plain version in f64 and f32, timed beside the BSR library
    call; a power iteration through plane_spmv in f32 and one through
    StructuredBlockEll.matvec (structured_spmv, f32) on the same operator,
    their launch counts set to 0 just before and read just after, each
    against the f64 plane path's lambda_max; structured_spmv timed beside
    the BSR call.  Returns (kernels-line rows, max abs error in f64)."""
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.kernels.structured_spmv import (
        structured_spmv, structured_spmv_reference)
    from dune_hdd_tpu_torch.la.block_ell import StructuredBlockEll
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll

    system = d.stencil_system()
    S, B = system.S, system.B
    nd, nc = S.nd, S.num_cells
    err64 = check_plane_spmv_at(system, label)
    times, err = time_plane_spmv(S, B, label)
    b = B / torch.linalg.norm(B)
    lam64 = power_lambda(S.matvec, b)
    S32 = StencilBlockEll(S.planes.float(), S.plan)
    case = f"nd{nd}_f32"
    start_path()
    lam32 = power_lambda(S32.matvec, b.float())
    end_path()
    f32_launches = last_path_launches("plane_spmv", case)
    offsets = d.__dict__["_stencil_order"].offsets
    A = StructuredBlockEll(None, S32.planes.reshape(4, nd, nd, nc).permute(3, 0, 1, 2), offsets)
    with recording() as rec:
        lam_st = power_lambda(A.matvec, flat(b).float())
    st_launches = rec.total("kernel.structured_spmv")
    for what, lam, rel in (("plane f32", lam32, 1e-4), ("structured f32", lam_st, 1e-4)):
        if not abs(lam - lam64) <= rel * abs(lam64):
            raise AssertionError(f"{label}: {what} power iteration {lam} != f64 plane {lam64}")
    x = flat(B.float())
    y = structured_spmv(A.planes, x, A.offsets)
    st_err = rel_check(f"structured_spmv vs plain ({label})", y,
                       structured_spmv_reference(A.planes, x, A.offsets), 1e-5)
    rel_check(f"structured_spmv vs plane_spmv ({label})", y, flat(S32.matvec(B.float())), 1e-5)
    lib = bsr_operator(S32.planes, S.plan)
    e_lib = rel_check(f"BSR library call vs structured_spmv ({label})", lib @ x, y, 1e-4)
    st = timed("structured_spmv", f"{label} f32", lambda: structured_spmv(A.planes, x, A.offsets),
               lambda: structured_spmv_reference(A.planes, x, A.offsets), lambda: lib @ x,
               (A.planes.numel() + 2 * x.numel()) * 4, 2 * A.planes.numel(), torch.float32,
               dofs=x.numel(), library_max_abs_diff=f"{e_lib:.3e}")
    log("higher_nd_paths", case=label, nd=nd, dofs=B.numel(), power_iterations=20,
        lambda_f64=f"{lam64:.8e}", lambda_plane_f32=f"{lam32:.8e}",
        lambda_structured_f32=f"{lam_st:.8e}", plane_f32_launches=f32_launches,
        structured_launches=st_launches)
    rows = {f"plane_spmv_nd{nd}_f64": (times["float64"], err64),
            f"plane_spmv_nd{nd}_f32": (dict(times["float32"], launches=f32_launches), err),
            f"structured_spmv_nd{nd}": (dict(st, launches=st_launches), st_err)}
    del system, S, B, S32, A, lib, x, y
    return rows, max(err64, err)


def phase_esv2007_higher(dev, tc, order):
    """SWIPDG P<order> on the ESV2007 ALU-conforming hierarchy, levels 0-6
    (P2) or 0-5 (P3), through EocStudy with stencil_cg (4x4 macro, 1e-12,
    float64: plane_spmv at nd = 6 or 10), its launch counts set to 0 just
    before and read just after.  P2: the RT1 estimators at every level.
    Gates: the EOC bars of the reference's order-2/3 tests; P2's estimator
    rates and efficiency and div t_h = Pi_P1 f at the last level.  Returns
    (kernels-line rows, f64 launches, max abs error)."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.studies import EocStudy

    levels = HIGHER_LEVELS[order]
    nd = {2: 6, 3: 10}[order]
    types = P2_ESTIMATORS if order == 2 else ()
    estimate_fn, estimator_seconds = timed_estimates(types)
    max_iter = 100000
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": max_iter, "macro": (4, 4)}

    def factory(grid, boundary_info, problem, device):
        return SWIPDGDiscretization(grid, boundary_info, problem, order=order,
                                    only_these_products=(), device=device)

    torch.cuda.reset_peak_memory_stats()
    study = EocStudy(truncated(tc, levels), factory, estimator_types=types,
                     estimate_fn=estimate_fn, solver_options=options, device=dev)
    start_path()
    results = study.run(verbose=False)
    end_path()
    launches = last_path_launches("plane_spmv", f"nd{nd}_f64")
    tag = f"esv2007_p{order}"
    log_levels(tag + "_level", study, results, estimator_seconds if types else None)
    for r, info in enumerate(study.level_info):
        if not (info["type"] == "stencil_cg" and 0 < info["iterations"] < max_iter):
            raise AssertionError(f"{tag} level {r}: {info}")
    if launches <= 0:
        raise AssertionError(f"{tag}: the study did not launch plane_spmv at nd = {nd}")
    eocs = rates(study, ("L2", "H1_semi", "energy") + types[:-1])  # all but eta_ESV2007
    if order == 2:
        bars = {"L2": 2.8, "H1_semi": 1.9, "energy": 1.85, "eta_NC_ESV2007": 1.85,
                "eta_DF_ESV2007": 1.85, "eta_R_ESV2007_*": 2.7}
        failed = {k: v for k, v in eocs.items() if min(v) <= bars[k]}
        eff = [e / h for e, h in zip(results["eta_ESV2007"], results["energy"])]
        if failed or not all(1.0 <= e < 2.0 for e in eff):
            raise AssertionError(f"{tag}: EOC {failed} or efficiency {eff}")
        mean, centred, rt1_s = rt1_projection_defect(study.discretizations[-1],
                                                     study.solutions[-1])
        if not (centred <= 1e-8 and mean <= 1e-5):
            raise AssertionError(f"{tag} level {levels}: div t_h != Pi_P1 f (mean {mean:.3e}, "
                                 f"centred moments {centred:.3e})")
        fields = dict(eff_ESV2007=repr([round(e, 4) for e in eff]),
                      rt1_mean_max_rel_defect=f"{mean:.3e}",
                      rt1_centred_moment_max_rel_defect=f"{centred:.3e}",
                      rt1_reconstruction_seconds=f"{rt1_s:.3f}")
    else:
        if not (min(eocs["L2"][:4]) > 3.7 and min(eocs["H1_semi"]) > 2.8):
            raise AssertionError(f"{tag}: EOC {eocs}")
        fields = dict(L2_last_level=f"{results['L2'][-1]:.6e}")
    log(tag, levels=f"0-{levels}", launches=launches,
        **{f"eoc_{k}": repr([round(e, 4) for e in v]) for k, v in eocs.items()}, **fields,
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
    d = study.discretizations[-1]
    del study, results
    rows, err = higher_nd_kernels(d, f"P{order} level {levels}")
    rows[f"plane_spmv_nd{nd}_f64"][0]["launches"] = launches
    del d
    torch.cuda.empty_cache()
    return rows, err


def phase_esv2007_cube(dev):
    """SWIPDG Q1 (levels 0-6) and Q2 (levels 0-5) on the ESV2007 cube (quad)
    hierarchy with stencil_cg, which is block_cg.jacobi on a grid with no
    structured order, to 1e-12.  Q1: the recorded cube table (errors at
    levels 0-3, the six estimators at 0-2) within 5e-3, EOC above 1.9 (L2)
    and 0.95 (H1_semi) at levels 4-6, RT0-on-rectangles conservation at
    level 6.  Q2: EOC above 2.8 (L2) and 1.9 (H1_semi)."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.studies import EocStudy, expected_results
    from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase

    t0 = time.perf_counter()
    tc = ESV2007TestCase(num_refinements=CUBE_LEVELS[1], grid_variant="cube")
    hierarchy_s = time.perf_counter() - t0
    options = {"type": "stencil_cg", "precision": 1e-12, "max_iter": 100000}
    for order, levels in CUBE_LEVELS.items():
        types = ESV_ESTIMATORS if order == 1 else ()
        estimate_fn, estimator_seconds = timed_estimates(types)

        def factory(grid, boundary_info, problem, device, order=order):
            return SWIPDGDiscretization(grid, boundary_info, problem, order=order,
                                        only_these_products=(), device=device)

        torch.cuda.reset_peak_memory_stats()
        study = EocStudy(truncated(tc, levels), factory, estimator_types=types,
                         estimate_fn=estimate_fn, solver_options=options, device=dev)
        results = study.run(verbose=False)
        tag = f"esv2007_cube_q{order}"
        log_levels(tag + "_level", study, results, estimator_seconds if types else None)
        if any(i["type"] != "block_cg.jacobi" for i in study.level_info):
            raise AssertionError(f"{tag}: {study.level_info}")
        eocs = rates(study, ("L2", "H1_semi"))
        fields = {}
        if order == 1:
            mismatch = {}
            for k, v in results.items():
                want = expected_results("ESV2007", "cube", 1, k)
                if want is None or not np.allclose(v[:len(want)], want, rtol=CUBE_VALUE_RTOL,
                                                   atol=0):
                    mismatch[k] = (v[:4], want)
            if mismatch or not (min(eocs["L2"][3:]) > 1.9 and min(eocs["H1_semi"][3:]) > 0.95):
                raise AssertionError(f"{tag}: table {mismatch} or EOC {eocs}")
            conservation, rt0_s = rt0_conservation(study.discretizations[-1],
                                                   study.solutions[-1])
            if not conservation <= 1e-5:
                raise AssertionError(f"{tag} level {levels}: div t_h != P0 f ({conservation:.3e})")
            fields = dict(table="levels 0-3 errors, 0-2 estimators ok (rel 5e-3)",
                          rt0_conservation_max_rel_dev=f"{conservation:.3e}",
                          rt0_reconstruction_seconds=f"{rt0_s:.3f}")
        elif not (min(eocs["L2"]) > 2.8 and min(eocs["H1_semi"]) > 1.9):
            raise AssertionError(f"{tag}: EOC {eocs}")
        log(tag, levels=f"0-{levels}", hierarchy_host_seconds=f"{hierarchy_s:.2f}",
            **{f"eoc_{k}": repr([round(e, 4) for e in v]) for k, v in eocs.items()}, **fields,
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))
        del study, results
        torch.cuda.empty_cache()


def phase_cg_higher(dev, tc_alu):
    """CGDiscretization P2 and P3 on the ESV2007 ALU hierarchy and Q2 on the
    cube hierarchy, levels 0-5, Jacobi CG to 1e-12: the EOC bars of the
    reference's order-2/3 tests (P2/Q2: L2 > 2.8, H1_semi > 1.9; P3: L2 >
    3.7 up to level 4, H1_semi > 2.8)."""
    from dune_hdd_tpu_torch.discretizations import CGDiscretization
    from dune_hdd_tpu_torch.studies import EocStudy
    from dune_hdd_tpu_torch.testcases.esv2007 import ESV2007TestCase

    levels = CG_HIGHER_LEVELS
    options = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 200000}
    cube = ESV2007TestCase(num_refinements=levels, grid_variant="cube")
    for label, tc, order in (("P2", tc_alu, 2), ("P3", tc_alu, 3), ("Q2", cube, 2)):
        def factory(grid, boundary_info, problem, device, order=order):
            return CGDiscretization(grid, boundary_info, problem, order=order,
                                    only_these_products=(), device=device)

        torch.cuda.reset_peak_memory_stats()
        study = EocStudy(truncated(tc, levels), factory, norms=("L2", "H1_semi"),
                         solver_options=options, device=dev)
        results = study.run(verbose=False)
        log_levels(f"cg_{label}_level", study, results)
        eocs = rates(study, ("L2", "H1_semi"))
        l2_bar, h1_bar, l2_upto = (3.7, 2.8, 4) if order == 3 else (2.8, 1.9, levels)
        if not (min(eocs["L2"][:l2_upto]) > l2_bar and min(eocs["H1_semi"]) > h1_bar):
            raise AssertionError(f"CG {label}: EOC {eocs}")
        log(f"cg_{label}", levels=f"0-{levels}",
            **{f"eoc_{k}": repr([round(e, 4) for e in v]) for k, v in eocs.items()},
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del study, results


def phase_interval(dev):
    """Interval SWIPDG orders 1-3 on the card: -u'' = pi^2 sin(pi x) on 8, 16
    and 32 cells with the EOC bars of the reference's interval test (order
    1: L2 > 1.8, H1_semi > 0.8; order 2: 2.8, 1.8), and order 3 exact for a
    cubic."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.functions.base import (
        ConstantFunction, LambdaFunction, constant_matrix)
    from dune_hdd_tpu_torch.grid.structured import interval_grid
    from dune_hdd_tpu_torch.ops.norms import error_norms
    from dune_hdd_tpu_torch.problems.interfaces import Problem
    from dune_hdd_tpu_torch.studies import eoc_rates

    bi = {"type": "stuff.grid.boundaryinfo.alldirichlet"}
    exact = LambdaFunction(lambda x: torch.sin(np.pi * x[..., 0]), order=8)
    sine = Problem(ConstantFunction(1.0), constant_matrix(1.0, dim=1),
                   LambdaFunction(lambda x: np.pi ** 2 * torch.sin(np.pi * x[..., 0]), order=8),
                   ConstantFunction(0.0), ConstantFunction(0.0))
    out = {}
    for order, (l2_bar, h1_bar) in ((1, (1.8, 0.8)), (2, (2.8, 1.8)), (3, (None, None))):
        errs = [error_norms(d.space, d.solve(options={"type": "direct"}), exact)
                for d in (SWIPDGDiscretization(interval_grid(0, 1, n), bi, sine, order=order,
                                               device=dev) for n in (8, 16, 32))]
        eoc = {k: eoc_rates([e[k] for e in errs]) for k in ("L2", "H1_semi")}
        if l2_bar is not None and not (np.mean(eoc["L2"]) > l2_bar
                                       and np.mean(eoc["H1_semi"]) > h1_bar):
            raise AssertionError(f"interval order {order}: EOC {eoc}")
        out[order] = {k: [round(r, 4) for r in v] for k, v in eoc.items()}
    cubic = Problem(ConstantFunction(1.0), constant_matrix(1.0, dim=1),
                    LambdaFunction(lambda x: -6.0 * x[..., 0], order=1),
                    LambdaFunction(lambda x: x[..., 0] ** 3, order=3), ConstantFunction(0.0))
    d = SWIPDGDiscretization(interval_grid(0, 1, 4), bi, cubic, order=3, device=dev)
    e = error_norms(d.space, d.solve(options={"type": "direct"}),
                    LambdaFunction(lambda x: x[..., 0] ** 3, order=3))
    if not (e["L2"] < 1e-9 and e["H1_semi"] < 1e-8):
        raise AssertionError(f"interval order 3 is not exact for a cubic: {e}")
    log("interval", cells="8, 16, 32", eoc=repr(out),
        order3_cubic_errors=f"L2 {e['L2']:.3e}, H1_semi {e['H1_semi']:.3e}")


def phase_gmres(dev, tc):
    """gmres and gmres.jacobi (restart 50; maxiter counts restarts) on the
    ESV2007 SWIPDG P1 and CG P1 systems of level 3, to a relative 1e-12:
    each solution within 1e-8 (max, relative) of the direct solve."""
    from dune_hdd_tpu_torch.discretizations import CGDiscretization, SWIPDGDiscretization
    from dune_hdd_tpu_torch.la.solvers import solver_options

    level = GMRES_LEVEL
    grid = tc.level_grid(level)
    for name, cls in (("SWIPDG", SWIPDGDiscretization), ("CG", CGDiscretization)):
        d = cls(grid, tc.boundary_info(), tc.problem, only_these_products=(), device=dev)
        u_direct = d.solve(options={"type": "direct"})
        for type_ in ("gmres", "gmres.jacobi"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u = d.solve(options=dict(solver_options(type_), precision=1e-12))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            info = d.last_solve_info
            diff = ((u - u_direct).abs().max() / u_direct.abs().max()).item()
            if not diff <= 1e-8:
                raise AssertionError(f"{name} {type_}: {diff:.3e} from direct ({info})")
            log("gmres", discretization=name, level=level, dofs=d.space.num_dofs, type=type_,
                restart=50, arnoldi_steps=info["iterations"], restarts=info["restarts"],
                rel_max_diff_vs_direct=f"{diff:.3e}", seconds=f"{seconds:.3f}")


# -- the command-line entry point and the tensor Q1 CG path --------------------

CLI_EXAMPLES = ("cg", "swipdg", "block-swipdg", "thermalblock")
# the ESV2007 level-6 grid through the CLI's config: the 4x4 criss
# triangulation of [-1, 1]^2 with 14 conforming bisections, 1,572,864 DoF
CLI_LEVEL6 = {"grid.type": "stuff.grid.provider.alu_conforming", "grid.lower_left": [-1, -1],
              "grid.upper_right": [1, 1], "grid.num_elements": [4, 4],
              "grid.num_refinements": 14}
# sha256 of each example's default config text as the reference package
# writes it (tests/test_torch_cli.py holds these to the reference's writer)
CLI_CONFIG_SHA256 = {
    "cg": "0ea7ef8e1b106f0bfed7c218e218ddcc9dcb1bec235c60d9b0ee402ecca46803",
    "swipdg": "0ea7ef8e1b106f0bfed7c218e218ddcc9dcb1bec235c60d9b0ee402ecca46803",
    "block-swipdg": "2d50da5bff265846d958b18af0e7e778f60e07b53c5ffec802dd4f5f209b3c9d",
    "thermalblock": "0ec639fac202b1db04f6e6b9d6ae1c7155ad38d9c673a6a6b0c5d996335a3f44",
}
# the reference's eff_OS2014 recordings at the first level (BASELINE.md)
FVCA7_EFF_LEVEL0 = {"[1 1 1]": 3.35, "[2 2 1]": 2.47, "[4 4 1]": 2.03, "[8 8 1]": 1.81}
TENSOR_CG_OPTS = {"type": "cg.jacobi", "precision": 1e-12, "max_iter": 20000}
# dim -> (initial cells per axis, refinements): 8 -> 1,024 cells, 4^2 -> 512^2,
# 4^3 -> 128^3 (2,146,689 DoF)
TENSOR_EOC = {1: (8, 7), 2: (4, 7), 3: (4, 5)}
TB3D_CELLS = 128      # 129^3 = 2,146,689 DoF
TB3D_RIESZ_CELLS = 24  # 15,625 DoF: the host splu of the 3D h1_semi product fills in
TB3D_OPTS = {"type": "cg.jacobi", "precision": 1e-10, "max_iter": 20000}
TB3D_TRAINING = 16
TB3D_EXTENSIONS = 5
TB3D_ONLINE_MUS = 1024


def run_cli(argv):
    """``dune-hdd-tpu-torch argv`` in this process (on the card, its
    default); returns what it printed, raising on a non-zero exit."""
    import contextlib
    import io

    from dune_hdd_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"dune-hdd-tpu-torch {' '.join(argv)}: exit {rc}\n{out}")
    return out


def cli_solves(out):
    """[(|u|_max, {solver report})] of an example run's output."""
    umax = [float(v) for v in re.findall(r"\|u\|_max = (\S+)", out)]
    reports = [dict(kv.split("=", 1) for kv in line.split(", "))
               for line in re.findall(r"solver: (.*)", out)]
    return list(zip(umax, reports))


def phase_cli(dev):
    """The port's command-line entry point in a temporary directory, on the
    card: write-config-then-solve for every example (each parameter block,
    VTU output); the ESV2007 level-6 grid through the config with
    --solver stencil_cg (plane_spmv launches counted); the RB greedy of the
    default thermalblock config; both studies, the FVCA7 poster rows held to
    the recorded table at 2e-3; each default config's text against the
    reference writer's digest and through a write / read round trip."""
    import hashlib
    import os
    import tempfile

    from dune_hdd_tpu_torch.cli.examples import (
        LinearellipticExampleBlockSWIPDG, LinearellipticExampleCG, LinearellipticExampleSWIPDG,
        ThermalblockExample)
    from dune_hdd_tpu_torch.studies.expectations import expected_results
    from dune_hdd_tpu_torch.utils.config import Configuration

    classes = {"cg": LinearellipticExampleCG, "swipdg": LinearellipticExampleSWIPDG,
               "block-swipdg": LinearellipticExampleBlockSWIPDG,
               "thermalblock": ThermalblockExample}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for name in CLI_EXAMPLES:
                t0 = time.perf_counter()
                if "wrote default config" not in run_cli([name]):
                    raise AssertionError(f"{name}: no default config written")
                text = classes[name].write_config().to_string()
                digest = hashlib.sha256(text.encode()).hexdigest()
                back = Configuration.from_file(f"{classes[name].static_id()}.cfg").to_string()
                if digest != CLI_CONFIG_SHA256[name] or back != text:
                    raise AssertionError(f"{name}: config text {digest} (round trip "
                                         f"{back == text})")
                out = run_cli([name, "--visualize", name])
                solves = cli_solves(out)
                files = [f for f in os.listdir() if f.startswith(name + "_mu_")]
                if not (len(solves) == 2 and all(math.isfinite(u) and u > 0 for u, _ in solves)
                        and len(files) == 2):
                    raise AssertionError(f"{name}: {out}")
                log("cli", example=name, dofs=re.search(r": (\d+) DoF", out).group(1),
                    u_max=repr([u for u, _ in solves]),
                    solver=solves[0][1].get("type"), iterations=solves[0][1].get("iterations"),
                    config_sha256=digest[:12], vtu=len(files),
                    seconds=f"{time.perf_counter() - t0:.2f}")

            cfg = Configuration.from_file(f"{LinearellipticExampleSWIPDG.static_id()}.cfg")
            for key, value in CLI_LEVEL6.items():
                cfg[key] = value
            cfg.write("esv2007_level6.cfg")
            t0 = time.perf_counter()
            start_path()
            out = run_cli(["swipdg", "esv2007_level6.cfg", "--solver", "stencil_cg"])
            launches = end_path()
            (umax, report), = set((u, tuple(r.items())) for u, r in cli_solves(out))
            report = dict(report)
            dofs = int(re.search(r": (\d+) DoF", out).group(1))
            expected_dofs = 3 * 32 * 2 ** CLI_LEVEL6["grid.num_refinements"]
            if not (report["type"] == "stencil_cg" and launches > 0 and dofs == expected_dofs
                    and abs(umax - 1.0) < 1e-2):
                raise AssertionError(f"level-6 stencil_cg: {launches} launches\n{out}")
            log("cli_stencil_cg", dofs=dofs, u_max=umax, iterations=report["iterations"],
                rtol=report["rtol"], launches=launches,
                seconds=f"{time.perf_counter() - t0:.2f}", card=repr(card()))

            t0 = time.perf_counter()
            out = run_cli(["rb"])
            size, err = re.search(r"final basis size (\d+), max error (\S+)", out).groups()
            if not float(err) <= 1e-6:
                raise AssertionError(f"rb: {out}")
            log("cli_rb", basis_size=int(size), max_error=err,
                seconds=f"{time.perf_counter() - t0:.2f}")

            t0 = time.perf_counter()
            out = run_cli(["study", "--case", "esv2007"])
            eff = [float(v) for v in re.search(r"eff_ESV2007: (.*)", out).group(1).split()]
            if not np.allclose(eff, [1.3666, 1.2771, 1.2326], atol=1e-2):
                raise AssertionError(f"study esv2007: {out}")
            log("cli_study", case="esv2007", eff_ESV2007=repr(eff),
                seconds=f"{time.perf_counter() - t0:.2f}")

            t0 = time.perf_counter()
            out = run_cli(["study", "--case", "os2014"])
            rows = {}
            for part, lvl, e, eta, eff in re.findall(
                    r"(\[\d+ \d+ 1\])\s+(\d+)\s+(\S+)\s+(\S+)\s+(\S+)", out):
                for typ, v in (("energy", e), ("eta_OS2014", eta), ("eff_OS2014", eff)):
                    rows.setdefault(part, {}).setdefault(typ, []).append(float(v))
            if set(rows) != set(FVCA7_EFF_LEVEL0):
                raise AssertionError(f"study os2014: {out}")
            worst = 0.0
            for part, r in rows.items():
                for typ, vals in r.items():
                    exp = np.asarray(expected_results(f"FVCA7.poster.{part}", "alu_conforming",
                                                      1, typ))
                    worst = max(worst, float(np.max(np.abs(np.asarray(vals) - exp) / exp)))
                if abs(r["eff_OS2014"][0] - FVCA7_EFF_LEVEL0[part]) >= 0.01 * 3.4:
                    raise AssertionError(f"{part}: eff {r['eff_OS2014'][0]}")
            if not worst <= 2e-3:
                raise AssertionError(f"FVCA7 poster rows {worst:.3e} from the recorded table")
            log("cli_study", case="os2014", partitionings=len(rows),
                max_rel_diff_vs_recorded=f"{worst:.3e}",
                eff_level0=repr({p: r["eff_OS2014"][0] for p, r in rows.items()}),
                seconds=f"{time.perf_counter() - t0:.2f}")
        finally:
            os.chdir(cwd)


def tensor_cg(grid, boundary_info, problem, device):
    """The EOC study's factory: TensorCG without the products it does not read."""
    from dune_hdd_tpu_torch.discretizations import TensorCGDiscretization

    return TensorCGDiscretization(grid, boundary_info, problem, only_these_products=(),
                                  device=device)


def phase_tensor_eoc(dev):
    """The manufactured sine on [0,1]^d through EocStudy and TensorCG (Q1,
    cg.jacobi 1e-12): d = 1 from 8 to 1,024 cells, d = 2 from 4^2 to 512^2,
    d = 3 from 4^3 to 128^3 (2,146,689 DoF); EOC(L2) >= 1.9 and
    EOC(H1_semi) >= 0.95 between the last three levels."""
    from dune_hdd_tpu_torch.studies import EocStudy, eoc_rates
    from dune_hdd_tpu_torch.testcases.tensor import TensorSineTestcase

    for dim, (cells, refinements) in TENSOR_EOC.items():
        t0 = time.perf_counter()
        tc = TensorSineTestcase(dim, initial_cells=cells, num_refinements=refinements)
        study = EocStudy(tc, tensor_cg, norms=("L2", "H1_semi"), solver_options=TENSOR_CG_OPTS,
                         device=dev)
        results = study.run(verbose=False)
        eoc_l2, eoc_h1 = eoc_rates(results["L2"]), eoc_rates(results["H1_semi"])
        for r, info in enumerate(study.level_info):
            log("tensor_eoc_level", dim=dim, level=r, cells=tc.level_grid(r).num_cells,
                dofs=info["num_dofs"], L2=f"{results['L2'][r]:.4e}",
                H1_semi=f"{results['H1_semi'][r]:.4e}", iterations=info["iterations"],
                time_to_solution=f"{study.time_to_solution[r]:.3f}",
                assembly_seconds=f"{info['assembly_seconds']:.3f}",
                solve_seconds=f"{info['solve_seconds']:.3f}")
        log("tensor_eoc", dim=dim, levels=f"0-{refinements}",
            eoc_L2=repr([round(e, 4) for e in eoc_l2]),
            eoc_H1_semi=repr([round(e, 4) for e in eoc_h1]),
            seconds=f"{time.perf_counter() - t0:.2f}", card=repr(card()))
        if not (min(eoc_l2[-2:]) >= 1.9 and min(eoc_h1[-2:]) >= 0.95):
            raise AssertionError(f"tensor EOC d={dim}: {eoc_l2}, {eoc_h1}")
        del study
        torch.cuda.empty_cache()


def tb3d_mus(seed, count):
    """``count`` thermalblock parameters 10^U(-1, 1) per block."""
    rng = np.random.default_rng(seed)
    return [{"diffusion_factor": 10 ** rng.uniform(-1, 1, 8)} for _ in range(count)]


def timed_solve(d, mu, opts):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = d.solve(mu, opts)
    torch.cuda.synchronize()
    return u, time.perf_counter() - t0


def phase_thermalblock_3d(dev):
    """The ThermalblockExample<SGrid<3,3>> instantiation at 128^3 Q1 cells
    (2,146,689 DoF), [2 2 2] blocks: set-up seconds by step, 8 mu from
    default_rng(17) each solved by cg.jacobi to a float64-rechecked
    ||b - A u|| / ||b|| <= 1e-8, mu = 1 against the constant-diffusion solve
    to 1e-10, the true-error RB greedy (16 training mu from default_rng(7),
    5 extensions, gram_schmidt in h1_semi: the maximum errors decrease), the
    reduced model's relative h1_semi errors at the 8 mu (the SpMV's own
    phase is ``phase_ell_spmv``)."""
    from dune_hdd_tpu_torch.cli.examples import ThermalblockExample
    from dune_hdd_tpu_torch.discretizations import TensorCGDiscretization
    from dune_hdd_tpu_torch.mor import greedy_rb
    from dune_hdd_tpu_torch.utils.logging import timings

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording():
        d = ThermalblockExample(device=dev).initialize_tensor(
            dim=3, num_elements=TB3D_CELLS, num_blocks=(2, 2, 2)).discretization()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = d.space.num_dofs
    if not (n == (TB3D_CELLS + 1) ** 3 and d.get_operator().num_components == 8):
        raise AssertionError(f"{n} DoF, {d.get_operator().num_components} components")
    split = {k.split(".")[1]: sum(v) for k, v in timings().items() if k.startswith("tensor_cg.")}
    log("thermalblock_3d_setup", dofs=n, cells=d.space.grid.num_cells,
        nnz=d.pattern().nnz, raw_entries=d.pattern().num_raw, ell_width=d.pattern().ell_width,
        seconds=f"{setup_s:.2f}", **{f"{k}_seconds": f"{v:.2f}" for k, v in split.items()},
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card()))

    mus = tb3d_mus(17, 8)
    solutions = []
    for i, mu in enumerate(mus):
        u, seconds = timed_solve(d, mu, TB3D_OPTS)
        info = d.last_solve_info
        A, b = d.freeze_operator(mu), d.freeze_rhs(mu)
        res = float(torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b))
        del A
        if not res <= 1e-8:
            raise AssertionError(f"mu {i}: relative residual {res:.3e} ({info})")
        solutions.append(u)
        log("thermalblock_3d_solve", i=i, mu=repr([round(float(m), 4) for m in mu["diffusion_factor"]]),
            iterations=info["iterations"], seconds=f"{seconds:.3f}",
            ms_per_iteration=f"{seconds / info['iterations'] * 1e3:.3f}",
            rel_residual_f64=f"{res:.3e}")

    exact_opts = dict(TB3D_OPTS, precision=1e-12)
    u1, _ = timed_solve(d, {"diffusion_factor": np.ones(8)}, exact_opts)
    ref = TensorCGDiscretization(d.space.grid, None, only_these_products=(), device=dev)
    uref, _ = timed_solve(ref, None, exact_opts)
    diff = float((u1 - uref).abs().max())
    del ref, uref
    if not diff <= 1e-10:
        raise AssertionError(f"mu = 1 against constant diffusion: {diff:.3e}")

    training = tb3d_mus(7, TB3D_TRAINING)
    t0 = time.perf_counter()
    with recording():
        res = greedy_rb(d, training, target_error=1e-8, max_extensions=TB3D_EXTENSIONS,
                        extension_algorithm="gram_schmidt", error_norm="h1_semi",
                        solver_options=TB3D_OPTS)
        torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    split = {k[4:]: sum(v) for k, v in timings().items() if k.startswith("mor.")}
    errs = [e for e in res.max_errors if e >= 0]
    rm = res.reduced_model
    h1 = d.product_matrix("h1_semi")
    rel = [rel_norm(u - rm.reconstruct(rm.solve(mu)), u, h1) for mu, u in zip(mus, solutions)]
    log("thermalblock_3d_greedy", training=len(training), extensions=res.extensions,
        max_errors=repr([float(f"{e:.6e}") for e in res.max_errors]),
        seconds=f"{greedy_s:.2f}", **{f"{k}_seconds": f"{v:.2f}" for k, v in split.items()},
        rel_h1_semi_at_8_mu=repr([float(f"{e:.4e}") for e in rel]),
        mu1_vs_constant_max_abs=f"{diff:.3e}")
    if not (res.extensions == TB3D_EXTENSIONS and len(errs) >= 2 and errs[-1] < errs[0]
            and all(math.isfinite(e) for e in rel)):
        raise AssertionError(f"3D greedy: {res.max_errors}, {rel}")


def ell_bytes(A) -> int:
    """The bytes one product with the ELL matrix ``A`` must move: each
    stored value and its 4-byte column read once, x read and y written
    once (padding excluded)."""
    es = A.values.element_size()
    return A.pattern.nnz * (es + 4) + sum(A.shape) * es


def csr_operator(A):
    """``A`` as a torch.sparse CSR tensor: the library yardstick of the ELL
    SpMV (timed here, used nowhere in the port)."""
    idx = A.pattern.on(A.device)
    counts = torch.bincount(idx.slot_rows, minlength=A.shape[0])
    crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return torch.sparse_csr_tensor(crow, idx.slot_cols.to(torch.int32), A.values, size=A.shape)


def check_ell_spmv(A, label, seed):
    """The kernel against its plain version on ``A`` (1e-13 x max|y| in
    float64, 1e-5 in float32), two calls bitwise equal, the CSR library
    call within 10x that; then kernel, plain version and library call
    timed.  Returns the timing fields of the kernels line."""
    from dune_hdd_tpu_torch.kernels.ell_spmv import (_sms, ell_geometry, ell_spmv,
                                                     ell_spmv_reference)

    dtype = A.values.dtype
    rel = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    cols = A.pattern.on(A.device).ell_cols
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(A.shape[1], generator=gen, dtype=torch.float64).to(A.device, dtype)
    y, y_ref = ell_spmv(A.ell, cols, x), ell_spmv_reference(A.ell, cols, x)
    err = rel_check(f"ell_spmv vs plain ({label})", y, y_ref, rel)
    if not torch.equal(y, ell_spmv(A.ell, cols, x)):
        raise AssertionError(f"ell_spmv ({label}): two calls differ")
    C = csr_operator(A)
    e_lib = rel_check(f"CSR library call vs ell_spmv ({label})", C @ x, y, 10 * rel)
    n, K = A.ell.shape
    R, threads, smem = ell_geometry(n, K, A.values.element_size(), _sms(A.device))
    row = timed("ell_spmv", label, lambda: ell_spmv(A.ell, cols, x),
                lambda: ell_spmv_reference(A.ell, cols, x), lambda: C @ x, ell_bytes(A),
                2 * A.pattern.nnz, dtype, rows=n, ell_width=K, nnz=A.pattern.nnz,
                tile_rows=R, threads=threads, smem_bytes=smem, max_abs_err=f"{err:.3e}",
                library_max_abs_diff=f"{e_lib:.3e}")
    del C, x, y, y_ref
    return row, err


def phase_ell_spmv(dev, swipdg_bisections=14):
    """The scalar-ELL SpMV kernel (``SparseMatrix.matvec``) on the card: on
    the 3D [2 2 2] thermalblock Q1 operator at 128^3 cells (2,146,689 rows,
    K = 27, float64) and on the 2x2 thermalblock SWIPDG operator at
    ``swipdg_bisections`` bisections in float32 and float64, each against
    its plain version and timed against its bound, the plain version and
    the torch.sparse CSR product; then one float64 cg.jacobi solve of the 3D
    operator, which must launch the kernel once for the initial residual
    and once a CG step (the iterations, rounded up to the solver's next
    host check).  Returns
    {row name: (timing fields, max abs error)}; the 3D row's fields hold
    the solve's launches."""
    from dune_hdd_tpu_torch.cli.examples import ThermalblockExample
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.la.solvers import CHECK_EVERY
    from dune_hdd_tpu_torch.la.sparse import SparseMatrix
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    rows = {}
    d = ThermalblockExample(device=dev).initialize_tensor(
        dim=3, num_elements=TB3D_CELLS, num_blocks=(2, 2, 2)).discretization()
    mu = tb3d_mus(17, 1)[0]
    A = d.freeze_operator(mu)
    row, err = check_ell_spmv(A, "3D Q1 f64", 31)
    with recording() as rec:
        u, seconds = timed_solve(d, mu, TB3D_OPTS)
    iters, launches = d.last_solve_info["iterations"], rec.total("kernel.ell_spmv")
    b = d.freeze_rhs(mu)
    res = float(torch.linalg.norm(b - A.matvec(u)) / torch.linalg.norm(b))
    log("ell_spmv_solve", case="3D Q1 cg.jacobi f64", iterations=iters, launches=launches,
        seconds=f"{seconds:.3f}", ms_per_iteration=f"{seconds / iters * 1e3:.3f}",
        rel_residual_f64=f"{res:.3e}")
    # the initial residual, then one a CG step: the steps masked past the
    # stopping test up to its next host check (la/solvers.CHECK_EVERY) too
    steps = -(-iters // CHECK_EVERY) * CHECK_EVERY
    if not (launches == steps + 1 and res <= 1e-8):
        raise AssertionError(f"3D solve: {launches} launches for {iters} iterations "
                             f"({steps} steps), residual {res:.3e}")
    rows["ell_spmv_f64_3d_q1"] = (dict(row, launches=launches), err)
    del d, A, b, u
    torch.cuda.empty_cache()

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=swipdg_bisections)
    d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), device=dev)
    A = d.freeze_operator(np.full(4, 0.5))
    for dtype in (torch.float32, torch.float64):
        Ad = SparseMatrix(A.pattern, A.values.to(dtype))
        name = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        row, err = check_ell_spmv(Ad, f"SWIPDG thermalblock {name}", 37)
        rows[f"ell_spmv_{name}_swipdg"] = (row, err)
        del Ad
    del d, A
    torch.cuda.empty_cache()
    return rows


def check_block_jacobi(dev, nd, lattice, dtype, seed):
    """The block-Jacobi kernel bitwise against its plain version on random
    inverse blocks at ``lattice``, then kernel, plain version and the one
    einsum that computes the same timed against the bytes bound.  Returns
    the timing fields of the kernels line."""
    from dune_hdd_tpu_torch.kernels.block_jacobi import block_jacobi, block_jacobi_reference
    from dune_hdd_tpu_torch.la.block_ell import inv3x3

    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (8,) + tuple(lattice) + (nd, nd)
    D = (torch.randn(shape, generator=gen, dtype=torch.float64)
         + 2 * nd * torch.eye(nd, dtype=torch.float64)).to(dev, dtype)
    Dinv = torch.movedim(inv3x3(D) if nd == 3 else torch.linalg.inv(D), (-2, -1),
                         (0, 1)).contiguous()
    R = torch.randn((nd, 8) + tuple(lattice), generator=gen, dtype=torch.float64).to(dev, dtype)
    del D
    Z = block_jacobi(Dinv, R)
    torch.cuda.synchronize()
    if not torch.equal(Z, block_jacobi_reference(Dinv, R)):
        raise AssertionError(f"block_jacobi nd {nd} {tuple(lattice)} {dtype}: not bitwise "
                             "its plain version")
    sites = R[0].numel()
    D2, R2 = Dinv.view(nd, nd, sites), R.view(nd, sites)
    name = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    row = timed("block_jacobi", f"nd{nd}_{name} {lattice[0]}x{lattice[1]}",
                lambda: block_jacobi(Dinv, R), lambda: block_jacobi_reference(Dinv, R),
                lambda: torch.einsum("ijc,jc->ic", D2, R2),
                (nd * nd + 2 * nd) * sites * R.element_size(), (2 * nd * nd - nd) * sites,
                dtype, sites=sites, bitwise_equal=True)
    del Dinv, R, Z
    return row


def phase_block_jacobi(dev, bisections=14):
    """The block-Jacobi apply on the card: bitwise against its plain
    version and timed at the two cells' shapes (nd 3: (256, 256) float64,
    the snapshot solve's; (160, 800) float32, the b8 deflation apply's) and
    at nd 6 and 10; then one snapshot solve of the 2x2 thermalblock SWIPDG
    at ``bisections`` (Jacobi stencil_cg 1e-8), which must launch the kernel
    once for the initial residual and once an iteration.  Returns {row
    name: (timing fields, 0.0)}; the snapshot row's fields hold the solve's
    launches."""
    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    rows = {}
    for nd, lattice, dtype in [(3, (256, 256), torch.float64), (3, (160, 800), torch.float32),
                               (6, (128, 128), torch.float64), (10, (64, 64), torch.float64),
                               (6, (128, 128), torch.float32), (10, (64, 64), torch.float32)]:
        name = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        key = f"block_jacobi_nd{nd}_{name}_{lattice[0]}x{lattice[1]}"
        rows[key] = (check_block_jacobi(dev, nd, lattice, dtype, 41 + nd), 0.0)
    torch.cuda.empty_cache()

    grid = alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=bisections)
    d = SWIPDGDiscretization(grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), only_these_products=(), device=dev)
    mu = np.random.default_rng(19).uniform(0.1, 1.0, 4)
    opts = {"type": "stencil_cg", "precision": 1e-8, "max_iter": 50000}
    d.uncached_solve(mu, opts)  # capture and build once
    with recording() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.uncached_solve(mu, opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    iters, launches = d.last_solve_info["iterations"], rec.total("kernel.block_jacobi")
    log("block_jacobi_solve", case=f"thermalblock 2x2 stencil_cg f64, {d.space.num_dofs} DoF",
        iterations=iters, launches=launches, seconds=f"{seconds:.3f}",
        ms_per_iteration=f"{seconds / iters * 1e3:.4f}", card=repr(card()))
    if launches != iters + 1:
        raise AssertionError(f"snapshot solve: {launches} block_jacobi launches for {iters} "
                             "iterations")
    key = "block_jacobi_nd3_f64_256x256"
    rows[key] = (dict(rows[key][0], launches=launches), 0.0)
    del d
    torch.cuda.empty_cache()
    return rows


def phase_thermalblock_3d_riesz(dev):
    """The same problem at 24^3 cells (15,625 DoF: the host splu of the 3D
    h1_semi product fills in, 14.1M L+U nonzeros here and 57.7M at 32^3,
    scripts/torch_splu_fill.py): the
    Riesz-estimator greedy with min-theta coercivity at mu_bar = 1, the
    certification 0.99 err <= eta <= 10 err in the mu-energy norm at 5
    held-out mu, and the batched online sweep over 1,024 mu against the
    loop."""
    from dune_hdd_tpu_torch.cli.examples import ThermalblockExample
    from dune_hdd_tpu_torch.mor import greedy_rb, min_theta_coercivity
    from dune_hdd_tpu_torch.mor.batch import (
        batched_estimates, batched_reduced_solve, stack_parameters)

    t_phase = time.perf_counter()
    d = ThermalblockExample(device=dev).initialize_tensor(
        dim=3, num_elements=TB3D_RIESZ_CELLS, num_blocks=(2, 2, 2)).discretization()
    opts = dict(TB3D_OPTS, precision=1e-13, max_iter=30000)
    alpha = min_theta_coercivity(d.get_operator(),
                                 d.problem.parse_parameter({"diffusion_factor": np.ones(8)}))
    training = tb3d_mus(7, TB3D_TRAINING)
    t0 = time.perf_counter()
    res = greedy_rb(d, training, target_error=1e-8, max_extensions=TB3D_EXTENSIONS,
                    extension_algorithm="gram_schmidt", error_norm="h1_semi",
                    use_estimator="riesz", coercivity=alpha, solver_options=opts)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    rm = res.reduced_model
    online = res.estimator.offline(res.basis)
    effectivities = []
    for mu in tb3d_mus(23, 5):
        u = d.solve(mu, opts)
        c = rm.solve(mu)
        e = u - rm.reconstruct(c)
        err = float(torch.sqrt(torch.clamp(e @ d.freeze_operator(mu).matvec(e), min=0.0)))
        eta = online.estimate(mu, c)
        if not 0.99 * err <= eta <= 10.0 * err:
            raise AssertionError(f"certification: err {err:.3e}, eta {eta:.3e}")
        effectivities.append(eta / err)

    sweep = tb3d_mus(29, TB3D_ONLINE_MUS)
    stacked = stack_parameters(d.problem, sweep)
    coercivities = np.asarray([float(alpha(d.problem.parse_parameter(mu))) for mu in sweep])
    batched_reduced_solve(rm, stacked)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C = batched_reduced_solve(rm, stacked)
    etas = batched_estimates(online, rm, stacked, coercivities)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    loop_C = torch.stack([rm.solve(mu) for mu in sweep[:16]])
    loop_eta = np.asarray([online.estimate(mu, rm.solve(mu)) for mu in sweep[:16]])
    rel_C = ((C[:16] - loop_C).abs().max() / loop_C.abs().max()).item()
    rel_eta = float(np.abs(etas[:16] - loop_eta).max() / np.abs(loop_eta).max())
    log("thermalblock_3d_riesz", dofs=d.space.num_dofs, extensions=res.extensions,
        max_estimates=repr([float(f"{e:.6e}") for e in res.max_errors]),
        greedy_seconds=f"{greedy_s:.2f}",
        effectivities=repr([round(v, 4) for v in effectivities]),
        online_mus=TB3D_ONLINE_MUS, online_us_per_mu=f"{sweep_s / TB3D_ONLINE_MUS * 1e6:.2f}",
        rel_diff_batched_vs_loop_solve=f"{rel_C:.3e}",
        rel_diff_batched_vs_loop_estimate=f"{rel_eta:.3e}",
        seconds=f"{time.perf_counter() - t_phase:.2f}", card=repr(card()))
    if not (rel_C <= 1e-10 and np.allclose(etas[:16], loop_eta, rtol=1e-3,
                                           atol=2e-3 * loop_eta.max())
            and np.isfinite(etas).all()):
        raise AssertionError(f"batched vs loop: solve {rel_C:.3e}, estimate {rel_eta:.3e}")


def phase_tensor_mor_batch(dev):
    """The TensorCG cases of the reference's batched-online tests on the 2D
    thermalblock: at 8x8 cells the batched reduced solves and Riesz
    estimates (without and with min-theta coercivity) equal the per-mu loop,
    and the estimator greedy's scores decrease; at 12x12 the Riesz bound
    certifies the mu-energy error within [0.99, 10]."""
    from dune_hdd_tpu_torch.discretizations import TensorCGDiscretization
    from dune_hdd_tpu_torch.grid.tensor import tensor_grid
    from dune_hdd_tpu_torch.mor import RBReductor, RieszResidualEstimator, greedy_rb
    from dune_hdd_tpu_torch.mor import min_theta_coercivity
    from dune_hdd_tpu_torch.mor.batch import (
        batched_estimates, batched_reduced_solve, stack_parameters)
    from dune_hdd_tpu_torch.mor.greedy import _extend
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    t0 = time.perf_counter()
    out = {}
    for cells, seed, count, opts in ((8, 11, 7, TENSOR_CG_OPTS),
                                     (12, 3, 8, dict(TENSOR_CG_OPTS, precision=1e-13,
                                                     max_iter=30000))):
        d = TensorCGDiscretization(tensor_grid((0.0, 0.0), (1.0, 1.0), (cells, cells)), None,
                                   ThermalblockProblem((2, 2)), device=dev)
        rng = np.random.default_rng(seed)
        mus = [{"diffusion_factor": 10 ** rng.uniform(-1, 1, 4)} for _ in range(count)]
        basis = torch.zeros((0, d.space.num_dofs), dtype=torch.float64, device=dev)
        for mu in mus[:3]:
            basis = _extend(basis, d.solve(mu, opts), "gram_schmidt", d.product_matrix("h1_semi"))
        rm = RBReductor(d).reduce(basis)
        alpha = min_theta_coercivity(d.get_operator(), d.problem.parse_parameter(
            mus[0] if cells == 8 else {"diffusion_factor": np.ones(4)}))
        if cells == 8:
            stacked = stack_parameters(d.problem, mus)
            C = batched_reduced_solve(rm, stacked)
            loop = torch.stack([rm.solve(mu) for mu in mus])
            out["solve"] = ((C - loop).abs().max() / loop.abs().max()).item()
            for name, coerc in (("estimate", None), ("estimate_coercivity", alpha)):
                online = RieszResidualEstimator(d, product="h1_semi",
                                                coercivity=coerc).offline(basis)
                cs = (None if coerc is None else
                      np.asarray([float(coerc(d.problem.parse_parameter(mu))) for mu in mus]))
                etas = batched_estimates(online, rm, stacked, cs)
                refs = np.asarray([online.estimate(mu, rm.solve(mu)) for mu in mus])
                # the reference test's bar: eta ~ 0 at the snapshot mu is a
                # cancellation of O(1) Gramian terms in both paths
                if not np.allclose(etas, refs, rtol=1e-3, atol=2e-3 * refs.max()):
                    raise AssertionError(f"{name}: batched {etas}, loop {refs}")
                out[name] = float(np.abs(etas - refs).max() / refs.max())
            res = greedy_rb(d, mus, target_error=1e-10, max_extensions=4, use_estimator=True,
                            solver_options=opts)
            errs = [e for e in res.max_errors if e >= 0]
            if not (len(errs) >= 2 and errs[-1] < errs[0] and np.isfinite(res.max_errors[0])):
                raise AssertionError(f"estimator greedy: {res.max_errors}")
            out["greedy_scores"] = [float(f"{e:.4e}") for e in res.max_errors]
        else:
            online = RieszResidualEstimator(d, product="h1_semi", coercivity=alpha).offline(basis)
            effs = []
            for mu in mus[3:]:
                u = d.solve(mu, opts)
                e = u - rm.reconstruct(rm.solve(mu))
                err = float(torch.sqrt(torch.clamp(e @ d.freeze_operator(mu).matvec(e), min=0.0)))
                eta = online.estimate(mu, rm.solve(mu))
                if not 0.99 * err <= eta <= 10.0 * err:
                    raise AssertionError(f"12x12 certification: err {err:.3e}, eta {eta:.3e}")
                effs.append(round(eta / err, 4))
            out["effectivities_12x12"] = effs
    if not out["solve"] <= 1e-10:
        raise AssertionError(f"batched vs loop: {out}")
    log("tensor_mor_batch", rel_diff_batched_vs_loop_solve=f"{out['solve']:.3e}",
        rel_diff_batched_vs_loop_estimate=f"{out['estimate']:.3e}",
        rel_diff_with_coercivity=f"{out['estimate_coercivity']:.3e}",
        greedy_scores=repr(out["greedy_scores"]),
        effectivities_12x12=repr(out["effectivities_12x12"]),
        seconds=f"{time.perf_counter() - t0:.2f}")


def count_device_ops(fn):
    """Kernels and copies one call puts on the card, from torch.profiler's
    device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def time_general_spmvs(d, mu, like):
    """Device time of the general path's two SpMVs on the frozen float64
    operator: the scalar ELL SparseMatrix.matvec (the ell_spmv kernel) and
    the block-ELL BlockEllMatrix.matvec (plain torch); bytes = values +
    column indices + x + y."""
    from dune_hdd_tpu_torch.la.block_ell import block_ell_from_sparse

    A = d.freeze_operator(mu)
    Ab = block_ell_from_sparse(d.space, A)
    gen = torch.Generator(device="cpu").manual_seed(18)
    x = torch.randn(like.shape, generator=gen, dtype=like.dtype).to(like.device)
    rel_check("BlockEllMatrix.matvec vs SparseMatrix.matvec", Ab.matvec(x), A.matvec(x), 1e-12)
    n = A.shape[0]
    cases = {"SparseMatrix.matvec": (lambda: A.matvec(x), ell_bytes(A)),
             "BlockEllMatrix.matvec": (lambda: Ab.matvec(x),
                                       Ab.blocks.numel() * 8 + Ab.neighbors.size * 8 + 2 * n * 8)}
    for name, (fn, nbytes) in cases.items():
        ms = time_calls(fn)
        log("plain_spmv_timing", op=name, dofs=n, float64=True, us=f"{ms * 1e3:.2f}",
            device_ops_per_call=count_device_ops(fn),
            bytes=nbytes, gbps=f"{nbytes / ms / 1e6:.1f}",
            bound_us=f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f}", card=repr(card()))


def main():
    from dune_hdd_tpu_torch.bench_harness import _bench_geometry
    from dune_hdd_tpu_torch.la.stencil import symmetric_planes

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_process_group()
    bench6, S6, B6, plane_err = phase_plane_vs_plain(dev)
    phase_plane_random(dev)
    phase_sym_random(dev)
    A6, b6, structured_err = phase_structured_vs_plain(dev, bench6, S6, B6)
    probe_err = phase_probe_vs_plain(dev)

    launches = {}
    r6, _, _ = phase_main_path(dev, 6, repeats=3)
    launches["structured_spmv"] = phase_alt_solvers(dev, r6["u"])
    del r6
    phase_structured_path(A6, S6, B6)
    launches["probe"] = phase_probe_path(dev)
    phase_kernel_path_vs_plain_path(dev)
    structured_ms, probe_ms, err = phase_timing_768k(dev, S6, B6, A6, b6)
    plane_err = max(plane_err, err)
    del bench6, S6, B6, A6, b6

    r, (S8, B8), _ = phase_main_path(dev, 8, repeats=3)
    sym_err = phase_symmetric_checks(S8, B8)
    del S8, B8
    phase_roofline(dev)
    phase_factored_bcr(dev, r)
    del r
    torch.cuda.empty_cache()
    phase_bench_entry()

    r, (S10, B10), _ = phase_main_path(dev, 10, repeats=3)
    slab_rows = phase_sharded_main_path(dev, r, S10, B10)
    del r
    sym_times, err = time_sym_plane_spmv(S10, B10, "12.29M")
    sym_err = max(sym_err, err)
    plane_times, err = time_plane_spmv(S10, B10, "12.29M symmetric", W=symmetric_planes(S10))
    plane_err = max(plane_err, err)
    del S10, B10
    phase_native_connectivity(dev)
    _bench_geometry.cache_clear()  # the 12.29M set-up: no later path uses it
    torch.cuda.empty_cache()

    _, err, tc, esv_solutions = phase_esv2007_study(dev)
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    phase_esv2007_cg(dev, tc)
    _, err = phase_block_esv2007_table(dev, tc, esv_solutions)
    del esv_solutions
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    higher_rows = {}
    for order in (2, 3):
        rows, err = phase_esv2007_higher(dev, tc, order)
        higher_rows.update(rows)
    phase_esv2007_cube(dev)
    phase_cg_higher(dev, tc)
    phase_interval(dev)
    phase_gmres(dev, tc)
    del tc
    torch.cuda.empty_cache()
    phase_cli(dev)
    torch.cuda.empty_cache()
    phase_tensor_eoc(dev)
    phase_thermalblock_3d(dev)
    torch.cuda.empty_cache()
    ell_rows = phase_ell_spmv(dev)
    block_jacobi_rows = phase_block_jacobi(dev)
    phase_thermalblock_3d_riesz(dev)
    phase_tensor_mor_batch(dev)
    phase_os2014_parametric(dev)
    phase_spe10_parametric_block(dev)
    torch.cuda.empty_cache()
    phase_block_provenance(dev)
    _, err, thermalblock, lattice_256_row = phase_thermalblock_online(dev)
    plane_err = max(plane_err, err)
    torch.cuda.empty_cache()
    phase_block_sharded(dev, *thermalblock)
    phase_sharded_sweeps_and_pipeline(dev, thermalblock[1])
    phase_rb_thermalblock(dev, *thermalblock)
    del thermalblock
    torch.cuda.empty_cache()
    phase_adaptive_spe10(dev)
    phase_adaptive_os2014(dev)
    phase_rb_demo(dev)
    total = sum(PATH_LATTICE_LAUNCHES.values())
    log("done", seconds=f"{time.perf_counter() - _T0:.1f}",
        plane_spmv_launches=repr(dict(PATH_LAUNCHES)),
        sym_plane_spmv_launches=repr(dict(SYM_PATH_LAUNCHES)))
    for key, n in PATH_LATTICE_LAUNCHES.most_common():
        log("plane_spmv_launches", case=repr(key), launches=n, share=f"{n / total:.4f}")
    for key, n in SYM_PATH_LATTICE_LAUNCHES.most_common():
        log("sym_plane_spmv_launches", case=repr(key), launches=n)

    rows = {"plane_spmv_nd3_f32": (dict(plane_times["float32"],
                                        launches=PATH_LAUNCHES["nd3_f32"]), plane_err),
            "plane_spmv_nd3_f64": (dict(plane_times["float64"],
                                        launches=PATH_LAUNCHES["nd3_f64"]), plane_err),
            "plane_spmv_nd3_f64_256x256": (dict(lattice_256_row,
                                                launches=PATH_LATTICE_LAUNCHES["nd3_f64 256x256"]),
                                           plane_err),
            "structured_spmv": (dict(structured_ms, launches=launches["structured_spmv"]),
                                structured_err),
            "probe": (dict(probe_ms, launches=launches["probe"]), probe_err),
            "sym_plane_spmv_nd3_f32": (dict(sym_times["float32"],
                                            launches=SYM_PATH_LAUNCHES["nd3_f32"]), sym_err),
            "sym_plane_spmv_nd3_f64": (dict(sym_times["float64"],
                                            launches=SYM_PATH_LAUNCHES["nd3_f64"]), sym_err),
            **higher_rows, **slab_rows}
    rows.update({name: r for name, r in {**ell_rows, **block_jacobi_rows}.items()
                 if "launches" in r[0]})
    for name, (row, _) in rows.items():
        if not row["launches"] > 0:
            raise AssertionError(f"{name}: no launch on its path")
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=KERNELS[kernel_of(name)][0],
        replaces=KERNELS[kernel_of(name)][1], max_abs_err=err, **row)
        for name, (row, err) in rows.items()]}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def kernel_of(row: str) -> str:
    """The KERNELS entry of a kernels-line row: the longest name it starts
    with."""
    return max((k for k in KERNELS if row.startswith(k)), key=len)


def main_sharded():
    """``--sharded``: build the plane SpMV and run the sharded layer's phases
    with the paths they follow (the 12.29M main path, one timed call; the
    1.57M thermalblock's online solves), then the process group and the
    native connectivity."""
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(("plane_spmv", "sym_plane_spmv"))
    phase_process_group()
    r, (S10, B10), _ = phase_main_path(dev, 10, repeats=1)
    phase_sharded_main_path(dev, r, S10, B10)
    phase_sharded_operator_gap(dev, r, S10, B10)
    del r, S10, B10
    phase_native_connectivity(dev)
    torch.cuda.empty_cache()
    _, _, thermalblock, _ = phase_thermalblock_online(dev, count=PIPELINE_MUS)
    phase_block_sharded(dev, *thermalblock)
    phase_sharded_sweeps_and_pipeline(dev, thermalblock[1])
    print(card())


def main_symmetric():
    """``--symmetric``: build both plane SpMVs and run the half-storage
    kernel's phases with the paths they follow (the 3.07M and 12.29M main
    paths, one timed call each; the roofline, the bench entry, the 12.29M
    timing and sharded solve, the RB demo)."""
    from dune_hdd_tpu_torch.bench_harness import _bench_geometry

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(("plane_spmv", "sym_plane_spmv"))
    phase_sym_random(dev)
    r, (S8, B8), _ = phase_main_path(dev, 8, repeats=1)
    phase_symmetric_checks(S8, B8)
    del r, S8, B8
    phase_roofline(dev)
    _bench_geometry.cache_clear()
    torch.cuda.empty_cache()
    phase_bench_entry()
    r, (S10, B10), _ = phase_main_path(dev, 10, repeats=1)
    phase_sharded_main_path(dev, r, S10, B10)
    del r
    time_sym_plane_spmv(S10, B10, "12.29M")
    del S10, B10
    _bench_geometry.cache_clear()
    torch.cuda.empty_cache()
    phase_rb_demo(dev)
    log("done", seconds=f"{time.perf_counter() - _T0:.1f}",
        sym_plane_spmv_launches=repr(dict(SYM_PATH_LAUNCHES)))
    print(card())


def main_ell_spmv():
    """``--ell-spmv``: build the scalar-ELL SpMV and run its phase only
    (the 3D and SWIPDG operators, the 3D solve), then the kernels line."""
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(("ell_spmv",))
    rows = phase_ell_spmv(dev)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=KERNELS["ell_spmv"][0], replaces=KERNELS["ell_spmv"][1],
        max_abs_err=err, **row) for name, (row, err) in rows.items()]}))
    print(card())


def main_block_jacobi():
    """``--block-jacobi``: build the block-Jacobi apply and run its phase
    only (the shapes, the snapshot solve), then the kernels line."""
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(("block_jacobi",))
    rows = phase_block_jacobi(dev)
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=KERNELS["block_jacobi"][0],
        replaces=KERNELS["block_jacobi"][1], max_abs_err=err, **row)
        for name, (row, err) in rows.items()]}))
    print(card())


def main_plane_rows():
    """``--plane-rows``: build plane_spmv and time it at PLANE_ROWS only
    (kernel against bound; ``--library`` adds the plain and BSR times)."""
    phase_device()
    phase_build(("plane_spmv",))
    plane_rows(torch.device("cuda", 0), library="--library" in sys.argv)
    print(card())


def main_alt_solvers():
    """``--alt-solvers``: build the plane and structured SpMVs and run the
    alternate solvers' phases with the main paths they follow (768k, then
    3.07M DoF, one timed call each)."""
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build(("plane_spmv", "structured_spmv", "sym_plane_spmv"))
    r6, _, _ = phase_main_path(dev, 6, repeats=1)
    phase_alt_solvers(dev, r6["u"])
    del r6
    r8, _, _ = phase_main_path(dev, 8, repeats=1)
    phase_factored_bcr(dev, r8)
    print(card())


if __name__ == "__main__":
    if "--plane-rows" in sys.argv:
        main_plane_rows()
    elif "--ell-spmv" in sys.argv:
        main_ell_spmv()
    elif "--block-jacobi" in sys.argv:
        main_block_jacobi()
    elif "--alt-solvers" in sys.argv:
        main_alt_solvers()
    elif "--sharded" in sys.argv:
        main_sharded()
    elif "--symmetric" in sys.argv:
        main_symmetric()
    else:
        main()
