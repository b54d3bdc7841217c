"""Multi-process run of the PyTorch port's sharded layer (parallel/
distributed.py and the collectives' torch.distributed legs): 2 and 4 OS
processes x 2 CPU shards, a gloo process group on a free localhost port.

Each worker (this file run as a script) asserts that
``initialize_distributed()`` picks up MASTER_ADDR / MASTER_PORT /
WORLD_SIZE / RANK, that a mesh built afterwards spans the processes along
"domain" (2 shards each), that a global ``psum`` equals the host sum, that
``all_gather`` returns the whole array, and that a ``ppermute`` ring
crossing the process boundary equals ``np.roll``; then that on such a mesh
the x-slab matvec is bitwise the single-shard ``plane_spmv`` and the halo
solve bitwise the all-gather solve, both at the direct solve's 1e-8.
Mirrors the reference's
tests/test_distributed.py (jax.distributed with gloo); the 4-process case is
the same program at the width of a 4-card host.  The ``cuda`` case runs one
process per card with 2 CUDA shards each, so the torch.distributed legs go
through NCCL (it skips below 2 cards; on a 4-card host: ``python -m pytest
--noconftest -m cuda tests/test_torch_distributed.py``).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(nproc: int, local: int, shard_device: str):
    """Starts ``nproc`` workers (this file as a script) on one process group
    and asserts that each exits 0 and reports OK."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(nproc), RANK=str(rank), GLOO_SOCKET_IFNAME="lo",
                   NCCL_SOCKET_IFNAME="lo",
                   LOCAL_SHARDS=str(local), SHARD_DEVICE=shard_device)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__)], env=env,
                                      cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
        assert "OK" in out, out


def test_two_process_distributed_mesh():
    pytest.importorskip("torch")
    _run_workers(2, 2, "cpu")


def test_four_process_distributed_mesh():
    pytest.importorskip("torch")
    _run_workers(4, 2, "cpu")


@pytest.mark.cuda
def test_nccl_mesh_across_cards():
    torch = pytest.importorskip("torch")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs")
    _run_workers(torch.cuda.device_count(), 2, "cuda")


def _worker():
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from dune_hdd_tpu_torch.parallel import (
        initialize_distributed, is_distributed, make_device_mesh, process_info)
    from dune_hdd_tpu_torch.parallel.collectives import all_gather, ppermute, psum

    nproc, local = int(os.environ["WORLD_SIZE"]), int(os.environ["LOCAL_SHARDS"])
    if os.environ["SHARD_DEVICE"] == "cuda":  # one card per process: NCCL's rule
        device = torch.device("cuda", int(os.environ["RANK"]))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    assert initialize_distributed(), "the environment's process group must engage"
    info = process_info()
    assert info["process_count"] == nproc, info
    assert is_distributed()
    mesh = make_device_mesh(1, local, devices=[device] * local)
    n = mesh.shape["domain"]
    assert n == nproc * local, mesh
    span, offset = mesh.axis_span("domain"), mesh.axis_offset("domain")

    full = np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3)
    shards = [torch.as_tensor(full[(offset + i) * 4:(offset + i + 1) * 4]).to(device)
              for i in range(local)]
    for got in psum([s.sum() for s in shards], span):
        assert abs(float(got) - float(full.sum())) <= 1e-3 * float(full.sum()), got
    for got in all_gather(shards, tiled=True, span=span):
        np.testing.assert_array_equal(got.cpu().numpy(), full)

    # a ring shift of per-shard constants across the process boundary
    vals = [torch.full((1,), float(offset + i), device=device) for i in range(local)]
    ring = ppermute(vals, [(i, (i + 1) % n) for i in range(n)], span)
    want = np.roll(np.arange(n, dtype=np.float32), 1)
    for i, got in enumerate(ring):
        np.testing.assert_array_equal(got.cpu().numpy(), want[offset + i:offset + i + 1])
    _sharded_paths(mesh, device)
    dist.destroy_process_group()
    print(f"proc {info['process_index']}/{nproc} OK (shards {n} on {device.type})", flush=True)


def _sharded_paths(mesh, device):
    """The x-slab matvec and the row-split and halo solves on a mesh that
    spans the processes: the slab matvec bitwise the single-shard SpMV, the
    halo solve bitwise the all-gather solve, both within 1e-8 of the direct
    solve (every process builds the same inputs)."""
    import torch

    from dune_hdd_tpu_torch.discretizations import SWIPDGDiscretization
    from dune_hdd_tpu_torch.grid.structured import alu_cube_grid
    from dune_hdd_tpu_torch.grid.structured_order import structured_cell_order
    from dune_hdd_tpu_torch.kernels.plane_spmv import plane_spmv
    from dune_hdd_tpu_torch.la.stencil import StencilBlockEll, stencil_plan
    from dune_hdd_tpu_torch.la.stencil_sharded import ShardedStencilSystem
    from dune_hdd_tpu_torch.parallel import HaloShardedSystem, ShardedAffineSystem
    from dune_hdd_tpu_torch.parallel.collectives import all_gather
    from dune_hdd_tpu_torch.problems import ThermalblockProblem

    n = mesh.shape["domain"]
    grid = alu_cube_grid((0.0, 0.0), (5.0, 1.0), (100, 20), refinements=2)
    plan = stencil_plan(structured_cell_order(grid, (0.0, 0.0), (5.0, 1.0)))
    rng = np.random.default_rng(5)
    lattice = (20, 16 * n)  # slabs of 16 columns (a multiple of 4 for the kernel)
    W = torch.as_tensor(rng.standard_normal((4, 3, 3, 8) + lattice)).to(device)
    X = torch.as_tensor(rng.standard_normal((3, 8) + lattice)).to(device)
    system = ShardedStencilSystem(StencilBlockEll(W, plan), X, mesh)
    ys = system._matvec_local(system.planes, system._split(X))
    y = torch.cat(all_gather(ys, span=system.span)[0].unbind(0), dim=-1)
    assert torch.equal(y, plane_spmv(W, X, plan))

    d = SWIPDGDiscretization(alu_cube_grid((0, 0), (1, 1), (4, 4), refinements=2),
                             {"type": "stuff.grid.boundaryinfo.alldirichlet"},
                             ThermalblockProblem((2, 2)), device=device, only_these_products=())
    mu = {"diffusion_factor": np.array([0.1, 1.0, 0.5, 2.0])}
    u_ag = ShardedAffineSystem(d.get_operator(), d.get_rhs(), mesh, dtype=torch.float64).solve(
        mu, tol=1e-12, maxiter=5000)
    u_halo = HaloShardedSystem(d.get_operator(), d.get_rhs(), mesh, dtype=torch.float64).solve(
        mu, tol=1e-12, maxiter=5000)
    assert torch.equal(u_ag, u_halo)
    u_ref = d.solve(mu, options={"type": "direct"})
    assert float((u_halo - u_ref).abs().max()) <= 1e-8


if __name__ == "__main__":
    _worker()
