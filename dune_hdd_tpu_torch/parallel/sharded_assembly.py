"""Per-shard assembly of the BlockSWIPDG operator values.

Counterpart of ``dune_hdd_tpu/parallel/sharded_assembly.py``.  The reference
assembles per-subdomain local systems in two sweeps, a pattern sweep and a
value sweep (block-swipdg.hh:262-551).  Here the pattern sweep stays on the
host (the index plan) and the value sweep runs per shard of the "domain"
axis: each shard evaluates the volume and face kernels of the port's
``ops/`` for the cells and faces of its own rows (a face between two shards
is evaluated on both: computation instead of communication) and assembles
its row block of every affine component's ELL values.

Bitwise equal to the host assembly: a shard's raw entries of its own rows
are those of the global raw list (volume, interior-face, Dirichlet-face
entries), and each of its matrix slots sums them through the same row of
the pattern's sorted segment table (``SparsityPattern.seg_table``, the same
width), so every slot adds the same addends in the same order.  No atomics.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..ops.assembly import cell_quadrature, cell_shape_gradients, elliptic_cells_core
from ..ops.swipdg import swipdg_face_blocks, swipdg_pattern

__all__ = ["sharded_operator_values", "ShardedAssemblyPlan", "build_assembly_plan"]


class ShardedAssemblyPlan(NamedTuple):
    """Host-built per-shard value-sweep plan (lists over the shards)."""

    cells: List[np.ndarray]      # global cell ids with a DoF row of the shard, ascending
    fi: List[np.ndarray]         # interior faces touching those cells
    fb: List[np.ndarray]         # Dirichlet faces of those cells
    seg_table: List[np.ndarray]  # [nnz_d, width] shard raw-entry index per slot (pad: E_d)
    slot_pos: List[np.ndarray]   # [nnz_d] flat position in the shard's [L * K] values
    L: int                       # rows per shard (padded)
    K: int                       # ELL width


def build_assembly_plan(space, pattern, row_blocks: Sequence[np.ndarray],
                        interior: np.ndarray, dirichlet: np.ndarray) -> ShardedAssemblyPlan:
    grid = space.grid
    dofs = space.cell_dofs
    nd = dofs.shape[1]
    n = space.num_dofs
    K = pattern.ell_width
    L = max(len(b) for b in row_blocks)
    owner = np.full(n, -1, dtype=np.int64)
    local_row = np.zeros(n, dtype=np.int64)
    for d, rows in enumerate(row_blocks):
        owner[rows] = d
        local_row[rows] = np.arange(len(rows))
    fi_all, fb_all = np.asarray(interior), np.asarray(dirichlet)
    cell_owner = owner[dofs[:, 0]]  # DG: all DoFs of a cell share a shard
    # the global raw list: every cell's nd^2 volume entries, then 4 nd^2
    # per interior face, then nd^2 per Dirichlet face
    base_fi = grid.num_cells * nd * nd
    base_fb = base_fi + len(fi_all) * 4 * nd * nd
    table = pattern.seg_table
    slot_owner = owner[pattern.slot_rows]
    cells_d, fi_d, fb_d, tables, positions = [], [], [], [], []
    for d in range(len(row_blocks)):
        cells = np.nonzero(cell_owner == d)[0]
        mi = np.nonzero((cell_owner[grid.face_cells[fi_all, 0]] == d)
                        | (cell_owner[grid.face_cells[fi_all, 1]] == d))[0]
        mb = np.nonzero(cell_owner[grid.face_cells[fb_all, 0]] == d)[0]
        raw_global = np.concatenate([
            (cells[:, None] * nd * nd + np.arange(nd * nd)).reshape(-1),
            (base_fi + mi[:, None] * 4 * nd * nd + np.arange(4 * nd * nd)).reshape(-1),
            (base_fb + mb[:, None] * nd * nd + np.arange(nd * nd)).reshape(-1)])
        shard_of = np.full(pattern.num_raw + 1, -1, dtype=np.int64)
        shard_of[raw_global] = np.arange(len(raw_global))
        shard_of[pattern.num_raw] = len(raw_global)  # the appended zero
        slots = np.nonzero(slot_owner == d)[0]
        t = shard_of[table[slots]]
        if (t < 0).any():
            raise AssertionError(f"shard {d}: a raw entry of its rows lies outside its sweep")
        rows = pattern.slot_rows[slots].astype(np.int64)
        pos = local_row[rows] * K + (pattern.slot_ell_pos[slots] - rows * K)
        cells_d.append(cells)
        fi_d.append(fi_all[mi])
        fb_d.append(fb_all[mb])
        tables.append(t)
        positions.append(pos)
    return ShardedAssemblyPlan(cells_d, fi_d, fb_d, tables, positions, L, K)


def sharded_operator_values(discretization, mesh, row_blocks: Sequence[np.ndarray],
                            dtype=torch.float32) -> List[torch.Tensor]:
    """Per local shard of the mesh's "domain" axis, the [Q, L, K] ELL values
    of every operator component (``with_expanded_affine_part`` order, as
    ``HaloShardedSystem`` stores them), assembled from that shard's cells
    and faces.

    ``discretization``: the global SWIPDGDiscretization, whose
    ``_operator_kernels`` record each component's kernel.  The kernels run
    on the discretization's device; each shard's values are then placed on
    the shard's device."""
    space = discretization.space
    nd = space.shape_count
    interior = discretization._interior_faces
    dirichlet = discretization._dirichlet_faces
    pattern = swipdg_pattern(space, interior, dirichlet)
    if len(row_blocks) != mesh.shape["domain"]:
        raise ValueError(f"{len(row_blocks)} row blocks for {mesh.shape['domain']} shards")
    plan = build_assembly_plan(space, pattern, row_blocks, interior, dirichlet)
    kernels = discretization._operator_kernels

    qorders_vol, qorders_face = set(), set()
    for ker in kernels:
        lam_fn = ker["lam_fn"]
        wlam = ker["face_kw"].get("weight_lam_fn") or lam_fn
        qorders_face.add(2 * space.order + max(lam_fn.order, wlam.order) + 1)
        if ker["volume"]:
            qorders_vol.add(lam_fn.order + ker["kap_fn"].order + 2 * (space.order - 1) + 2)
    if len(qorders_face) != 1:
        raise NotImplementedError(f"components with mixed face quadrature orders: {qorders_face}")
    if len(qorders_vol) > 1:
        # one volume order keeps the sweep bitwise equal to the host path
        raise NotImplementedError(
            f"components with mixed volume quadrature orders: {qorders_vol}")
    qorder_vol = qorders_vol.pop() if qorders_vol else 2
    qp, qw = cell_quadrature(space.grid, qorder_vol, space.device, space.dtype)
    grads = cell_shape_gradients(space, qorder_vol)

    offset = mesh.axis_offset("domain")
    devices = mesh.axis_devices("domain")
    out = []
    for g, device in zip(range(offset, offset + len(devices)), devices):
        cells = torch.as_tensor(plan.cells[g]).to(space.device)
        table = torch.as_tensor(plan.seg_table[g]).to(space.device)
        pos = torch.as_tensor(plan.slot_pos[g]).to(space.device)
        comps = []
        for ker in kernels:
            if ker["volume"]:
                vol = elliptic_cells_core(qp[cells], qw[cells], grads[cells], ker["lam_fn"],
                                          ker["kap_fn"])
            else:
                vol = qp.new_zeros((len(plan.cells[g]), nd, nd))
            ib, bb = swipdg_face_blocks(space, ker["lam_fn"], ker["kap_fn"], plan.fi[g],
                                        plan.fb[g], **ker["face_kw"])
            raw = torch.cat([vol.reshape(-1), ib.reshape(-1), bb.reshape(-1), vol.new_zeros(1)])
            flat = raw.new_zeros(plan.L * plan.K)
            flat[pos] = raw[table].sum(dim=1)
            comps.append(flat.reshape(plan.L, plan.K))
        out.append(torch.stack(comps).to(device=device, dtype=dtype))
    return out
