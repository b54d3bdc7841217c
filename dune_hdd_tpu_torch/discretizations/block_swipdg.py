"""BlockSWIPDG: domain-decomposed SWIPDG with the LRBMS surface.

Counterpart of ``dune_hdd_tpu/discretizations/block_swipdg.py``.  The global
system of the block discretization equals the single-domain SWIPDG system
for every partitioning, so the global operator and rhs are those of a
``SWIPDGDiscretization`` on the full grid (and ``uncached_solve`` runs its
solvers, ``stencil_cg`` on the ``plane_spmv`` kernel and ``block_cg``
included), while the LRBMS surface exposes the decomposition:

* ``num_subdomains`` / ``neighbouring_subdomains`` / ``subgrid``;
* ``localize_vector`` / ``globalize_vectors`` (DG DoFs partition by cells);
* ``local_discretization`` (all-Neumann artificial boundary, zero boundary
  data) and ``get_local_product``;
* ``get_local_operator`` / ``get_local_rhs``: SWIPDG on the subgrid with the
  true boundary faces of the subdomain, one build per subdomain serving both;
* ``get_coupling_operator(ss, nn)``: the four coupling blocks of the pair's
  faces, oriented ss -> nn, one SparsityPattern per block shared by all
  affine components;
* ``get_oversampled_discretization`` and ``solve_for_local_correction``
  (online enrichment on a BFS-grown patch).

Per-subdomain payloads are built lazily on ``device`` and cached.
``as_sharded`` lays the affine system out on a device mesh, the subdomains
becoming the mesh's "domain" axis (``parallel/halo.py``,
``parallel/sharded.py``, ``parallel/sharded_assembly.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..affine import AffineDecomposition
from ..functions.base import freeze_function
from ..grid.boundaryinfo import BoundaryInfo, make_boundary_info
from ..grid.multiscale import MultiscaleGrid, Subgrid, extract_subgrid
from ..grid.structured import Grid
from ..la.solvers import solve as la_solve
from ..la.sparse import SparseMatrix, build_pattern
from ..ops.assembly import diffusion_pairs, face_quadrature, scatter_cell_vectors
from ..ops.swipdg import _side_quantities, swipdg_face_blocks
from ..problems.interfaces import Problem
from ..problems.zero_boundary import ZeroBoundaryProblem
from .base import StationaryDiscretization
from .cg import _parts
from .swipdg import SWIPDGDiscretization

__all__ = ["BlockSWIPDGDiscretization", "CouplingOperator"]

_BLOCKS = ("in_in", "in_out", "out_in", "out_out")


@dataclass(frozen=True, eq=False)
class CouplingOperator:
    """The four coupling blocks of a neighbour pair (in = ss, out = nn).
    Scalar ``*`` and ``+`` act block by block, so an AffineDecomposition of
    CouplingOperators freezes like one of matrices."""

    in_in: SparseMatrix
    in_out: SparseMatrix
    out_in: SparseMatrix
    out_out: SparseMatrix

    def __mul__(self, scalar) -> "CouplingOperator":
        return CouplingOperator(*(getattr(self, b) * scalar for b in _BLOCKS))

    __rmul__ = __mul__

    def __add__(self, other) -> "CouplingOperator":
        if not isinstance(other, CouplingOperator):
            return NotImplemented
        return CouplingOperator(*(getattr(self, b) + getattr(other, b) for b in _BLOCKS))


class BlockSWIPDGDiscretization(StationaryDiscretization):
    static_id = "hdd.linearelliptic.discretizations.block-swipdg"

    def __init__(
        self,
        grid,
        boundary_info,
        problem: Problem,
        num_partitions: Sequence[int] = (2, 2),
        oversampling_layers: int = 0,
        order: int = 1,
        only_these_products: Optional[Sequence[str]] = ("l2", "h1_semi", "energy"),
        penalty_mu=None,
        scheme: Optional[str] = None,
        device="cuda",
        dtype: torch.dtype = torch.float64,
    ):
        if isinstance(grid, MultiscaleGrid):
            self.ms_grid = grid
            grid = grid.grid
        else:
            self.ms_grid = MultiscaleGrid(grid, num_partitions, oversampling_layers)
        if not isinstance(boundary_info, BoundaryInfo):
            boundary_info = make_boundary_info(grid, boundary_info)
        self._global = SWIPDGDiscretization(
            grid, boundary_info, problem, order=order, only_these_products=only_these_products,
            penalty_mu=penalty_mu, scheme=scheme, device=device, dtype=dtype)
        g = self._global
        super().__init__(space=g.space, boundary_info=g.boundary_info, problem=g.problem,
                         operator=g._operator, rhs=g._rhs, products=g._products,
                         vectors=g._vectors, purely_neumann=g.purely_neumann)
        # every local build uses the global discretization's resolved scheme
        self._local_kw = dict(order=order, penalty_mu=penalty_mu, scheme=g.scheme,
                              device=g.space.device, dtype=g.space.dtype)
        self._products_wanted = only_these_products
        self._subgrids: Dict[int, Subgrid] = {}
        self._local_discs: Dict[int, SWIPDGDiscretization] = {}
        self._local_systems: Dict[int, Tuple[AffineDecomposition, AffineDecomposition]] = {}
        self._couplings: Dict[Tuple[int, int], AffineDecomposition] = {}
        self._oversampled: Dict[Tuple[int, str], SWIPDGDiscretization] = {}

    @property
    def _scheme(self) -> str:
        return self._global.scheme

    def uncached_solve(self, mu, options=None):
        """The global SWIPDG discretization's solve, with all its solver types."""
        u = self._global.uncached_solve(mu, options)
        self.last_solve_info = self._global.last_solve_info
        return u

    # ------------------------------------------------------------------
    # LRBMS surface
    # ------------------------------------------------------------------
    def num_subdomains(self) -> int:
        return self.ms_grid.size()

    def neighbouring_subdomains(self, ss: int) -> np.ndarray:
        return self.ms_grid.neighbors_of(ss)

    def subgrid(self, ss: int) -> Subgrid:
        if ss not in self._subgrids:
            self._subgrids[ss] = extract_subgrid(self.ms_grid.grid, self.ms_grid.cells(ss))
        return self._subgrids[ss]

    def _local_dof_map(self, ss: int) -> np.ndarray:
        """[n_local_dofs] global DoF ids in local ordering."""
        nd = self.space.shape_count
        return (self.ms_grid.cells(ss)[:, None] * nd + np.arange(nd)[None, :]).reshape(-1)

    def localize_vector(self, global_vector: torch.Tensor, ss: int) -> torch.Tensor:
        """The subdomain's entries of a finite global vector."""
        global_vector = torch.as_tensor(global_vector)
        if tuple(global_vector.shape) != (self.space.num_dofs,):
            raise ValueError(f"expected a global vector of length {self.space.num_dofs}, "
                             f"got shape {tuple(global_vector.shape)}")
        if not bool(torch.isfinite(global_vector).all()):
            raise ValueError("given global vector contains NaN or Inf entries")
        idx = torch.as_tensor(self._local_dof_map(ss)).to(global_vector.device)
        return global_vector[idx]

    def globalize_vectors(self, local_vectors: Sequence[torch.Tensor]) -> torch.Tensor:
        out = torch.zeros(self.space.num_dofs, dtype=self.space.dtype, device=self.device)
        for ss, lv in enumerate(local_vectors):
            out[torch.as_tensor(self._local_dof_map(ss)).to(self.device)] = \
                torch.as_tensor(lv).to(device=self.device, dtype=out.dtype)
        return out

    def local_discretization(self, ss: int) -> SWIPDGDiscretization:
        """Per-subdomain SWIPDG with all-Neumann artificial boundary and a
        ZeroBoundary problem."""
        if ss not in self._local_discs:
            self._local_discs[ss] = SWIPDGDiscretization(
                self.subgrid(ss).grid, {"type": "stuff.grid.boundaryinfo.allneumann"},
                ZeroBoundaryProblem(self.problem), only_these_products=self._products_wanted,
                **self._local_kw)
        return self._local_discs[ss]

    def get_local_product(self, ss: int, id_: str) -> AffineDecomposition:
        return self.local_discretization(ss).get_product(id_)

    def _to_global_faces(self, sub: Subgrid) -> np.ndarray:
        """Global face id of each face of a subgrid, matched by its sorted
        vertex pair encoded as one int64 key."""
        grid = self.ms_grid.grid
        if not hasattr(self, "_gface_sorted"):
            kg = np.sort(grid.faces, axis=1).astype(np.int64)
            keys = kg[:, 0] * np.int64(grid.num_vertices) + kg[:, 1]
            order = np.argsort(keys, kind="stable")
            self._gface_sorted = (keys[order], order)
        gkeys, gorder = self._gface_sorted
        lf = np.sort(sub.vertex_map[sub.grid.faces], axis=1).astype(np.int64)
        lkeys = lf[:, 0] * np.int64(grid.num_vertices) + lf[:, 1]
        # searchsorted returns len(gkeys) past the last key: clip before reading
        pos = np.minimum(np.searchsorted(gkeys, lkeys), len(gkeys) - 1)
        missing = np.nonzero(gkeys[pos] != lkeys)[0]
        if len(missing):
            f = int(missing[0])
            raise ValueError(f"subgrid face {f} (parent vertices "
                             f"{sub.vertex_map[sub.grid.faces[f]].tolist()}) is not a face of "
                             f"the grid ({len(missing)} faces missing)")
        return gorder[pos]

    def _boundary_face_map(self, ss: int) -> Tuple[np.ndarray, np.ndarray]:
        """(local Dirichlet faces, local Neumann faces) of the subgrid that
        are global boundary faces of that type."""
        local_to_global = self._to_global_faces(self.subgrid(ss))
        dmask = self.boundary_info.dirichlet_faces[local_to_global]
        nmask = self.boundary_info.neumann_faces[local_to_global]
        return np.nonzero(dmask)[0], np.nonzero(nmask)[0]

    def _local_system(self, ss: int) -> Tuple[AffineDecomposition, AffineDecomposition]:
        """(operator, rhs) of SWIPDG on the subgrid with the subdomain's
        true boundary faces: volume, inner-face and Dirichlet-penalty terms,
        force, Neumann and Dirichlet functionals.  Artificial faces carry no
        term, as in the all-Neumann local discretization."""
        if ss not in self._local_systems:
            dfaces, nfaces = self._boundary_face_map(ss)
            sub = self.subgrid(ss).grid
            disc = SWIPDGDiscretization(sub, _FaceListBoundaryInfo(sub, dfaces, nfaces),
                                        self.problem, only_these_products=(), **self._local_kw)
            self._local_systems[ss] = (disc.get_operator(), disc.get_rhs())
        return self._local_systems[ss]

    def get_local_operator(self, ss: int) -> AffineDecomposition:
        return self._local_system(ss)[0]

    def get_local_rhs(self, ss: int) -> AffineDecomposition:
        return self._local_system(ss)[1]

    get_local_functional = get_local_rhs

    def get_coupling_operator(self, ss: int, nn: int) -> AffineDecomposition:
        """AffineDecomposition of CouplingOperators for the pair (ss, nn)."""
        key = (ss, nn)
        if key in self._couplings:
            return self._couplings[key]
        if nn not in set(self.ms_grid.neighbors_of(ss).tolist()):
            raise ValueError(f"subdomains {ss} and {nn} are not neighbours")
        grid, space = self.ms_grid.grid, self.space
        nd = space.shape_count
        faces = self.ms_grid.coupling_faces(ss, nn)
        inside_sub = self.ms_grid.subdomain_of[grid.face_cells[faces, 0]]
        cells_ss, cells_nn = self.ms_grid.cells(ss), self.ms_grid.cells(nn)
        local = (_inverse_map(cells_ss, grid.num_cells), _inverse_map(cells_nn, grid.num_cells))
        sizes = (len(cells_ss) * nd, len(cells_nn) * nd)
        # weighting diffusion of the global discretization (penalty_mu scheme
        # only; the reference scheme self-weights each component)
        wlam, wkap = self._global._weight_diffusion
        empty = np.zeros(0, dtype=np.int64)
        subsets = tuple((subset, flipped) for subset, flipped in (
            (faces[inside_sub == ss], False), (faces[inside_sub == nn], True)) if len(subset))
        out = AffineDecomposition()
        patterns: Dict[str, object] = {}
        for (lam_fn, kap_fn), coef in _parts(diffusion_pairs(self.problem)):
            if self._scheme == "reference":
                kw = {}
            else:
                # parametric components carry flux terms only; the penalty
                # appears exactly once (below)
                kw = dict(weight_lam_fn=wlam, weight_kap_fn=wkap, flux_only=coef is not None)
            blocks = [(subset, swipdg_face_blocks(space, lam_fn, kap_fn, subset, empty, **kw)[0],
                       flipped) for subset, flipped in subsets]
            mats = _assemble_coupling(blocks, grid, space, local, sizes, patterns)
            if coef is None:
                out.register_affine_part(mats)
            else:
                out.register_component(mats, coef)
        if self._scheme != "reference" and out.affine_part is None:
            # penalty-only affine part from the fixed weighting diffusion, so
            # the penalty is counted exactly once for every mu
            blocks = [(subset, swipdg_face_blocks(space, wlam, wkap, subset, empty,
                                                  penalty_only=True)[0], flipped)
                      for subset, flipped in subsets]
            out.register_affine_part(_assemble_coupling(blocks, grid, space, local, sizes,
                                                        patterns))
        self._couplings[key] = out
        return out

    def _artificial_patch_faces(self, patch: Subgrid) -> np.ndarray:
        """Boundary faces of the patch grid that are not on the true domain
        boundary (the artificial oversampling interface)."""
        on_true_boundary = self.ms_grid.grid.boundary_faces[self._to_global_faces(patch)]
        return np.nonzero(patch.grid.boundary_faces & ~on_true_boundary)[0]

    def _patch(self, ss: int) -> Subgrid:
        return extract_subgrid(self.ms_grid.grid, self.ms_grid.oversampled_cells(ss))

    def get_oversampled_discretization(self, ss: int, boundary_type: str) -> SWIPDGDiscretization:
        """Local discretization on the oversampled patch with an artificial
        "dirichlet" or "neumann" boundary."""
        key = (ss, boundary_type)
        if key not in self._oversampled:
            if self.ms_grid.oversampling_layers <= 0:
                raise ValueError("this discretization was created without oversampling")
            if boundary_type not in ("dirichlet", "neumann"):
                raise ValueError(f"unknown boundary type {boundary_type!r}")
            patch = self._patch(ss)
            disc = SWIPDGDiscretization(
                patch.grid, {"type": f"stuff.grid.boundaryinfo.all{boundary_type}"},
                ZeroBoundaryProblem(self.problem), only_these_products=("l2", "h1_semi"),
                **self._local_kw)
            disc.oversampled_patch = patch
            self._oversampled[key] = disc
        return self._oversampled[key]

    def as_sharded(self, mesh=None, dtype=None, halo: bool = True,
                   assemble_on_device: bool = False):
        """The affine system on a device mesh (default: every visible card),
        the subdomain axis becoming the mesh's "domain" axis.

        With ``halo=True`` (default) shards own whole subdomains and the SpMV
        exchanges only coupling-face DoFs by ppermute rings
        (``parallel/halo.py``, the sharded image of the coupling blocks,
        block-swipdg.hh:308-326); ``halo=False`` gives the row-split
        all-gather layout (``parallel/sharded.py``).  ``assemble_on_device``:
        each shard assembles its rows' operator values
        (``parallel/sharded_assembly.py``) instead of slicing the host
        assembly's."""
        from ..parallel.halo import HaloShardedSystem
        from ..parallel.sharded import ShardedAffineSystem, make_device_mesh

        if mesh is None:
            mesh = make_device_mesh()
        dtype = dtype or self.space.dtype
        if not halo:
            return ShardedAffineSystem(self.get_operator(), self.get_rhs(), mesh, dtype=dtype)
        row_blocks = self.subdomain_row_blocks(mesh.shape["domain"])
        ell_override = None
        if assemble_on_device:
            from ..parallel.sharded_assembly import sharded_operator_values

            ell_override = sharded_operator_values(self._global, mesh, row_blocks, dtype=dtype)
        return HaloShardedSystem(self.get_operator(), self.get_rhs(), mesh,
                                 row_blocks=row_blocks, dtype=dtype,
                                 ell_vals_override=ell_override)

    def subdomain_row_blocks(self, n_devices: int):
        """Global DoF rows in ``n_devices`` blocks of whole subdomains
        (balanced by DoF count, contiguous in subdomain id so neighbouring
        subdomains share a shard where they can); with more shards than
        subdomains, the subdomain-ordered DoFs split further."""
        S = self.num_subdomains()
        if n_devices <= S:
            sizes = np.asarray([len(self._local_dof_map(ss)) for ss in range(S)], dtype=np.int64)
            csum = np.cumsum(sizes)
            total = int(csum[-1])
            # subdomain ss -> shard floor(csum_mid / (total / n_devices)),
            # then repaired so every shard gets at least one subdomain
            bounds = np.searchsorted(csum - sizes // 2,
                                     np.arange(1, n_devices) * total / n_devices)
            bounds = np.clip(bounds, 1, S - 1)
            for i in range(1, len(bounds)):  # strictly increasing
                bounds[i] = max(bounds[i], bounds[i - 1] + 1)
            # the forward repair can push bounds past S - 1 for skewed sizes
            # (e.g. [1, ..., 1, 1000]); clamp from the top so every trailing
            # shard keeps at least one subdomain
            for i in range(len(bounds) - 1, -1, -1):
                bounds[i] = min(bounds[i], S - (len(bounds) - i))
            groups = np.split(np.arange(S), bounds)
            return [np.concatenate([self._local_dof_map(ss) for ss in g]) for g in groups]
        ordered = np.concatenate([self._local_dof_map(ss) for ss in range(S)])
        return [np.asarray(c) for c in np.array_split(ordered, n_devices)]

    def solve_for_local_correction(self, local_vectors, subdomain: int, mu=None,
                                   options=None) -> torch.Tensor:
        """Online enrichment: solve the local defect equation on the
        oversampled patch of ``subdomain`` (zero Dirichlet data at its
        artificial boundary, cancelled by the discrete Dirichlet functional
        of the current solution there) and return the correction restricted
        to the subdomain.  Needs oversampling_layers > 0."""
        if self.ms_grid.oversampling_layers <= 0:
            raise ValueError("online enrichment needs oversampling_layers > 0")
        S = self.num_subdomains()
        if len(local_vectors) != S:
            raise ValueError(f"expected {S} local vectors, got {len(local_vectors)}")
        u = self.globalize_vectors(local_vectors)
        if not bool(torch.isfinite(u).all()):
            raise ValueError("local_vectors contain NaN or Inf entries")
        mu_p = self.problem.parse_parameter(mu) if mu is not None else {}
        patch = self._patch(subdomain)
        patch_disc = SWIPDGDiscretization(
            patch.grid, {"type": "stuff.grid.boundaryinfo.alldirichlet"}, self.problem,
            only_these_products=(), **self._local_kw)
        nd = self.space.shape_count
        patch_dofs = (patch.cell_map[:, None] * nd + np.arange(nd)[None, :]).reshape(-1)
        u_patch = u[torch.as_tensor(patch_dofs).to(u.device)]
        A = patch_disc.freeze_operator(mu_p)
        b = patch_disc.freeze_rhs(mu_p) - A.matvec(u_patch)
        # the patch's weak zero-Dirichlet penalties act on u at the
        # artificial interface, which is not part of the local residual:
        # take the current solution as Dirichlet data there
        artificial = self._artificial_patch_faces(patch)
        if len(artificial):
            b = b + _discrete_dirichlet_functional(patch_disc, artificial, u_patch, mu_p)
        delta_patch = la_solve(A, b, options or {"type": "direct"})
        pos_in_patch = np.searchsorted(patch.cell_map, self.ms_grid.cells(subdomain))
        local_dofs = (pos_in_patch[:, None] * nd + np.arange(nd)[None, :]).reshape(-1)
        return delta_patch[torch.as_tensor(local_dofs).to(delta_patch.device)]


def _discrete_dirichlet_functional(disc: SWIPDGDiscretization, faces: np.ndarray,
                                   u: torch.Tensor, mu_p) -> torch.Tensor:
    """The SWIPDG Dirichlet-data functional L_g(v) = int_e g (pen v - tau
    grad v . n) with g the discrete function u on the given boundary faces."""
    space = disc.space
    grid = space.grid
    problem = disc.problem
    frozen = problem.with_mu(mu_p) if problem.parametric() else problem
    lam = freeze_function(frozen.diffusion_factor)
    kap = freeze_function(frozen.diffusion_tensor)
    if disc.scheme == "reference":
        # boundary penalty and flux are linear in the diffusion: the frozen
        # per-component sum equals the mu-frozen self-weighted form
        wlam, wkap = lam, kap
    else:
        wlam, wkap = disc._weight_diffusion
    qorder = 2 * space.order + max(lam.order, wlam.order) + 1
    qp, qw = face_quadrature(grid, qorder, space.device, space.dtype, faces)
    n = space.tensor(grid.face_normals[faces])
    h = space.tensor(grid.face_volumes[faces])
    cin = grid.face_cells[faces, 0]
    vals, flux, delta = _side_quantities(space, cin, qp, lam, kap, wlam, wkap, n)
    u_loc = u[space.tensor(space.cell_dofs[cin])]  # [F, nd]
    g = torch.einsum("fki,fi->fk", vals, u_loc)  # discrete u at the face points
    pen = disc.sigma_boundary * delta / (h[:, None] ** disc.beta)
    local = torch.einsum("fk,fki->fi", qw * pen * g, vals)
    local = local - torch.einsum("fk,fki->fi", qw * g, flux)
    return scatter_cell_vectors(local, space.cell_dofs[cin], space.num_dofs)


class _FaceListBoundaryInfo(BoundaryInfo):
    def __init__(self, grid: Grid, dirichlet_faces: np.ndarray, neumann_faces: np.ndarray):
        d = np.zeros(grid.num_faces, dtype=bool)
        n = np.zeros(grid.num_faces, dtype=bool)
        d[np.asarray(dirichlet_faces, dtype=np.int64)] = True
        n[np.asarray(neumann_faces, dtype=np.int64)] = True
        super().__init__(grid, d, n)


def _inverse_map(cell_ids: np.ndarray, num_cells: int) -> np.ndarray:
    inv = np.full(num_cells, -1, dtype=np.int64)
    inv[cell_ids] = np.arange(len(cell_ids))
    return inv


def _assemble_coupling(blocks_list, grid, space, local, sizes, patterns) -> CouplingOperator:
    """Per-face 2x2 blocks [F, 2, 2, nd, nd] -> the four rectangular
    coupling matrices; ``flipped`` subsets have inside = nn, so their (s, t)
    indices swap.  ``patterns`` (a dict shared by the affine components of
    one pair) keeps one SparsityPattern per block: the components then sum
    slot by slot."""
    nd = space.shape_count
    local_ss, local_nn = local
    n_ss, n_nn = sizes
    entries = {k: ([], [], []) for k in _BLOCKS}
    for subset, blocks, flipped in blocks_list:
        cin, cout = grid.face_cells[subset, 0], grid.face_cells[subset, 1]
        if not flipped:
            cells_ss, cells_nn = cin, cout
            b = {"in_in": blocks[:, 0, 0], "in_out": blocks[:, 0, 1],
                 "out_in": blocks[:, 1, 0], "out_out": blocks[:, 1, 1]}
        else:
            cells_ss, cells_nn = cout, cin
            b = {"in_in": blocks[:, 1, 1], "in_out": blocks[:, 1, 0],
                 "out_in": blocks[:, 0, 1], "out_out": blocks[:, 0, 0]}
        dofs_ss = local_ss[cells_ss][:, None] * nd + np.arange(nd)[None, :]
        dofs_nn = local_nn[cells_nn][:, None] * nd + np.arange(nd)[None, :]
        shape = (len(subset), nd, nd)
        for name, rows_d, cols_d in (("in_in", dofs_ss, dofs_ss), ("in_out", dofs_ss, dofs_nn),
                                     ("out_in", dofs_nn, dofs_ss), ("out_out", dofs_nn, dofs_nn)):
            entries[name][0].append(np.broadcast_to(rows_d[:, :, None], shape).ravel())
            entries[name][1].append(np.broadcast_to(cols_d[:, None, :], shape).ravel())
            entries[name][2].append(b[name].reshape(-1))
    shapes = {"in_in": (n_ss, n_ss), "in_out": (n_ss, n_nn),
              "out_in": (n_nn, n_ss), "out_out": (n_nn, n_nn)}
    mats = {}
    for name, (rs, cs, vs) in entries.items():
        if rs:
            rows, cols, vals = np.concatenate(rs), np.concatenate(cs), torch.cat(vs)
        else:
            rows = cols = np.zeros(0, dtype=np.int64)
            vals = torch.zeros(0, dtype=space.dtype, device=space.device)
        if name not in patterns:
            patterns[name] = build_pattern(rows, cols, shapes[name])
        pat = patterns[name]
        mats[name] = SparseMatrix(pat, pat.assemble(vals))
    return CouplingOperator(**mats)
