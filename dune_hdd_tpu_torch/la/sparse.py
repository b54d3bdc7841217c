"""Static-structure sparse matrices.

Counterpart of ``dune_hdd_tpu/la/sparse.py``.  The sparsity structure is
built once on the host (numpy) from the cell/face DoF couplings; the values
live as a flat ``[nnz]`` tensor on the device.  Local element/face
contributions become slot values by a sorted segment reduction: the raw
entries of each slot, in sorted order, are gathered through a padded
``[nnz, max duplicates]`` table and summed along its rows, which is one
gather and one row sum, deterministic on every device (no atomics).

The matrix is applied in ELL layout (``[N, K]`` padded column/value
arrays): gather, multiply, row-sum.  The ELL value array is built once per
matrix, at its first product, and kept.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["SparsityPattern", "SparseMatrix", "build_pattern"]


class _DeviceIndex(NamedTuple):
    seg_table: torch.Tensor     # [nnz, D] raw-entry index per slot, padded with E
    ell_cols: torch.Tensor      # [N, K]
    slot_ell_pos: torch.Tensor  # [nnz]
    diag_slot: torch.Tensor     # [N], -1 where absent
    slot_rows: torch.Tensor     # [nnz]
    slot_cols: torch.Tensor     # [nnz]


@dataclass(frozen=True, eq=False)  # identity equality: patterns are shared
class SparsityPattern:
    """Host-built static structure mapping raw (possibly duplicate) COO
    entries to deduplicated slots and an ELL layout."""

    shape: Tuple[int, int]
    nnz: int
    perm: np.ndarray  # [E] sort order of raw entries
    seg_ids: np.ndarray  # [E] slot id per sorted raw entry
    slot_rows: np.ndarray  # [nnz]
    slot_cols: np.ndarray  # [nnz]
    ell_width: int
    ell_cols: np.ndarray  # [N, K] int32, padded entries point at column 0
    ell_mask: np.ndarray  # [N, K] bool
    slot_ell_pos: np.ndarray  # [nnz] flat index into [N*K] for each slot
    diag_slot: np.ndarray  # [N] slot id of (i, i), -1 if not present
    _on_device: Dict = field(default_factory=dict, repr=False)

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def num_raw(self) -> int:
        return self.perm.shape[0]

    @cached_property
    def seg_table(self) -> np.ndarray:
        """[nnz, D] raw-entry indices of each slot in sorted order, padded
        with ``num_raw`` (an appended zero)."""
        counts = np.bincount(self.seg_ids, minlength=self.nnz)
        width = int(counts.max()) if self.nnz else 1
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(self.num_raw) - start[self.seg_ids]
        table = np.full((self.nnz, width), self.num_raw, dtype=np.int64)
        table[self.seg_ids, pos] = self.perm
        return table

    def on(self, device: torch.device) -> _DeviceIndex:
        """The index arrays as tensors on ``device``, copied once."""
        key = str(device)
        if key not in self._on_device:
            def t(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(device)
            self._on_device[key] = _DeviceIndex(
                t(self.seg_table), t(self.ell_cols), t(self.slot_ell_pos),
                t(self.diag_slot), t(self.slot_rows), t(self.slot_cols))
        return self._on_device[key]

    def assemble(self, raw_values: torch.Tensor) -> torch.Tensor:
        """Raw entry values (same order as the (rows, cols) the pattern was
        built from) -> deduplicated slot values [nnz]."""
        table = self.on(raw_values.device).seg_table
        padded = torch.cat([raw_values, raw_values.new_zeros(1)])
        return padded[table].sum(dim=1)

    def ell_values(self, slot_values: torch.Tensor) -> torch.Tensor:
        """[nnz] slot values -> [N, K] ELL value array."""
        n, k = self.shape[0], self.ell_width
        flat = slot_values.new_zeros(n * k)
        flat[self.on(slot_values.device).slot_ell_pos] = slot_values
        return flat.reshape(n, k)


def build_pattern(rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int]) -> SparsityPattern:
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    n, m = shape
    key = rows * m + cols
    perm = np.argsort(key, kind="stable")
    sorted_key = key[perm]
    new_slot = np.ones(len(sorted_key), dtype=bool)
    new_slot[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_ids = np.cumsum(new_slot) - 1
    slot_key = sorted_key[new_slot]
    nnz = len(slot_key)
    slot_rows = (slot_key // m).astype(np.int32)
    slot_cols = (slot_key % m).astype(np.int32)

    counts = np.bincount(slot_rows, minlength=n)
    K = int(counts.max()) if nnz else 1
    pos_in_row = np.arange(nnz) - np.concatenate([[0], np.cumsum(counts)[:-1]])[slot_rows]
    slot_ell_pos = slot_rows.astype(np.int64) * K + pos_in_row
    ell_cols = np.zeros((n, K), dtype=np.int32)
    ell_mask = np.zeros((n, K), dtype=bool)
    ell_cols.reshape(-1)[slot_ell_pos] = slot_cols
    ell_mask.reshape(-1)[slot_ell_pos] = True

    diag_slot = np.full(n, -1, dtype=np.int64)
    on_diag = slot_rows == slot_cols
    diag_slot[slot_rows[on_diag]] = np.nonzero(on_diag)[0]

    return SparsityPattern(
        shape=(n, m), nnz=nnz, perm=perm, seg_ids=seg_ids.astype(np.int32),
        slot_rows=slot_rows, slot_cols=slot_cols, ell_width=K, ell_cols=ell_cols,
        ell_mask=ell_mask, slot_ell_pos=slot_ell_pos, diag_slot=diag_slot)


class SparseMatrix:
    """ELL sparse matrix: static pattern + slot values [nnz] on a device."""

    def __init__(self, pattern: SparsityPattern, values: torch.Tensor):
        self.pattern = pattern
        self.values = values

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __mul__(self, scalar):
        return SparseMatrix(self.pattern, self.values * scalar)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, SparseMatrix):
            if other.pattern is not self.pattern and other.pattern.shape != self.pattern.shape:
                raise ValueError("adding sparse matrices of different patterns")
            return SparseMatrix(self.pattern, self.values + other.values)
        return NotImplemented

    @cached_property
    def ell(self) -> torch.Tensor:
        """[N, K] ELL values, built at the first product and kept."""
        return self.pattern.ell_values(self.values)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        gathered = x[self.pattern.on(x.device).ell_cols]  # [N, K]
        return (self.ell * gathered).sum(dim=1)

    __matmul__ = matvec

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X [N, K]: one row gather amortised over the K columns."""
        gathered = X[self.pattern.on(X.device).ell_cols]  # [N, Kell, K]
        return torch.einsum("nk,nkK->nK", self.ell, gathered)

    def diagonal(self) -> torch.Tensor:
        dslot = self.pattern.on(self.device).diag_slot
        return torch.where(dslot >= 0, self.values[dslot.clamp(min=0)],
                           self.values.new_zeros(()))

    def to_dense(self) -> torch.Tensor:
        idx = self.pattern.on(self.device)
        out = self.values.new_zeros(self.pattern.shape)
        out[idx.slot_rows, idx.slot_cols] = self.values
        return out

    # -- row/column constraints (Dirichlet) ---------------------------------
    def with_constrained_rows(self, row_mask: np.ndarray, unit_diagonal: bool) -> "SparseMatrix":
        """Zero all slots in masked rows; optionally set their diagonal to 1."""
        mask = torch.as_tensor(np.asarray(row_mask)[self.pattern.slot_rows]).to(self.device)
        vals = torch.where(mask, self.values.new_zeros(()), self.values)
        if unit_diagonal:
            slots = np.asarray(self.pattern.diag_slot)[np.nonzero(np.asarray(row_mask))[0]]
            if (slots < 0).any():
                raise ValueError("a unit-row constraint needs diagonal slots")
            vals[torch.as_tensor(slots).to(self.device)] = 1.0
        return SparseMatrix(self.pattern, vals)

    def with_constrained_cols(self, col_mask: np.ndarray, keep_unit_diag: bool) -> "SparseMatrix":
        """Zero all slots in masked columns (keeping (i, i) if keep_unit_diag):
        symmetric Dirichlet elimination, so Krylov solvers see an SPD operator."""
        cmask = np.asarray(col_mask)[self.pattern.slot_cols]
        if keep_unit_diag:
            cmask = cmask & (self.pattern.slot_rows != self.pattern.slot_cols)
        mask = torch.as_tensor(cmask).to(self.device)
        return SparseMatrix(self.pattern, torch.where(mask, self.values.new_zeros(()),
                                                      self.values))

    def __repr__(self):
        return (f"SparseMatrix(shape={self.shape}, nnz={self.pattern.nnz}, "
                f"K={self.pattern.ell_width})")
