"""ctypes bindings for the native host-side index builders
(``csrc/hdd_native.cpp``): mesh face connectivity and sparsity-pattern
deduplication.

Counterpart of ``dune_hdd_tpu/native.py``.  The shared library is built with
``g++`` at first use into ``dune_hdd_tpu_torch/_build/`` (named by a hash of
the source and flags, like the CUDA kernels of ``kernels/build.py``), never
next to the source.  A failed build raises: there is no numpy route behind
these functions (the grid's own numpy connectivity is
``grid/structured._build_connectivity``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["native_available", "build_connectivity", "dedup_pattern"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "hdd_native.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def native_available() -> bool:
    """Whether the library can be built here: the source and a g++."""
    return _SRC.is_file() and shutil.which("g++") is not None


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        so = _BUILD_DIR / f"libhdd_native-{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *_FLAGS, "-o", tmp, str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
        lib = ctypes.CDLL(str(so))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.build_connectivity.restype = ctypes.c_int64
        lib.build_connectivity.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                           i32p, i32p, i32p, i32p]
        lib.dedup_pattern.restype = ctypes.c_int64
        lib.dedup_pattern.argtypes = [i64p, ctypes.c_int64, i64p, i32p, i64p]
        _LIB = lib
        return lib


def build_connectivity(cells: np.ndarray):
    """(faces, cell_faces, face_cells, face_local) of a 2D mesh whose local
    faces are (i, (i + 1) mod nvc), numbered in order of first touch; each
    face keeps its inside cell's orientation."""
    lib = _load()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nvc = cells.shape
    max_nf = nc * nvc
    faces = np.empty((max_nf, 2), dtype=np.int32)
    cell_faces = np.empty((nc, nvc), dtype=np.int32)
    face_cells = np.empty((max_nf, 2), dtype=np.int32)
    face_local = np.empty((max_nf, 2), dtype=np.int32)
    nf = lib.build_connectivity(cells.reshape(-1), nc, nvc, faces.reshape(-1),
                                cell_faces.reshape(-1), face_cells.reshape(-1),
                                face_local.reshape(-1))
    return faces[:nf].copy(), cell_faces, face_cells[:nf].copy(), face_local[:nf].copy()


def dedup_pattern(keys: np.ndarray):
    """(perm, seg_ids, slot_keys): the stable argsort of the keys, each
    sorted entry's slot, and the sorted distinct keys."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    e = keys.shape[0]
    perm = np.empty(e, dtype=np.int64)
    seg_ids = np.empty(e, dtype=np.int32)
    slot_keys = np.empty(e, dtype=np.int64)
    nnz = lib.dedup_pattern(keys, e, perm, seg_ids, slot_keys)
    return perm, seg_ids, slot_keys[:nnz].copy()
