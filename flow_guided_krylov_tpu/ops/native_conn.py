"""ctypes binding for the native connection-hits kernel
(``native/conn_hits.cpp``).

Used by the incremental projected-H build
(``krylov/residual_expansion.py::_projected_sparse``): enumerating all
B*C connections in NumPy, materializing their values, and searchsorting
the keys costs ~50 memory passes over multi-GB temporaries at large
connection counts (39-orbital O3: C = 104,760, measured 0.4 M conn/s on
the single-core host).  The native kernel fuses enumeration + sorted-key
membership + Slater-Condon values for hits only.  Returns None when the
engine is unavailable so the NumPy path takes over (and stays the
cross-checking reference implementation, pinned by
``tests/test_native_conn.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils.native_build import load_native

__all__ = ["conn_hits_native", "native_available"]

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    _lib = load_native("conn_hits.cpp", "libfgk_conn.so")
    if _lib is not None:
        u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        _lib.fgk_conn_hits.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, u64, u64,
            ctypes.c_int64, u64, u64,
            f64, f64, f64, f64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            f64,
        ]
        _lib.fgk_conn_hits.restype = ctypes.c_int64
    return _lib


def native_available() -> bool:
    return _load() is not None


def _channels64(packed: np.ndarray, wide: bool
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, W) uint32 rows -> (alpha64, beta64) channel words."""
    p = np.ascontiguousarray(packed, np.uint32)
    if wide:  # [a_hi, a_lo, b_hi, b_lo]
        a = p[:, 1].astype(np.uint64) | (p[:, 0].astype(np.uint64) << 32)
        b = p[:, 3].astype(np.uint64) | (p[:, 2].astype(np.uint64) << 32)
    else:     # [alpha, beta]
        a = p[:, 0].astype(np.uint64)
        b = p[:, 1].astype(np.uint64)
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def conn_hits_native(h, new: np.ndarray, sorted_keys: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Connections of ``new`` dets that land in a SORTED key array.

    ``h`` must be a molecular Hamiltonian exposing ``tables``
    (ops/slater.py::SlaterTables) and ``pack_words`` in (2, 4);
    ``sorted_keys`` is ``np.sort(h.keys(basis))`` — uint64 for W = 2,
    structured ``KEY128`` for W = 4.  Returns (rows, sorted_positions,
    values) with values float64, or None when the native engine is
    unavailable or the Hamiltonian shape is unsupported.
    """
    lib = _load()
    tables = getattr(h, "tables", None)
    if (lib is None or tables is None
            or getattr(h, "pack_words", 0) not in (2, 4)
            or not hasattr(tables, "jj")):
        return None
    wide = h.pack_words == 4
    a, b = _channels64(np.atleast_2d(new), wide)
    if wide:
        kk = np.ascontiguousarray(sorted_keys).view(np.uint64).reshape(-1, 2)
        key_a = np.ascontiguousarray(kk[:, 0])
        key_b = np.ascontiguousarray(kk[:, 1])
    else:
        key_a = np.ascontiguousarray(sorted_keys, np.uint64)
        key_b = np.zeros(len(key_a), np.uint64)
    n_new = len(a)
    # generous first guess: deep-SCI staircase rows average well under
    # 256 hits; retry with the exact count on overflow
    cap = max(1024, 256 * n_new)
    for _ in range(2):
        rows = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int64)
        vals = np.empty(cap, np.float64)
        total = lib.fgk_conn_hits(
            np.int32(tables.n_orb), np.int32(tables.n_alpha),
            np.int32(tables.n_beta), np.int32(1 if wide else 0),
            np.int64(n_new), a, b,
            np.int64(len(key_a)), key_a, key_b,
            np.ascontiguousarray(tables.h1),
            np.ascontiguousarray(tables.jj),
            np.ascontiguousarray(tables.ex),
            np.ascontiguousarray(tables.h2),
            np.int64(cap), rows, pos, vals)
        if total <= cap:
            return rows[:total], pos[:total], vals[:total]
        cap = int(total)
    return None  # pragma: no cover - the retry always fits
