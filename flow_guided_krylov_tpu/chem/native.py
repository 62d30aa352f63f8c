"""ctypes binding for the native C++ ERI engine (``native/integrals.cpp``).

Loads ``libfgk_integrals.so`` (built on demand by ``utils/native_build``)
and exposes :func:`eri_tensor_native`.  Returns None when the native engine is
unavailable so the pure-NumPy implementation takes over.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..utils.native_build import load_native

__all__ = ["eri_tensor_native", "native_available"]

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    _lib = load_native("integrals.cpp", "libfgk_integrals.so",
                       extra_flags=("-fopenmp",))
    if _lib is not None:
        _lib.fgk_eri_tensor.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _lib.fgk_eri_tensor.restype = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def eri_tensor_native(funcs: List) -> Optional[np.ndarray]:
    """Compute the chemist-notation ERI tensor natively; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(funcs)
    if any(max(f.lmn) > 2 for f in funcs):
        return None  # beyond the engine's per-direction LMAX; Python fallback
    lmn = np.array([f.lmn for f in funcs], np.int32)
    centers = np.ascontiguousarray(
        np.array([f.center for f in funcs], np.float64))
    offsets = np.zeros(n + 1, np.int32)
    exps: List[float] = []
    coefs: List[float] = []
    for i, f in enumerate(funcs):
        exps.extend(f.exps.tolist())
        coefs.extend(f.coefs.tolist())
        offsets[i + 1] = len(exps)
    eri = np.zeros(n ** 4, np.float64)
    lib.fgk_eri_tensor(n, np.ascontiguousarray(lmn),
                       centers, offsets,
                       np.ascontiguousarray(np.asarray(exps, np.float64)),
                       np.ascontiguousarray(np.asarray(coefs, np.float64)),
                       eri)
    return eri.reshape(n, n, n, n)
