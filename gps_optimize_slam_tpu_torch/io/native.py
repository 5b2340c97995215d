"""ctypes binding of the repository's native table parser
(``native/libfastparse.so``, built from ``native/fastparse.cpp``).

``loadtxt(path)`` stands in for np.loadtxt on the numeric tables this package
reads (TUM, GNSS fix files): '#'-comment lines skipped, spaces/tabs/commas as
delimiters. When the shared library is absent it falls back to np.loadtxt:
the native path is a host-throughput optimisation, not a dependency.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libfastparse.so")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

_ERRORS = {
    -1: "cannot open file",
    -2: "mmap failed",
    -3: "row has fewer columns than the first row",
    -4: "row has more columns than the first row",
    -5: "unparsable numeric token",
    -6: "file grew between sizing and fill calls",
}


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.fastparse_table.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastparse_table.restype = ctypes.c_int
    _lib = lib
    return _lib


def loadtxt(path: str) -> np.ndarray:
    """Parse a numeric table; native fast path with np.loadtxt fallback."""
    lib = _get_lib()
    if lib is None:
        try:
            return np.loadtxt(path)
        except ValueError:
            return np.loadtxt(path, delimiter=",")

    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    rc = lib.fastparse_table(
        path.encode(), None, ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc != 0:
        raise ValueError(f"fastparse({path}): {_ERRORS.get(rc, rc)}")
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    if rows.value:
        rc = lib.fastparse_table(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(rows),
            ctypes.byref(cols),
        )
        if rc != 0:
            raise ValueError(f"fastparse({path}): {_ERRORS.get(rc, rc)}")
    return out
