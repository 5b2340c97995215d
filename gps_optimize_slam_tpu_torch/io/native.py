"""ctypes binding of the repository's native table parser
(``native/libfastparse.so``, built from ``native/fastparse.cpp``).

``loadtxt(path)`` stands in for np.loadtxt on the numeric tables this package
reads (TUM, KITTI poses, GNSS fix files): '#'-comment lines skipped,
spaces/tabs/commas as delimiters; ``oxts_scan`` reads a KITTI oxts ``data/``
folder in one call. When the shared library is absent ``loadtxt`` falls back
to np.loadtxt and ``oxts_scan`` returns None: the native path is a
host-throughput optimisation, not a dependency.
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
    if hasattr(lib, "fastparse_oxts_dir"):
        lib.fastparse_oxts_dir.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.fastparse_oxts_dir.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native parser's shared library was found and loaded."""
    return _get_lib() is not None


def oxts_scan(data_dir: str, max_frames: int) -> Optional[np.ndarray]:
    """Native scan of a KITTI oxts ``data/`` folder: one C call for the whole
    directory instead of one np.loadtxt per frame file.

    Returns an (n_rows, 6) array of ``[frame_idx, lat, lon, alt, numsats,
    velmode]`` rows (oxts columns 0, 1, 2, 25, 27), or None when the native
    library is absent (the caller then reads the files one by one). Frame
    files that do not exist are skipped; a frame file of several rows gives
    several rows. Raises ValueError on a malformed file."""
    lib = _get_lib()
    if lib is None or not hasattr(lib, "fastparse_oxts_dir"):
        return None
    rows = ctypes.c_int64(0)
    rc = lib.fastparse_oxts_dir(data_dir.encode(), None, ctypes.byref(rows), max_frames)
    if rc != 0:
        raise ValueError(f"fastparse_oxts_dir({data_dir}): {_ERRORS.get(rc, rc)}")
    out = np.empty((rows.value, 6), dtype=np.float64)
    if rows.value:
        rc = lib.fastparse_oxts_dir(
            data_dir.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(rows),
            max_frames,
        )
        if rc != 0:
            raise ValueError(f"fastparse_oxts_dir({data_dir}): {_ERRORS.get(rc, rc)}")
    return out


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
