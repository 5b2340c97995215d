"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, which is loaded
with ctypes. The library lives in ``build/kernels/`` at the repository
root, and its name carries a hash of the sources and flags, so that an edited
source is rebuilt and a stale library is never loaded. Nothing here runs when
a module is imported: the CPU tests import every module on a host with no
``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but ``cudaSuccess``. Kernels launch on
PyTorch's current stream of their tensors' device, with that device made
current around the call, allocate nothing and do not synchronise.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
# Held while the library is built and loaded: the mesh's host threads (one a
# device) may reach their first kernel together.
_LIB_LOCK = threading.Lock()
# Held while a wrapper adds one to its launch count (a read-modify-write
# that threads launching on several devices would otherwise interleave).
COUNT_LOCK = threading.Lock()
# This thread's tally while it captures a CUDA graph (utils/graphs).
_TALLY = threading.local()
# Filled by library(): build seconds (0.0 when an up-to-date library was
# found), the library path, and nvcc's output (-Xptxas -v: registers, shared
# memory and spills of every kernel).
BUILD_INFO: dict = {}

_VP, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# name -> (argtypes, restype); a cudaError_t comes back as an int.
_SIGNATURES = {
    "gps_scan": ([_I, _I, _VP, _VP, _I, _I, _I, _VP, _VP], _I),
    "gps_scan_scratch_bytes": ([_I, _I, _I, _I], _LL),
    "gps_scan_tile": ([_I, _I, _I, _I], _I),
    "gps_scan_cluster": ([_I, _I, _I, _I], _I),
    "gps_scan_tiled": ([_I, _I, _VP, _VP, _VP, _LL, _I, _I, _I, _VP], _I),
    "gps_scan_tiled_scratch_bytes": ([_I, _I, _I, _I], _LL),
    "gps_scan_tiled_tile": ([_I, _I, _I], _I),
    "gps_scan_tiled_grid_layout": ([_I, _I, _VP], _I),
    "gps_nn_min_dist2": ([_I, _I, _VP, _I, _VP, _VP, _VP, _I, _I, _I, _VP, _VP], _I),
    "gps_nn_keep": ([_I, _I, _VP, _I, _VP, _VP, _I, _VP, _I, _I, _VP, _VP, _VP, _VP], _I),
    "gps_nn_keep_split": ([_I, _I, _I], _I),
    "gps_nn_grid": ([_I, _I, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP], _I),
    "gps_nn_grid_run": ([], _I),
    "gps_ransac_counts": ([_I, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _D, _VP, _VP, _I, _VP, _VP], _I),
    "gps_ransac_counts_scratch": ([_I, _I, _I], _LL),
    "gps_trace_mark": ([_VP, _VP, _VP, _I, _I, _VP], _I),
    "gps_capture_kernel_nodes": ([_VP], _LL),
    "gps_graph_kernel_nodes": ([_VP], _LL),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cu_sources():
    return sorted(CSRC.glob("*.cu"))


def _sources():
    return _cu_sources() + sorted(CSRC.glob("*.cuh"))


def _compile(so: Path) -> str:
    """nvcc every source, one process each, all started together, and link
    the objects into ``so`` (through a temporary name, so that a reader
    never meets a half-written library). Returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _cu_sources()]
    nvcc = _nvcc()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_cu_sources(), objs)
    ]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in outs)
    if any(rc != 0 for _, rc in outs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    return log


def _open(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.gps_error_string.argtypes = [ctypes.c_int]
    lib.gps_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call (once, whichever
    threads call it first)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in _sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        so = BUILD_DIR / f"libgps_kernels_{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        log = "" if so.exists() else _compile(so)
        lib = _open(so)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned anything but cudaSuccess."""
    if rc != 0:
        msg = library().gps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.float64:
        return 1
    raise TypeError(f"kernels take float32 or float64, got {t.dtype}")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, the device of
    the tensors a wrapper launches on (which also makes it current around
    the launch, ``torch.cuda.device``): the current device's stream would
    put a block of a multi-device mesh in another device's context."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Every tensor on the same CUDA device (and contiguous, unless the
    wrapper repacks it); raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def count_launch(wrapper, op: Optional[str] = None) -> None:
    """Add one to ``wrapper.launches`` (``wrapper.launches[op]``): a wrapper
    calls it where it launches its kernel. While this thread captures a
    graph, nothing launches: the launch goes to the capture's tally
    (``tally_launches``), and each replay adds the tally
    (``add_launches``)."""
    tally = getattr(_TALLY, "launches", None)
    if tally is not None:
        tally[(wrapper, op)] = tally.get((wrapper, op), 0) + 1
        return
    add_launches({(wrapper, op): 1})


def add_launches(tally: dict) -> None:
    """Add a tally of ``{(wrapper, op): launches}`` to the wrappers' counts."""
    with COUNT_LOCK:
        for (wrapper, op), n in tally.items():
            if op is None:
                wrapper.launches += n
            else:
                wrapper.launches[op] += n


@contextlib.contextmanager
def tally_launches():
    """Within it, this thread's launches (a capture's) are recorded in the
    yielded dict instead of the wrappers' counts."""
    _TALLY.launches = {}
    try:
        yield _TALLY.launches
    finally:
        _TALLY.launches = None
