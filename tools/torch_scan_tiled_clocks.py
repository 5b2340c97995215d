#!/usr/bin/env python3
"""Where a round of K2 (``gps_optimize_slam_tpu_torch/csrc/scan_tiled.cu``)
spends its cycles, on one NVIDIA GPU.

Builds the port's kernels with ``-DGPS_TILED_CLOCKS``, which makes thread 0
of every block add the cycles of each part of a round (wait for the tile's
copy, ``tile_reduce``, ``look_back``, ``tile_finish``, ``tile_store``) to a
device counter, scans each combine once at 262,145 elements (a default chunk
of the chunked path plus its carry), and prints per combine and dtype the
tile count and the mean cycles per tile of each part, as one JSON line, with
the card's name and power limit. Run from the repository root:

    python3 tools/torch_scan_tiled_clocks.py [--contract]

With ``--contract`` the library is built with multiply-add contraction
(``--fmad=true``) for this timing only: the port builds without it, since
the keep lists' bit-for-bit equality with their plain version needs every
product and sum rounded on its own. Each scan's error against the plain
version is printed beside its time.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from gps_optimize_slam_tpu_torch.ops import _build, scan  # noqa: E402

PARTS = ("wait", "tile_reduce", "look_back", "tile_finish", "tile_store")
N = chip_smoke.TILED_N


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    contract = "--contract" in sys.argv[1:]
    flags = tuple("--fmad=true" if contract and f == "--fmad=false" else f for f in _build.NVCC_FLAGS)
    _build.NVCC_FLAGS = flags + ("-DGPS_TILED_CLOCKS",)
    lib = _build.library()
    lib.gps_scan_tiled_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gps_scan_tiled_clocks.restype = ctypes.c_int
    device = torch.device("cuda")
    cycles = (ctypes.c_ulonglong * 8)()
    out = {}
    for op in scan.OPS:
        for dtype in (torch.float32, torch.float64):
            x = chip_smoke.scan_inputs(op, N, torch.Generator().manual_seed(0), dtype, device)
            reverse = chip_smoke.REVERSE_OF.get(op, False)
            for _ in range(2):  # the second run is read
                got = scan.scan_tiled(op, x, reverse)
                torch.cuda.synchronize()
                _build.check(lib.gps_scan_tiled_clocks(cycles, 1), "clocks")
            tiles = -(-N // scan.tiled_tile(op, dtype))
            out[f"{op}/{chip_smoke.dtype_name(dtype)}"] = {
                "tiles": tiles, "ms": chip_smoke.cuda_ms(lambda: scan.scan_tiled(op, x, reverse)),
                "rel_err": chip_smoke.rel_err(got, scan.scan_plain(op, x, reverse)),
                "cycles_per_tile": {p: int(cycles[i]) // tiles for i, p in enumerate(PARTS)}}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"n": N, "contract": contract, "clocks": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
