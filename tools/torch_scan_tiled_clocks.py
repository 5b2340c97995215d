#!/usr/bin/env python3
"""Where a round of K2 (``gps_optimize_slam_tpu_torch/csrc/scan_tiled.cu``)
spends its cycles, on one NVIDIA GPU.

Builds the port's kernels with ``-DGPS_TILED_CLOCKS``, which makes the
kernel add the cycles of each part of a round to a device counter, scans
each combine at the shapes below, and prints per shape, combine and dtype
the tile count and the mean cycles per tile of each part, as one JSON line
(also written to ``--out``), with the card's name and power limit.

* Without ``--batch``: one row of 262,145 elements (a default chunk of the
  chunked path plus its carry), float32 and float64: the single-row
  kernel, thread 0 timing wait for the tile's copy, ``tile_reduce``,
  ``look_back``, ``tile_finish`` and ``tile_store``.
* With ``--batch``: the batch grid, float64, at ``chip_smoke.TILED_BATCH``
  (four identity-padded rows of 524,289 to 20,001) and
  ``chip_smoke.FUSE_BATCH`` (the ``fuse-batch`` command's two rows of
  70,001). A checkout whose ``ops.scan`` names
  ``TILED_BATCH_CLOCK_PARTS`` times its batch grid's parts by those names
  (the compute warps' and the producer warp's, each its own cycles); one
  that does not runs its batch grid on the single-row kernel's parts.

``--root`` imports the port from another checkout (its kernels build into
its own ``build/kernels``), so a parent and this tree are timed alike.
Run from the repository root:

    python3 tools/torch_scan_tiled_clocks.py [--batch] [--root R] [--out F] [--contract]

With ``--contract`` the library is built with multiply-add contraction
(``--fmad=true``) for this timing only: the port builds without it, since
the keep lists' bit-for-bit equality with their plain version needs every
product and sum rounded on its own. Each scan's error against the plain
version is printed beside its time.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402

PARTS = ("wait", "tile_reduce", "look_back", "tile_finish", "tile_store")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", action="store_true", help="the batch grid at the batch shapes")
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--contract", action="store_true", help="build with --fmad=true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("gps_optimize_slam_tpu_torch")]:
        del sys.modules[name]
    from gps_optimize_slam_tpu_torch.ops import _build, scan

    if not scan.__file__.startswith(root + os.sep):
        raise SystemExit(f"torch_scan_tiled_clocks: imported {scan.__file__}, not the checkout at {root}")
    flags = tuple("--fmad=true" if args.contract and f == "--fmad=false" else f for f in _build.NVCC_FLAGS)
    _build.NVCC_FLAGS = flags + ("-DGPS_TILED_CLOCKS",)
    lib = _build.library()
    lib.gps_scan_tiled_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gps_scan_tiled_clocks.restype = ctypes.c_int
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cycles = (ctypes.c_ulonglong * 8)()
    if args.batch:
        parts = getattr(scan, "TILED_BATCH_CLOCK_PARTS", PARTS)
        shapes = {"tiled_batch": chip_smoke.TILED_BATCH, "fuse_batch": chip_smoke.FUSE_BATCH}
        dtypes = (torch.float64,)
    else:
        parts, shapes, dtypes = PARTS, {"single": (chip_smoke.TILED_N,)}, (torch.float32, torch.float64)
    out = {}
    for label, ns in shapes.items():
        for op in scan.OPS:
            for dtype in dtypes:
                x = chip_smoke.identity_padded_rows(op, ns, gen, dtype, device)
                if not args.batch:
                    x = x[:, 0].contiguous()
                reverse = chip_smoke.REVERSE_OF.get(op, False)
                for _ in range(2):  # the second run is read
                    _build.check(lib.gps_scan_tiled_clocks(cycles, 1), "clocks")
                    got = scan.scan_tiled(op, x, reverse)
                    torch.cuda.synchronize()
                _build.check(lib.gps_scan_tiled_clocks(cycles, 1), "clocks")
                n, rows = x.shape[-1], (x.shape[1] if x.ndim == 3 else 1)
                tiled_tile = scan.tiled_tile
                try:
                    tile = tiled_tile(op, dtype, rows)
                except TypeError:  # a checkout whose tile does not depend on the shape
                    tile = tiled_tile(op, dtype)
                tiles = rows * -(-n // tile)
                out[f"{label}/{op}/{chip_smoke.dtype_name(dtype)}"] = {
                    "shape": list(x.shape), "tile": tile, "tiles": tiles,
                    "ms": chip_smoke.cuda_ms(lambda: scan.scan_tiled(op, x, reverse)),
                    "rel_err": chip_smoke.rel_err(got.reshape(-1, n), scan.scan_plain(op, x, reverse).reshape(-1, n)),
                    "cycles_per_tile": {p: int(cycles[i]) // tiles for i, p in enumerate(parts)}}
                del x, got
                torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    line = json.dumps({"root": args.root, "card": smi, "batch": args.batch, "contract": args.contract,
                       "parts": list(parts), "clocks": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
