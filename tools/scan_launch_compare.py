#!/usr/bin/env python3
"""K1's launch (``csrc/scan.cu``: the look-back path of
``csrc/scan_lookback.cuh`` and, where the checkout has it, the cluster path
of ``csrc/scan_cluster.cuh``) of one checkout of the port, timed on one
NVIDIA GPU at the shapes the main path gives it, to compare two checkouts
in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and prints one JSON line
(also written to ``--out``) with, per shape and combine (every combine, in
the direction the main path scans it):

* ``device_ms``: the device time of everything a ``scan.scan_block`` call
  runs (``chip_smoke.device_ms``: the kernel, and on the look-back path the
  memset of its ticket and flags), a torch.profiler trace of 20 calls;
* ``launch_device_ms``: [ms, traced] of the kernel's launch alone
  (``chip_smoke.launch_device_ms``, the kernels whose name holds
  ``scan_kernel``);
* ``ms``: a call's CUDA-event median over 20 calls (the wrapper's host time
  included);
* ``rel_err`` against ``scan.scan_plain`` on the same leaves (the tool
  fails where it passes the scan's tolerance, 1e-4 float32, 1e-10 float64);
* ``tile`` and ``cluster`` (``scan.block_tile``; ``scan.block_cluster``
  where the checkout has it, else 0: the look-back path);

and the registers and spill bytes of every instantiation of K1's kernels
(``chip_smoke.scan_kernel_registers`` on the build's ``-Xptxas -v``; this
tool's own reader on the other checkout's log).

The shapes: the fleet bucket (64 x 4,661, float32 and float64), the eleven
KITTI lengths as one ragged batch (rows padded with their last element,
float32 and float64), phase 10's four rows of 524,288 / 458,752 / 393,216 /
300,000, identity-padded (float64), and a single row of 4,661 (float32 and
float64) as a control. The data is made from ``--seed`` alike for every
checkout. Run from the repository root, a parent checkout unpacked under
``build/``, in turns:

    python3 tools/scan_launch_compare.py --root build/parent --out build/scan_p1.json
    python3 tools/scan_launch_compare.py --root . --out build/scan_t1.json
    python3 tools/scan_launch_compare.py --root . --out build/scan_t2.json
    python3 tools/scan_launch_compare.py --root build/parent --out build/scan_p2.json
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its timers, inputs and register
    reader), whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tool", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases(cs, gen, device):
    """(label, leaves maker): each shape's (L, B, n) or (L, n) leaves of a
    combine, made from ``gen``."""
    import torch

    f32, f64 = torch.float32, torch.float64
    fleet = (cs.FLEET[1],) * cs.FLEET[0]
    for dtype in (f32, f64):
        name = cs.dtype_name(dtype)
        yield f"fleet/{name}", lambda op, d=dtype: cs.batched_scan_inputs(op, fleet, gen, d, device)
        yield f"kitti/{name}", lambda op, d=dtype: cs.batched_scan_inputs(op, cs.KITTI_LENGTHS, gen, d, device)
    yield "phase10/float64", lambda op: cs.identity_padded_rows(op, cs.LONG_LOG_LENGTHS, gen, f64, device)
    for dtype in (f32, f64):
        yield f"single4661/{cs.dtype_name(dtype)}", lambda op, d=dtype: cs.scan_inputs(op, cs.FLEET[1], gen, d,
                                                                                        device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    cs = load_chip_smoke()
    sys.path.insert(0, root)
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, scan

    if not torch.cuda.is_available():
        raise SystemExit("scan_launch_compare: no CUDA device")
    if not scan.__file__.startswith(root + os.sep):
        raise SystemExit(f"scan_launch_compare: imported {scan.__file__}, not the checkout at {root}")
    device = torch.device("cuda")
    _build.library()
    out = {"root": args.root, "card": cs.card_name(),
           "registers_and_spills": cs.scan_kernel_registers(_build.BUILD_INFO["log"]), "scan": {}}
    gen = torch.Generator().manual_seed(args.seed)
    cluster = getattr(scan, "block_cluster", lambda *a: 0)
    bad = []
    for label, make in cases(cs, gen, device):
        for op in scan.OPS:
            x = make(op)
            reverse = cs.REVERSE_OF.get(op, False)
            n, batch = x.shape[-1], (x.shape[1] if x.ndim == 3 else 1)

            def call():
                return scan.scan_block(op, x, reverse)

            err = cs.rel_err(call().reshape(-1, n), scan.scan_plain(op, x, reverse).reshape(-1, n))
            if not err <= cs.TOL[cs.dtype_name(x.dtype)]:
                bad.append(f"{label}/{op}")
            out["scan"][f"{label}/{op}"] = {
                "shape": list(x.shape), "reverse": reverse, "rel_err": err,
                "tile": scan.block_tile(op, x.dtype, n, batch), "cluster": cluster(op, x.dtype, n, batch),
                "device_ms": cs.device_ms(call), "launch_device_ms": list(cs.launch_device_ms(call, "scan_kernel")),
                "ms": cs.cuda_ms(call, reps=20), "bound": cs.scan_bound(op, x)}
            del x
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if bad:
        raise SystemExit(f"scan_launch_compare: K1 differs from the plain scan at {bad}")


if __name__ == "__main__":
    main()
