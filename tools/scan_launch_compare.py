#!/usr/bin/env python3
"""K1's launch (``csrc/scan.cu``: the look-back path of
``csrc/scan_lookback.cuh`` and, where the checkout has it, the cluster path
of ``csrc/scan_cluster.cuh``) or, with ``--kernel k2``, K2's batch grid
(``csrc/scan_tiled.cu`` on (L, B, n) leaves) beside K1's batch grid on the
same leaves, of one checkout of the port, timed on one NVIDIA GPU at the
shapes the main path gives them, to compare two checkouts in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and prints one JSON line
(also written to ``--out``) with, per shape and combine (every combine, in
the direction the main path scans it):

* ``device_ms``: the device time of everything a ``scan.scan_block`` call
  (``--kernel k2``: ``scan.scan_tiled``) runs (``chip_smoke.device_ms``:
  the kernel, and on the look-back paths the memset of its ticket and
  flags), a torch.profiler trace of 20 calls;
* ``launch_device_ms``: [ms, traced] of the kernel's launch alone
  (``chip_smoke.launch_device_ms``, the kernels whose name holds
  ``scan_kernel``; with ``--kernel k2`` the grid's, ``tiled_``);
* ``ms``: a call's CUDA-event median over 20 calls (the wrapper's host time
  included);
* ``rel_err`` against ``scan.scan_plain`` on the same leaves (the tool
  fails where it passes the scan's tolerance, 1e-4 float32, 1e-10 float64);
* ``tile`` and ``cluster`` (``scan.block_tile``; ``scan.block_cluster``
  where the checkout has it, else 0: the look-back path); with ``--kernel
  k2`` K2's batch tile, ``k1_device_ms`` (K1's batch grid on the same
  leaves), ``bound`` and the route of the shape;

and the registers and spill bytes of every instantiation of K1's kernels
(``chip_smoke.scan_kernel_registers`` on the build's ``-Xptxas -v``; this
tool's own reader on the other checkout's log).

K1's shapes: the fleet bucket (64 x 4,661, float32 and float64), the eleven
KITTI lengths as one ragged batch (rows padded with their last element,
float32 and float64), phase 10's four rows of 524,288 / 458,752 / 393,216 /
300,000, identity-padded (float64), and a single row of 4,661 (float32 and
float64) as a control. K2's (``--kernel k2``, float64, identity-padded):
``chip_smoke.TILED_BATCH``, ``TILED_BATCH_FEW`` (4 x 20,001), ``FUSE_BATCH``
(the fuse-batch command's 2 x 70,001), 4 x 262,145 and phase 10's rows;
with ``--route`` also 2, 4, 8 and 16 rows of 65,537, 131,073, 262,145 and
524,289 (the route's grid). The data is made from ``--seed`` alike for
every checkout. Run from the repository root, a parent checkout unpacked
under ``build/``, in turns:

    python3 tools/scan_launch_compare.py --root build/parent --out build/scan_p1.json [--kernel k2]
    python3 tools/scan_launch_compare.py --root . --out build/scan_t1.json [--kernel k2]
    python3 tools/scan_launch_compare.py --root . --out build/scan_t2.json [--kernel k2]
    python3 tools/scan_launch_compare.py --root build/parent --out build/scan_p2.json [--kernel k2]
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


ROUTE_ROWS = (2, 4, 8, 16)
ROUTE_LENGTHS = (65_537, 131_073, 262_145, 524_289)


def k2_cases(cs, gen, device, route):
    """(label, leaves maker) of K2's batch shapes, float64, identity-padded;
    with ``route`` the route's grid of rows x lengths too."""
    import torch

    f64 = torch.float64
    shapes = {"tiled_batch": cs.TILED_BATCH, "tiled_batch_few": cs.TILED_BATCH_FEW, "fuse_batch": cs.FUSE_BATCH,
              "4x262145": (262_145,) * 4, "phase10": cs.LONG_LOG_LENGTHS}
    if route:
        shapes.update({f"{b}x{n}": (n,) * b for b in ROUTE_ROWS for n in ROUTE_LENGTHS})
    for label, ns in shapes.items():
        yield f"{label}/float64", lambda op, ns=ns: cs.identity_padded_rows(op, ns, gen, f64, device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=("k1", "k2"), default="k1", help="K1's launch, or K2's batch grid beside K1's")
    ap.add_argument("--route", action="store_true", help="with --kernel k2: the route's grid of shapes too")
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
    k2 = args.kernel == "k2"
    out = {"root": args.root, "card": cs.card_name(), "kernel": args.kernel,
           "registers_and_spills": cs.scan_kernel_registers(_build.BUILD_INFO["log"]), "scan": {}}
    gen = torch.Generator().manual_seed(args.seed)
    cluster = getattr(scan, "block_cluster", lambda *a: 0)
    bad = []
    for label, make in (k2_cases(cs, gen, device, args.route) if k2 else cases(cs, gen, device)):
        for op in scan.OPS:
            x = make(op)
            reverse = cs.REVERSE_OF.get(op, False)
            n, batch = x.shape[-1], (x.shape[1] if x.ndim == 3 else 1)

            def call():
                return (scan.scan_tiled if k2 else scan.scan_block)(op, x, reverse)

            err = cs.rel_err(call().reshape(-1, n), scan.scan_plain(op, x, reverse).reshape(-1, n))
            if not err <= cs.TOL[cs.dtype_name(x.dtype)]:
                bad.append(f"{label}/{op}")
            entry = {"shape": list(x.shape), "reverse": reverse, "rel_err": err,
                     "device_ms": cs.device_ms(call),
                     "launch_device_ms": list(cs.launch_device_ms(call, "tiled_" if k2 else "scan_kernel")),
                     "ms": cs.cuda_ms(call, reps=20), "bound": cs.scan_bound(op, x)}
            if k2:
                try:
                    route = scan.scan_route(x.shape[0], n, x.element_size(), batch, op)
                except TypeError:  # a checkout whose batch route does not depend on the combine
                    route = scan.scan_route(x.shape[0], n, x.element_size(), batch)
                entry.update(k1_device_ms=cs.device_ms(lambda: scan.scan_block(op, x, reverse)), route=route)
                try:
                    entry["tile"] = scan.tiled_tile(op, x.dtype, batch)
                except TypeError:  # a checkout whose K2 tile does not depend on the batch
                    entry["tile"] = scan.tiled_tile(op, x.dtype)
            else:
                entry.update(tile=scan.block_tile(op, x.dtype, n, batch), cluster=cluster(op, x.dtype, n, batch))
            out["scan"][f"{label}/{op}"] = entry
            del x
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if bad:
        raise SystemExit(f"scan_launch_compare: the scan differs from the plain scan at {bad}")


if __name__ == "__main__":
    main()
