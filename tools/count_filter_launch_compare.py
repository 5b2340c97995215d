#!/usr/bin/env python3
"""K5, the RANSAC consensus counts (``csrc/ransac_counts.cu``), and K1's
27-leaf filter scan (``csrc/scan.cu`` + ``scan_lookback.cuh``), and K2's
filter beside them (``csrc/scan_tiled.cu``), of one checkout of the port,
timed on one NVIDIA GPU, to compare two checkouts in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and prints one JSON line
with, per shape:

* K5 (``kernels.ransac_counts``, 1000 four-point Umeyama trials a row):
  ``device_ms``, the count kernel's launch alone (``count_kernel``) and,
  where the checkout lists the valid chunks first, the list's
  (``chunk_list_kernel``), each a launch's device time from a
  ``torch.profiler`` trace of 10 calls (``chip_smoke.launch_device_ms``);
  ``call_ms``, the whole call's CUDA-event median; ``call_device_ms``,
  the device time of everything a call runs (the output's zeroing, the
  scratch's memset, the list and count launches); ``valid_share`` of each
  row; ``pairs_valid``, the (trial, valid point) pairs; ``equal_to_plain``;
  and, where the checkout has ``kernels.counts_launch``, the count kernel's
  launch on each of its shapes (``device_ms_by_shape``: ``P2``, the grid of
  every chunk, and ``P4``, the listed walk, whose list launch is timed
  apart), with the pairs it recounted in the plain order;
* the filter (``scan.scan_block``; K2's ``scan.scan_tiled`` where named):
  ``device_ms`` of a launch (``lookback_scan_kernel``, ``tiled_scan_kernel``),
  ``call_ms`` and ``rel_err`` against ``scan.scan_plain``;

and the filter's and K5's registers and spill bytes from ``-Xptxas -v``, and
K5's instructions a (warp, trial) from its SASS (``chip_smoke.sass_count_loops``,
this tool's own reader on the other checkout's library).

The shapes: K5 at the fleet bucket (64 x 4,661 float32, phase 1's random
95 %-valid mask), the fleet with a Sim(3) window a row (1,800 contiguous
valid points at a seeded start, what the fusion's window mask keeps of a
10 Hz log), one row of 4,661 (float32, 95 % valid) and phase 10's shape
(4 x 524,288 float64, a window a row); the filter at the fleet (float32 and
float64), phase 10's rows (4 x 524,288 float64, rows of 524,288 / 458,752 /
393,216 / 300,000 identity-padded), single rows of 4,661, 16,384, 32,768
and 65,536 (K1's longest) and 8, 16 and 32 rows of 4,661, each in float32 and
float64 (about the crossover of the filter's two tiles, ``kRunsMinF32`` and
``kRunsMinF64`` in ``csrc/scan_lookback.cuh``), and K2
at 262,145 float64 and its batch grid at 4 x 524,289. The data is made from ``--seed`` alike for
every checkout. Run from the repository root, a parent checkout unpacked
under ``build/``, in turns:

    python3 tools/count_filter_launch_compare.py --root build/parent
    python3 tools/count_filter_launch_compare.py --root .
    python3 tools/count_filter_launch_compare.py --root .
    python3 tools/count_filter_launch_compare.py --root build/parent
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = (64, 4661)
LONG = (524_288, 458_752, 393_216, 300_000)
WINDOW = 1800  # 180 s at 10 Hz: the most the Sim(3) window keeps
SINGLE_ROWS = (4661, 16_384, 32_768, 65_536)  # the filter's single rows, about its tiles' crossover
TRIALS = 1000


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its timers, inputs and SASS
    reader), whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tool", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def count_case(cs, gen, B, n, dtype, device, window):
    """K5's operands: B random-walk rows of n points, dst a noisy Sim(3)
    image of src, valid 95 % at random or one window of ``WINDOW``
    contiguous points a row, and ``TRIALS`` Umeyama fits of four valid
    points each."""
    import torch

    from gps_optimize_slam_tpu_torch.ops.umeyama import umeyama_sim3

    f64 = torch.float64
    src = torch.stack([cs.walk(gen, n, f64, device, scale=2.0) for _ in range(B)])
    dst = 0.987 * src + torch.tensor([3.0, -2.0, 1.0], dtype=f64, device=device)
    dst = dst + 2.0 * torch.randn(B, n, 3, generator=gen, dtype=f64).to(device)
    if window:
        lo = torch.randint(0, max(1, n - WINDOW), (B,), generator=gen)
        hi = torch.clamp(lo + WINDOW, max=n)
        idx = torch.arange(n)
        valid = ((idx[None] >= lo[:, None]) & (idx[None] < hi[:, None])).to(device)
    else:
        valid = (torch.rand(B, n, generator=gen) > 0.05).to(device)
        lo, hi = torch.zeros(B, dtype=torch.long), torch.full((B,), n)
    u = torch.rand(B, TRIALS, 4, generator=gen, dtype=f64)
    draws = (lo[:, None, None] + (u * (hi - lo)[:, None, None]).long()).clamp(max=n - 1).to(device)
    src, dst = src.to(dtype), dst.to(dtype)
    pick = torch.arange(B, device=device)[:, None, None]
    fits = umeyama_sim3(src[pick, draws], dst[pick, draws])
    return (src, dst, valid, fits.R.contiguous(), fits.t.contiguous(), fits.scale.contiguous(), 16.0)


def count_cases(cs, gen, device):
    import torch

    f32, f64 = torch.float32, torch.float64
    yield "fleet/float32", count_case(cs, gen, *FLEET, f32, device, False)
    yield "fleet_window/float32", count_case(cs, gen, *FLEET, f32, device, True)
    one = count_case(cs, gen, 1, FLEET[1], f32, device, False)
    yield "single/float32", tuple(a[0] if torch.is_tensor(a) else a for a in one)
    yield "phase10/float64", count_case(cs, gen, len(LONG), LONG[0], f64, device, True)


def scan_cases(cs, gen, device):
    import torch

    f32, f64 = torch.float32, torch.float64
    yield "fleet/float32", "block", cs.batched_scan_inputs("filter", (FLEET[1],) * FLEET[0], gen, f32, device)
    yield "fleet/float64", "block", cs.batched_scan_inputs("filter", (FLEET[1],) * FLEET[0], gen, f64, device)
    yield "phase10/float64", "block", cs.batched_scan_inputs("filter", LONG, gen, f64, device)
    for dtype in (f32, f64):
        name = str(dtype).split(".")[1]
        for n in SINGLE_ROWS:
            yield f"single{n}/{name}", "block", cs.scan_inputs("filter", n, gen, dtype, device)
        for rows in (8, 16, 32):
            yield (f"batch{rows}x4661/{name}", "block",
                   cs.batched_scan_inputs("filter", (FLEET[1],) * rows, gen, dtype, device))
    yield "k2_262145/float64", "tiled", cs.scan_inputs("filter", 262_145, gen, f64, device)
    yield "k2_batch/float64", "tiled", cs.batched_scan_inputs("filter", (524_289,) * 4, gen, f64, device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="counts,scan", help="counts, scan, or both")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    cs = load_chip_smoke()
    sys.path.insert(0, root)
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build, kernels, scan

    if not torch.cuda.is_available():
        raise SystemExit("count_filter_launch_compare: no CUDA device")
    if not kernels.__file__.startswith(root + os.sep):
        raise SystemExit(f"count_filter_launch_compare: imported {kernels.__file__}, not the checkout at {root}")
    device = torch.device("cuda")
    _build.library()
    registers = cs.build_registers(_build.BUILD_INFO["log"])
    out = {"root": args.root,
           "registers_and_spills": {k: v for k, v in registers.items() if "count" in k or "chunk" in k
                                    or "Filter" in k},
           "sass": cs.sass_count_loops(_build.BUILD_INFO["path"]), "counts": {}, "scan": {}}
    gen = torch.Generator().manual_seed(args.seed)

    def kernel_ms(fn, name):
        return cs.launch_device_ms(fn, name)[0]

    parts = args.parts.split(",")
    if "counts" in parts:
        for label, a in count_cases(cs, gen, device):
            want = kernels.ransac_counts_plain(*a)
            got = kernels.ransac_counts(*a)
            torch.cuda.synchronize()
            valid = a[2].reshape(-1, a[2].shape[-1])
            res = {"equal_to_plain": bool(torch.equal(got, want)),
                   "valid_share": [float(v) for v in valid.double().mean(1)][:4],
                   "pairs_valid": int(valid.sum()) * a[3].shape[-3],
                   "call_ms": cs.cuda_ms(lambda: kernels.ransac_counts(*a)),
                   "call_device_ms": cs.device_ms(lambda: kernels.ransac_counts(*a)),
                   "device_ms": kernel_ms(lambda: kernels.ransac_counts(*a), "count_kernel"),
                   "list_device_ms": kernel_ms(lambda: kernels.ransac_counts(*a), "chunk_list_kernel")}
            if hasattr(kernels, "counts_launch"):
                by = {}
                for P in kernels.COUNT_PER_THREADS:
                    rc = torch.zeros(1, dtype=torch.int64, device=device)
                    same = torch.equal(kernels.counts_launch(*a, per_thread=P, recounted=rc), want)
                    by[f"P{P}"] = {
                        "device_ms": kernel_ms(lambda: kernels.counts_launch(*a, per_thread=P), "count_kernel"),
                        "list_device_ms": kernel_ms(lambda: kernels.counts_launch(*a, per_thread=P),
                                                    "chunk_list_kernel"),
                        "recounted": int(rc), "equal_to_plain": bool(same)}
                res["device_ms_by_shape"] = by
                res["default"] = f"P{kernels.count_per_thread(a[2].numel())}"
            out["counts"][label] = res
            del a, want, got
            torch.cuda.empty_cache()
    if "scan" in parts:
        for label, route, x in scan_cases(cs, gen, device):
            fn = scan.scan_block if route == "block" else scan.scan_tiled
            err = cs.rel_err(fn("filter", x).reshape(-1, x.shape[-1]),
                             scan.scan_plain("filter", x).reshape(-1, x.shape[-1]))
            name = "lookback_scan_kernel" if route == "block" else "tiled_scan_kernel"
            out["scan"][label] = {"kernel": route, "shape": list(x.shape), "rel_err": err,
                                  "device_ms": kernel_ms(lambda: fn("filter", x), name),
                                  "call_ms": cs.cuda_ms(lambda: fn("filter", x))}
            del x
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    bad = [k for k, v in out["counts"].items() if not v["equal_to_plain"]
           or not all(s["equal_to_plain"] for s in v.get("device_ms_by_shape", {}).values())]
    if bad:
        raise SystemExit(f"count_filter_launch_compare: counts differ from the plain ones at {bad}")


if __name__ == "__main__":
    main()
