#!/usr/bin/env python3
"""The chunk streams of one checkout of the port (``utils.streaming`` and
the paths that stream through it), timed on one NVIDIA GPU at the sizes of
``chip_smoke.py``, to compare two checkouts in one run.

Imports ``gps_optimize_slam_tpu_torch`` from ``--root`` (a checkout's root;
the kernels build into its own ``build/kernels``) and writes one JSON
object to ``--out`` with, per case:

* ``walls_ms``: warm walls of the call, its programs captured before
  (``utils.graphs``: two calls before the clock), each synchronised;
* ``profile``: one traced call (``chip_smoke.stream_profile``): the wall,
  kernel and busy device ms, the device's idle share, and for each kind of
  copy (host to device or back, pinned or pageable) its count, device ms,
  bytes and GB/s, and the device ms in which a copy ran beside a kernel;
* ``pinned_mb``: the pinned host memory PyTorch's host allocator holds
  after the case (``chip_smoke.pinned_mb``);

and saves each case's results (host arrays) under ``--arrays`` for the
comparison. The cases: ``fuse``, phase 5's ``fuse_core_chunked`` at
``--poses`` (1,048,576) in ``--chunk`` (524,288) pose chunks, float64;
``evaluate``, its ``evaluate_chunked``; ``robust``, phase 6's robust chunked
fusion (dirty GNSS, at most 16 gate passes); ``buckets``, phase 7's
``fuse_buckets`` of the eleven KITTI sequences in three buckets
(``--buckets small``: four short replica sequences in three buckets, for a
CPU rehearsal). The same inputs for every checkout, from the seeds of
``chip_smoke.py``.

``--table OUT F1 F2 ...`` reads the files of such runs and writes to OUT
each case's walls, copies and idle share by run, and each run's largest
difference from the first run's results (``bit_equal`` where none).

Run from the repository root on the card, a parent checkout unpacked under
``build/`` (``git archive PARENT | tar -x -C build/parent``), in turns:

    python3 tools/stream_launch_compare.py --root build/parent --out build/stream/p1.json
    python3 tools/stream_launch_compare.py --root . --out build/stream/t1.json
    python3 tools/stream_launch_compare.py --root . --out build/stream/t2.json
    python3 tools/stream_launch_compare.py --root build/parent --out build/stream/p2.json
    python3 tools/stream_launch_compare.py --table build/stream/table.json build/stream/{p1,t1,t2,p2}.json

On the CPU (no timing; a rehearsal and a check that the results agree):
``--device cpu --poses 20000 --chunk 4095 --buckets small``.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_BUCKETS = ((1101, 1), (2801, 2), (1201, 3), (5001, 4))  # (poses, seed): three buckets at max_waste 1.5


def load_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its inputs and profilers),
    whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tool", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cases(cs, args, device):
    """(name, call, results → dict of host arrays) of every case."""
    import torch

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion_chunked
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    f64 = torch.float64
    cfg = FusionConfig(gps_sorted=True)
    slam, gt, gp = cs.outage_sequence(args.poses)
    st, sp, sq = slam["timestamps"], slam["positions"], slam["quaternions"]
    gv = np.ones(len(gt), bool)

    def fuse():
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, gp, gv, seed=0, config=cfg, chunk_size=args.chunk,
                                                dtype=f64, device=device)

    def fused(r):
        return {"corrected_pos": r.corrected_pos, "corrected_quat": r.corrected_quat, "aligned_gps": r.aligned_gps,
                "gps_valid": r.gps_valid, "scale": np.asarray(float(r.sim3.scale))}

    res = fuse()

    def evaluate():
        return fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=args.chunk, dtype=f64, device=device)

    def evaluated(ev):
        return {f"{p}.{f}": np.asarray(float(getattr(getattr(ev, p), f)))
                for p in ev._fields for f in ("mean", "median", "rmse", "max", "count")}

    bad, bad_valid, _ = cs.faulty_gnss(gt, gp, st, seed=7, fraction=0.005)

    def robust():
        return fusion_chunked.fuse_core_chunked(st, sp, sq, gt, bad, bad_valid, seed=0, config=cfg,
                                                chunk_size=args.chunk, dtype=f64, robust=True,
                                                robust_iterations=cs.ROBUST_PASSES, device=device)

    def robust_fused(r):
        return {**fused(r), "robust_accepted": r.robust_accepted}

    if args.buckets == "kitti":
        seqs = [(s, t, p) for s, t, p, _ in cs.kitti_sequences()]
        waste = 2.0
    else:
        seqs = [cs.replica_sequence(n, seed=s) for n, s in SMALL_BUCKETS]
        waste = 1.5
    buckets = pbatch.bucket_by_length([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs],
                                      max_waste=waste)
    seeds = np.arange(len(seqs))

    def sweep():
        return mesh.fuse_buckets(buckets, seeds, config=FusionConfig(), device=device, dtype=f64)

    def swept(rows):
        return {f"{k}/{i}": np.asarray(getattr(r, k)) for i, r in enumerate(rows)
                for k in ("corrected_pos", "corrected_quat", "sim3_inliers", "gps_valid", "ok")}

    return [("fuse", fuse, fused), ("evaluate", evaluate, evaluated), ("robust", robust, robust_fused),
            ("buckets", sweep, swept)], len(buckets)


def run(args) -> None:
    cs = load_chip_smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from gps_optimize_slam_tpu_torch.ops import _build
    from gps_optimize_slam_tpu_torch.utils import streaming

    if not streaming.__file__.startswith(root + os.sep):
        raise SystemExit(f"stream_launch_compare: imported {streaming.__file__}, not the checkout at {root}")
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("stream_launch_compare: no CUDA device")
    if on_card:
        _build.library()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = {"root": args.root, "device": str(device), "poses": args.poses, "chunk": args.chunk,
           "nvidia_smi": cs.nvidia_smi() if on_card else None, "torch": torch.__version__,
           "has_fetch": hasattr(streaming, "fetch"), "cases": {}}
    os.makedirs(args.arrays, exist_ok=True)
    todo, out["buckets"] = cases(cs, args, device)
    for name, call, results in todo:
        call()
        result = call()  # the second call captures the programs of the first
        walls = []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
        case = {"walls_ms": walls, "median_ms": float(np.median(walls))}
        if on_card:
            case["profile"] = cs.stream_profile(call)
            case["pinned_mb"] = cs.pinned_mb()
        np.savez(os.path.join(args.arrays, f"{name}.npz"), **results(result))
        out["cases"][name] = case
        print(json.dumps({"case": name, "median_ms": case["median_ms"]}), flush=True)
    out["arrays"] = os.path.abspath(args.arrays)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


def largest_gap(a, b) -> float:
    """The largest absolute difference of two arrays (NaN equal to NaN);
    inf where their shapes or dtypes differ."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.dtype.kind in "biu":
        return float(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return float(np.where(same, 0.0, np.abs(a - b)).max(initial=0.0))


def table(out_path, files) -> None:
    runs = []
    for path in files:
        with open(path) as f:
            runs.append((os.path.splitext(os.path.basename(path))[0], json.load(f)))
    first_tag, first = runs[0]
    rows = {}
    for tag, r in runs:
        for name, case in r["cases"].items():
            row = {"root": r["root"], "median_ms": case["median_ms"], "walls_ms": case["walls_ms"]}
            prof = case.get("profile")
            if prof:
                row.update(idle_share=prof["idle_share"], kernel_ms=prof["kernel_ms"], busy_ms=prof["busy_ms"],
                           profiled_wall_ms=prof["wall_ms"], copy_beside_kernel_ms=prof["copy_beside_kernel_ms"],
                           copies=prof["copies"], pinned_mb=case.get("pinned_mb"))
            ref = np.load(os.path.join(first["arrays"], f"{name}.npz"))
            got = np.load(os.path.join(r["arrays"], f"{name}.npz"))
            gaps = {k: largest_gap(got[k], ref[k]) for k in ref.files}
            row[f"largest_gap_to_{first_tag}"] = max(gaps.values(), default=0.0)
            row["bit_equal"] = set(got.files) == set(ref.files) and all(
                np.array_equal(got[k], ref[k], equal_nan=got[k].dtype.kind == "f") for k in ref.files)
            rows.setdefault(name, {})[tag] = row
    result = {"nvidia_smi": first.get("nvidia_smi"), "poses": first["poses"], "chunk": first["chunk"],
              "buckets": first["buckets"], "cases": rows}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    for name, by_run in rows.items():
        print(json.dumps({"case": name, **{tag: {k: v for k, v in row.items() if k not in ("walls_ms", "copies")}
                                           for tag, row in by_run.items()}}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose port to time")
    ap.add_argument("--out", help="the JSON file to write")
    ap.add_argument("--arrays", help="where to save the results (default: beside --out, a folder named as it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--poses", type=int, default=1_048_576)
    ap.add_argument("--chunk", type=int, default=524_288)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--buckets", choices=("kitti", "small"), default="kitti")
    ap.add_argument("--table", nargs="+", metavar=("OUT", "FILE"), help="compare the runs in FILE ...; write OUT")
    args = ap.parse_args()
    if args.table:
        table(args.table[0], args.table[1:])
        return
    if not args.out:
        ap.error("--out is required")
    args.arrays = args.arrays or os.path.splitext(args.out)[0] + "_arrays"
    run(args)


if __name__ == "__main__":
    main()
