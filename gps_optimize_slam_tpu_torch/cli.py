"""Command-line front-end of the port (the ``fuse``, ``fuse-batch``,
``refine-graph``, ``kitti2tum`` and ``oxts-extract`` subcommands of
``gps_optimize_slam_tpu.cli``).

Replaces the reference's tkinter dialog flow (EKFGPSSLAM.py:669-674,
940-956) with one command:

    python -m gps_optimize_slam_tpu_torch fuse SLAM.tum GPS.txt [-o OUT] [--gt GT]
        [--device cuda|cpu] [--dtype float64|float32] [--frame auto|utm|enu]
        [--json] [--config cfg.json] [--rts-mode outage|full]
        [--ekf-scan auto|sequential|parallel]
        [--estimate-offset off|faithful|xcorr|xcorr_device] [--meas-noise SX SY SZ]
        [--no-gps-filter] [--robust [--robust-gate CHI2] [--robust-iters N]]
        [--chunked [--chunk-size N]] [--plot PNG] [--show]

and fuses many sequences as length-bucketed batched programs with

    python -m gps_optimize_slam_tpu_torch fuse-batch SLAM.tum:GPS.txt ... [-o OUT_DIR]
        [--device cuda|cpu] [--dtype float64|float32] [--frame auto|utm|enu]
        [--seed N] [--json] [--config cfg.json] [--rts-mode outage|full]
        [--ekf-scan auto|sequential|parallel] [--max-waste W]
        [--estimate-offsets] [--meas-noise SX SY SZ] [--no-gps-filter]

refines a fusion globally with the pose graph (Gauss-Newton + CG, loop
closures proposed by proximity) with

    python -m gps_optimize_slam_tpu_torch refine-graph SLAM.tum GPS.txt [-o OUT]
        [--device cuda|cpu] [--dtype float64|float32] [--frame auto|utm|enu]
        [--seed N] [--json] [--config cfg.json] [--iterations N] [--cg-iters N]
        [--no-loops] [--loop-radius M] [--loop-min-gap S] [--max-loops N]
        [--checkpoint-dir DIR]

These run on the card and fail without one; ``--device cpu`` runs them on
the CPU. ``--plot``/``--show`` need matplotlib (``viz``); with ``--chunked``
the figure is a decimated overview. The JSON they print has the keys of the JAX package's commands.
Two host-only converters take no device:

    python -m gps_optimize_slam_tpu_torch kitti2tum POSES TIMES OUT
    python -m gps_optimize_slam_tpu_torch oxts-extract OXTS_DIR [-o OUT]
        [--offset S] [--single-offset]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _build_config(args):
    """FusionConfig from --config JSON + individual flag overrides."""
    from gps_optimize_slam_tpu_torch.config import FusionConfig, config_from_dict

    if getattr(args, "config", None):
        with open(args.config) as f:
            config = config_from_dict(json.load(f))
    else:
        config = FusionConfig()
    if getattr(args, "rts_mode", None):
        config = config.replace(rts_mode=args.rts_mode)
    if getattr(args, "ekf_scan", None):
        config = config.replace(ekf_scan=args.ekf_scan)
    if getattr(args, "estimate_offset", None):
        config = config.replace(offset_mode=args.estimate_offset)
    if getattr(args, "meas_noise", None):
        config = config.replace(
            ekf=dataclasses.replace(config.ekf, meas_noise_diag=tuple(args.meas_noise))
        )
    if getattr(args, "no_gps_filter", False):
        config = config.replace(
            gps_filtering_ransac=dataclasses.replace(config.gps_filtering_ransac, enabled=False)
        )
    return config


def _resolve_frame(frame: str, dtype_name: str) -> str:
    """The working frame for the working precision: float64 defaults to the
    reference's UTM frame (the golden-accuracy path), float32 to the local
    ENU frame, since UTM's ~5e6 m northings eat the float32 mantissa; UTM
    forced in float32 gets a warning."""
    if dtype_name == "float64":
        return "utm" if frame == "auto" else frame
    resolved = "enu" if frame == "auto" else frame
    if resolved == "utm":
        print(
            "warning: UTM working frame in float32 loses ~0.5 m to coordinate "
            "quantisation; prefer --frame enu",
            file=sys.stderr,
        )
    return resolved


def _stats(s) -> dict:
    return {
        "mean_m": float(s.mean),
        "median_m": float(s.median),
        "rmse_m": float(s.rmse),
        "max_m": float(s.max),
        "count": int(s.count),
    }


def _nn_block(ev) -> dict:
    return {"slam": _stats(ev.nn_slam), "sim3": _stats(ev.nn_sim3), "ekf": _stats(ev.nn_ekf)}


def _ate_block(ev) -> dict:
    return {"sim3": _stats(ev.ate_sim3), "ekf": _stats(ev.ate_ekf)}


def _report(result, robust_accepted, gps_valid, extra=()) -> dict:
    """The JSON both fuse paths print: the same keys in the same order as
    the JAX package's command, ``extra`` after ``time_offset_s``."""
    out = {
        "poses": len(result.slam["timestamps"]),
        "gps_kept": int(result.gps.valid.sum()),
        "sim3_scale": result.sim3_scale,
        "time_offset_s": result.time_offset,
        **dict(extra),
        "nn_vs_primary": _nn_block(result.evaluation),
        "ate_vs_primary": _ate_block(result.evaluation),
    }
    if robust_accepted is not None:
        out["robust_accepted"] = int(robust_accepted.sum())
        out["robust_rejected"] = int((~robust_accepted & gps_valid).sum())
    if result.gt_evaluation is not None:
        out["nn_vs_ground_truth"] = _nn_block(result.gt_evaluation)
        out["ate_vs_ground_truth"] = _ate_block(result.gt_evaluation)
    return out


def _cmd_fuse(args) -> int:
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.utils.logging import enable as enable_logging

    if args.verbose:
        enable_logging()
    config = _build_config(args)
    frame = _resolve_frame(args.frame, args.dtype)
    dtype = getattr(torch, args.dtype)
    if args.chunked:
        return _cmd_fuse_chunked(args, config, frame, dtype)
    result = pipeline.fuse_files(
        args.slam,
        args.gps,
        config=config,
        frame=frame,
        seed=args.seed,
        dtype=dtype,
        device=args.device,
        gt_path=args.gt,
        robust=args.robust,
        robust_gate_chi2=args.robust_gate,
        robust_iterations=args.robust_iters,
    )
    if args.json:
        gps_valid = result.outputs.gps_valid.cpu().numpy()
        print(json.dumps(_report(result, result.robust_accepted, gps_valid), indent=2))
    else:
        print(result.summary())
    if args.output:
        wgs = None
        if frame == "utm":
            wgs = (
                args.output.replace("_utm.txt", "_wgs84.txt")
                if "_utm.txt" in args.output
                else args.output.rsplit(".", 1)[0] + "_wgs84.txt"
            )
        pipeline.export_result(result, args.output, wgs)
        print(f"saved: {args.output}" + (f" and {wgs}" if wgs else ""))
    if args.plot or args.show:
        from gps_optimize_slam_tpu_torch.viz import plot_fusion_result

        plot_fusion_result(result, args.plot, interactive=args.show, show=args.show)
        if args.plot:
            print(f"plot saved: {args.plot}")
    return 0


def _cmd_fuse_chunked(args, config, frame, dtype) -> int:
    """The out-of-core path of ``fuse --chunked``: trajectories larger than
    device memory stream through the device in chunks
    (``pipeline.fuse_files_chunked``); the ground-truth comparison and the
    χ² gate stream too. The figure of ``--plot``/``--show`` draws
    ``ChunkedPipelineResult.decimated_view`` (at most 5,000 poses; the
    exported TUM keeps every pose)."""
    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.io import tum as tum_io

    res = pipeline.fuse_files_chunked(
        args.slam,
        args.gps,
        config=config,
        frame=frame,
        seed=args.seed,
        chunk_size=args.chunk_size,
        dtype=dtype,
        device=args.device,
        gt_path=args.gt,
        robust=args.robust,
        robust_gate_chi2=args.robust_gate,
        robust_iterations=args.robust_iters,
    )
    if args.plot or args.show:
        from gps_optimize_slam_tpu_torch.viz import plot_fusion_result

        plot_fusion_result(res.decimated_view(), args.plot, interactive=args.show, show=args.show)
        if args.plot:
            print(f"plot saved: {args.plot} (decimated overview)")
    if args.json:
        extra = (("chunked", True), ("chunk_size", args.chunk_size))
        print(json.dumps(_report(res, res.result.robust_accepted, res.result.gps_valid, extra), indent=2))
    else:
        print(res.summary())
    if args.output:
        tum_io.write_tum(
            args.output, res.slam["timestamps"], res.result.corrected_pos, res.result.corrected_quat
        )
        print(f"saved: {args.output}")
    return 0


def _cmd_fuse_batch(args) -> int:
    """Batched multi-sequence fusion: each PAIR is "slam.tum:gps.txt".
    Sequences are length-bucketed (bounded padding waste), each bucket fused
    as one batched program on the card (``parallel.mesh.fuse_buckets``),
    and reported and exported per sequence. Exit code 1 unless every
    sequence's alignment succeeded."""
    import os

    import numpy as np
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.io import tum as tum_io
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh
    from gps_optimize_slam_tpu_torch.utils.logging import enable as enable_logging

    if args.verbose:
        enable_logging()
    config = _build_config(args)
    frame = _resolve_frame(args.frame, args.dtype)
    dtype = getattr(torch, args.dtype)

    slams, gts, gps_list, valids, names = [], [], [], [], []
    for pair in args.pairs:
        try:
            slam_path, gps_path = pair.rsplit(":", 1)
        except ValueError:
            print(f"bad pair {pair!r} (expected slam.tum:gps.txt)", file=sys.stderr)
            return 2
        slam = tum_io.read_tum(slam_path)
        gps = pipeline.load_and_project_gps(
            gps_path, config.gps_filtering_ransac, frame=frame, dtype=dtype, device=args.device
        )
        slams.append(slam)
        gts.append(gps.timestamps)
        gps_list.append(gps.positions)
        valids.append(gps.valid)
        names.append(slam_path)

    buckets = pbatch.bucket_by_length(slams, gts, gps_list, valids, max_waste=args.max_waste)
    per_seq = mesh.fuse_buckets(
        buckets, [args.seed + i for i in range(len(slams))], config=config, device=args.device,
        dtype=dtype, estimate_offsets=args.estimate_offsets,
    )

    rows = []
    for i, out in enumerate(per_seq):
        ts = np.asarray(slams[i]["timestamps"])
        gate = out.gps_valid & np.isfinite(out.aligned_gps).all(-1) & (ts > ts[0] + 5.0)
        err = np.linalg.norm(out.corrected_pos - out.aligned_gps, axis=-1)[gate]
        rows.append(
            {
                "slam": names[i],
                "poses": int(out.corrected_pos.shape[0]),
                "ok": bool(out.ok),
                "sim3_scale": round(float(out.sim3.scale), 6),
                "ate_rmse_m": round(float(np.sqrt(np.mean(err**2))), 4) if err.size else None,
                "ate_mean_m": round(float(err.mean()), 4) if err.size else None,
                "eval_points": int(err.size),
            }
        )
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            path = os.path.join(args.out_dir, f"seq{i:02d}_fused.txt")
            tum_io.write_tum(path, ts, out.corrected_pos, out.corrected_quat)
            rows[-1]["output"] = path

    if args.json:
        print(json.dumps({"sequences": rows, "buckets": len(buckets)}, indent=2))
    else:
        for r in rows:
            print(
                f"{r['slam']}: poses={r['poses']} ok={r['ok']} "
                f"scale={r['sim3_scale']} ate_rmse={r['ate_rmse_m']}m"
                + (f" -> {r['output']}" if "output" in r else "")
            )
    return 0 if all(r["ok"] for r in rows) else 1


def _cmd_refine_graph(args) -> int:
    """Fuse, then refine globally with the matrix-free Gauss-Newton pose
    graph (``models.pose_graph``) seeded from the fusion, with loop closures
    proposed by proximity over the fused trajectory."""
    import numpy as np
    import torch

    from gps_optimize_slam_tpu_torch import pipeline
    from gps_optimize_slam_tpu_torch.io import tum as tum_io
    from gps_optimize_slam_tpu_torch.utils.logging import enable as enable_logging

    if args.verbose:
        enable_logging()
    config = _build_config(args)
    frame = _resolve_frame(args.frame, args.dtype)
    result = pipeline.fuse_files(
        args.slam, args.gps, config=config, frame=frame, seed=args.seed, dtype=getattr(torch, args.dtype),
        device=args.device,
    )
    gn, loop_info = pipeline.refine_pose_graph(
        result,
        iterations=args.iterations,
        cg_iters=args.cg_iters,
        propose_loops=not args.no_loops,
        loop_radius=args.loop_radius,
        loop_min_time_gap=args.loop_min_gap,
        max_loops=args.max_loops,
        checkpoint_dir=args.checkpoint_dir,
    )
    costs = gn.cost_history.cpu().numpy()
    refined_pos = gn.state.positions.cpu().numpy()

    # ATE after refinement against the aligned GNSS (the gate of fuse-batch).
    ts = np.asarray(result.slam["timestamps"])
    aligned = result.outputs.aligned_gps.cpu().numpy()
    gate = result.outputs.gps_valid.cpu().numpy() & np.isfinite(aligned).all(-1) & (ts > ts[0] + 5.0)
    err = np.linalg.norm(refined_pos - aligned, axis=-1)[gate]
    ate_rmse = float(np.sqrt(np.mean(err**2))) if err.size else None

    report = {
        "poses": len(ts),
        "gn_iterations": args.iterations,
        "initial_cost": float(costs[0]),
        "final_cost": float(costs[-1]),
        "cost_reduction_pct": round(100.0 * (1.0 - float(costs[-1]) / max(float(costs[0]), 1e-30)), 2),
        "loops_proposed": loop_info["n_loops"],
        "loop_pairs": loop_info["loop_ij"],
        "ate_rmse_m": round(ate_rmse, 4) if ate_rmse is not None else None,
    }
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(
            f"pose graph: {report['poses']} poses, {report['loops_proposed']} loop closures, cost "
            f"{report['initial_cost']:.4g} -> {report['final_cost']:.4g} "
            f"({report['cost_reduction_pct']}%), ate_rmse={report['ate_rmse_m']}m"
        )
    if args.output:
        tum_io.write_tum(args.output, ts, refined_pos, gn.state.quaternions.cpu().numpy())
        print(f"saved: {args.output}")
    return 0


def _cmd_kitti2tum(args) -> int:
    from gps_optimize_slam_tpu_torch.io.kitti import kitti_to_tum_file

    kitti_to_tum_file(args.poses, args.times, args.out)
    print(f"wrote {args.out}")
    return 0


def _cmd_oxts(args) -> int:
    from gps_optimize_slam_tpu_torch.io.oxts import extract_oxts

    out = extract_oxts(
        args.oxts_dir, time_offset=args.offset, cumulative_offset=not args.single_offset, output_file=args.output
    )
    print(f"extracted {len(out['timestamps'])} fixes" + (f" -> {args.output}" if args.output else ""))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gps_optimize_slam_tpu_torch",
        description="GNSS+SLAM trajectory fusion on an NVIDIA GPU (PyTorch + CUDA)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fuse", help="fuse a SLAM trajectory with GNSS fixes")
    f.add_argument("slam", help="TUM-format SLAM trajectory")
    f.add_argument("gps", help="GNSS fixes: ts lat lon alt ...")
    f.add_argument("-o", "--output", help="output TUM path (working frame)")
    f.add_argument("--gt", help="ground-truth GNSS file (ts lon lat alt ...)")
    f.add_argument(
        "--device",
        default=None,
        help="where the fusion runs: the CUDA device by default (an error "
        "without one), or cpu",
    )
    f.add_argument(
        "--dtype",
        choices=["float64", "float32"],
        default="float64",
        help="working precision of the fusion",
    )
    f.add_argument(
        "--frame",
        choices=["auto", "utm", "enu"],
        default="auto",
        help="auto = UTM in float64, local ENU in float32",
    )
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--json", action="store_true", help="machine-readable output")
    f.add_argument("--plot", help="save a matplotlib overview figure (png)")
    f.add_argument(
        "--show",
        action="store_true",
        help="open the interactive figure (show/hide-layer CheckButtons; needs a GUI matplotlib backend)",
    )
    f.add_argument("-v", "--verbose", action="store_true", help="step logging")
    f.add_argument(
        "--config",
        help="JSON config file (reference CONFIG layout, see config_from_dict)",
    )
    f.add_argument(
        "--rts-mode",
        choices=["outage", "full"],
        help="RTS extent: outage segments only (reference) or full trajectory",
    )
    f.add_argument(
        "--ekf-scan",
        choices=["auto", "sequential", "parallel"],
        help="EKF scan strategy (auto = parallel off-CPU)",
    )
    f.add_argument(
        "--estimate-offset",
        choices=["off", "faithful", "xcorr", "xcorr_device"],
        help="clock-offset estimator (faithful = reference no-op, "
        "xcorr = functional speed-profile correlation, "
        "xcorr_device = same on the device via FFT)",
    )
    f.add_argument(
        "--meas-noise",
        type=float,
        nargs=3,
        metavar=("SX", "SY", "SZ"),
        help="override the GPS measurement-noise diagonal (m)",
    )
    f.add_argument(
        "--no-gps-filter",
        action="store_true",
        help="disable the polynomial-RANSAC GPS outlier gate",
    )
    f.add_argument(
        "--robust",
        action="store_true",
        help="χ²-gated robust fusion (NIS innovation gate, models.robust): "
        "rejects GNSS measurements inconsistent with the filter state",
    )
    f.add_argument(
        "--robust-gate",
        type=float,
        default=None,
        metavar="CHI2",
        help="χ² gate threshold (default: 95th pct of chi-square, 3 dof)",
    )
    f.add_argument(
        "--robust-iters",
        type=int,
        default=2,
        help="fixed-point iterations of the gate decisions",
    )
    f.add_argument(
        "--chunked",
        action="store_true",
        help="out-of-core streaming fusion for trajectories larger than "
        "device memory (O(chunk) device residency; models.fusion_chunked)",
    )
    f.add_argument(
        "--chunk-size",
        type=int,
        default=262144,
        help="poses per device chunk with --chunked",
    )
    f.set_defaults(fn=_cmd_fuse)

    fb = sub.add_parser(
        "fuse-batch",
        help="fuse many sequences, one batched program a length bucket",
    )
    fb.add_argument("pairs", nargs="+", metavar="SLAM:GPS", help="slam.tum:gps.txt pairs")
    fb.add_argument("-o", "--out-dir", help="write per-sequence fused TUM files here")
    fb.add_argument(
        "--device",
        default=None,
        help="where the fusion runs: the CUDA device by default (an error "
        "without one), or cpu",
    )
    fb.add_argument(
        "--dtype",
        choices=["float64", "float32"],
        default="float64",
        help="working precision of the fusion",
    )
    fb.add_argument(
        "--frame",
        choices=["auto", "utm", "enu"],
        default="auto",
        help="auto = UTM in float64, local ENU in float32",
    )
    fb.add_argument("--seed", type=int, default=0, help="sequence i takes RANSAC seed SEED + i")
    fb.add_argument("--json", action="store_true")
    fb.add_argument("-v", "--verbose", action="store_true")
    fb.add_argument("--config", help="JSON config file (reference CONFIG layout)")
    fb.add_argument("--rts-mode", choices=["outage", "full"])
    fb.add_argument("--ekf-scan", choices=["auto", "sequential", "parallel"])
    fb.add_argument(
        "--max-waste",
        type=float,
        default=2.0,
        help="length-bucketing waste bound (max_len/min_len per bucket)",
    )
    fb.add_argument(
        "--estimate-offsets",
        action="store_true",
        help="estimate per-sequence GPS clock offsets on the device (FFT xcorr)",
    )
    fb.add_argument("--meas-noise", type=float, nargs=3, metavar=("SX", "SY", "SZ"))
    fb.add_argument("--no-gps-filter", action="store_true")
    fb.set_defaults(fn=_cmd_fuse_batch)

    rg = sub.add_parser(
        "refine-graph",
        help="global pose-graph refinement (GN+CG) of a fusion result, with proximity-proposed loop closures",
    )
    rg.add_argument("slam", help="TUM-format SLAM trajectory")
    rg.add_argument("gps", help="GNSS fixes: ts lat lon alt ...")
    rg.add_argument("-o", "--output", help="output TUM path (refined trajectory)")
    rg.add_argument(
        "--device",
        default=None,
        help="where the fusion and the solve run: the CUDA device by default (an error without one), or cpu",
    )
    rg.add_argument(
        "--dtype", choices=["float64", "float32"], default="float64", help="working precision"
    )
    rg.add_argument(
        "--frame", choices=["auto", "utm", "enu"], default="auto", help="auto = UTM in float64, local ENU in float32"
    )
    rg.add_argument("--seed", type=int, default=0)
    rg.add_argument("--json", action="store_true")
    rg.add_argument("-v", "--verbose", action="store_true")
    rg.add_argument("--config", help="JSON config file (reference CONFIG layout)")
    rg.add_argument("--iterations", type=int, default=10, help="GN iterations")
    rg.add_argument("--cg-iters", type=int, default=50, help="CG iterations per GN step")
    rg.add_argument(
        "--no-loops", action="store_true", help="skip loop-closure proposal (GNSS priors + odometry only)"
    )
    rg.add_argument(
        "--loop-radius", type=float, default=5.0, help="max revisit distance (m) for a loop-closure candidate"
    )
    rg.add_argument(
        "--loop-min-gap", type=float, default=30.0, help="min elapsed time (s) between the two poses of a closure"
    )
    rg.add_argument("--max-loops", type=int, default=32)
    rg.add_argument("--checkpoint-dir", help="checkpoint/resume directory for the GN loop")
    rg.set_defaults(fn=_cmd_refine_graph)

    k = sub.add_parser("kitti2tum", help="KITTI poses+times -> TUM file (host only)")
    k.add_argument("poses")
    k.add_argument("times")
    k.add_argument("out")
    k.set_defaults(fn=_cmd_kitti2tum)

    o = sub.add_parser("oxts-extract", help="extract GNSS fixes from KITTI oxts/ (host only)")
    o.add_argument("oxts_dir")
    o.add_argument("-o", "--output")
    o.add_argument("--offset", type=float, default=0.0)
    o.add_argument(
        "--single-offset",
        action="store_true",
        help="apply the time offset once (the reference re-adds it every frame, quirk Q3; the default "
        "reproduces that)",
    )
    o.set_defaults(fn=_cmd_oxts)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
