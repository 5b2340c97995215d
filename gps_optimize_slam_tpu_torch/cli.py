"""Command-line front-end of the port (the ``fuse`` subcommand of
``gps_optimize_slam_tpu.cli``).

Replaces the reference's tkinter dialog flow (EKFGPSSLAM.py:669-674,
940-956) with one command:

    python -m gps_optimize_slam_tpu_torch fuse SLAM.tum GPS.txt [-o OUT] [--gt GT]
        [--device cuda|cpu] [--dtype float64|float32] [--frame auto|utm|enu]
        [--json] [--config cfg.json] [--rts-mode outage|full]
        [--ekf-scan auto|sequential|parallel]
        [--estimate-offset off|faithful|xcorr|xcorr_device] [--meas-noise SX SY SZ]
        [--no-gps-filter] [--robust [--robust-gate CHI2] [--robust-iters N]]
        [--chunked [--chunk-size N]]

It runs on the card and fails without one; ``--device cpu`` runs it on the
CPU. The JSON it prints has the keys of the JAX package's command.
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
    return 0


def _cmd_fuse_chunked(args, config, frame, dtype) -> int:
    """The out-of-core path of ``fuse --chunked``: trajectories larger than
    device memory stream through the device in chunks
    (``pipeline.fuse_files_chunked``); the ground-truth comparison and the
    χ² gate stream too."""
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
