"""End-to-end fusion of one KITTI sequence from files: fuse, evaluate
against ground-truth GNSS, export and plot (the reference's interactive run,
EKFGPSSLAM.py main_process_gui, as library calls).

    python -m gps_optimize_slam_tpu_torch.examples.fuse_kitti04 \\
        --slam SLAM.tum --gps GNSS.txt --gt GT_GNSS.txt [--out-dir DIR] [--device cpu]

``--gt`` is lon-first (the KITTI seq-04 ground-truth file's columns). The
working frame is UTM in float64, so the WGS84 export is written too. The
figure needs matplotlib.
"""

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slam", required=True, help="TUM-format SLAM trajectory")
    ap.add_argument("--gps", required=True, help="GNSS fixes: ts lat lon alt ...")
    ap.add_argument("--gt", required=True, help="ground-truth GNSS fixes, lon-first")
    ap.add_argument("--out-dir", default="fusion_out")
    ap.add_argument("--device", default=None, help="the card by default; cpu to run on the CPU")
    args = ap.parse_args(argv)

    from gps_optimize_slam_tpu_torch import pipeline, viz

    res = pipeline.fuse_files(slam_path=args.slam, gps_path=args.gps, frame="utm", gt_path=args.gt,
                              gt_lon_first=True, device=args.device)
    print(res.summary())
    os.makedirs(args.out_dir, exist_ok=True)
    utm_path = os.path.join(args.out_dir, "fused_traj.txt")
    wgs_path = os.path.join(args.out_dir, "fused_wgs84.txt")
    pipeline.export_result(res, utm_path=utm_path, wgs84_path=wgs_path)
    fig_path = os.path.join(args.out_dir, "overview.png")
    viz.plot_fusion_result(res, out_path=fig_path)
    print(f"wrote {utm_path}, {wgs_path}, {fig_path}")


if __name__ == "__main__":
    main()
