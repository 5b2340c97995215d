"""Out-of-core fusion of a trajectory larger than device memory, from raw
(unaligned) GNSS: the whole pipeline streams host chunks through the device
(``models.fusion_chunked``: alignment over chunk + halo windows, the Sim(3)
window and streamed RANSAC, the re-entrant EKF + RTS), then the streamed
evaluation; device residency is O(chunk) whatever the length.

    python -m gps_optimize_slam_tpu_torch.examples.out_of_core_1m [--poses N] [--chunk C] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=1_000_000)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--device", default=None, help="the card by default; cpu to run on the CPU")
    args = ap.parse_args(argv)

    from gps_optimize_slam_tpu_torch.config import FusionConfig
    from gps_optimize_slam_tpu_torch.models import fusion_chunked
    from gps_optimize_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    n = args.poses
    rng = np.random.default_rng(0)
    t = np.arange(n) * 0.1
    yaw = np.cumsum(rng.normal(0.002, 0.01, n))
    heading = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n)], -1)
    pos = np.cumsum(0.3 * heading, 0)
    quat = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    # Raw GNSS on its own jittered 0.9 Hz clock, metric against the
    # 0.97-scaled monocular SLAM, 5 cm noise, 2 % invalid fixes and a ~60 s
    # outage: nothing is pre-aligned.
    m = int(n * 0.09)
    gt = np.sort(rng.uniform(t[0], t[-1], m))
    gp = np.stack([np.interp(gt, t, pos[:, k]) for k in range(3)], -1) + rng.normal(size=(m, 3)) * 0.05
    gv = np.ones(m, bool)
    gv[rng.choice(m, m // 50, replace=False)] = False
    gv[m // 3 : m // 3 + 60] = False
    slam_pos = pos * 0.97

    t0 = time.perf_counter()
    out = fusion_chunked.fuse_core_chunked(t, slam_pos, quat, gt, gp, gv, seed=0, config=FusionConfig(),
                                           chunk_size=args.chunk, dtype=torch.float64, device=device)
    dt = time.perf_counter() - t0
    scale = float(out.sim3.scale)
    if not (out.ok and np.isfinite(out.corrected_pos).all() and abs(scale - 1.0 / 0.97) < 0.01):
        raise RuntimeError(f"fusion failed: ok={out.ok}, scale {scale}")
    print(f"{n} poses + {m} raw GNSS fixes through {args.chunk}-pose chunks on {device}: {dt:.1f} s "
          f"({n / dt:,.0f} poses/s with host streaming); sim3 scale {scale:.4f}, "
          f"{int(out.gps_valid.sum())} aligned samples")

    t0 = time.perf_counter()
    ev = fusion_chunked.evaluate_chunked(t, slam_pos, quat, out, chunk_size=args.chunk, dtype=torch.float64,
                                         device=device)
    dt = time.perf_counter() - t0
    # ATE against the noisy, interpolated 0.9 Hz GNSS itself: ~1 m is its floor.
    print(f"streamed evaluation in {dt:.1f} s: EKF NN rmse {float(ev.nn_ekf.rmse):.3f} m "
          f"(mean {float(ev.nn_ekf.mean):.3f}), ATE rmse {float(ev.ate_ekf.rmse):.3f} m "
          f"over {int(ev.nn_ekf.count)} points")
    if not float(ev.ate_ekf.rmse) < 3.0:
        raise RuntimeError(f"ATE rmse {float(ev.ate_ekf.rmse):.3f} m")


if __name__ == "__main__":
    main()
