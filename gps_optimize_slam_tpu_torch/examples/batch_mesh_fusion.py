"""Batched multi-sequence fusion over a mesh of devices: sequences of mixed
lengths bucketed by length, each bucket's rows sharded over the mesh, each
device fusing its shard as one batched program, with the per-sequence GNSS
clock offsets estimated on the device.

    python -m gps_optimize_slam_tpu_torch.examples.batch_mesh_fusion [--device DEV] [--mesh-size K]

Without ``--device`` the mesh is the first K cards (all of them by default);
with it, K blocks on that one device (``--device cpu --mesh-size 4`` runs the
sharded code on the CPU, ``--device cuda:0 --mesh-size 4`` on one card).
"""

import argparse

import numpy as np


def synthetic_sequence(n: int, seed: int):
    """A drive of ``n`` poses at 10 Hz with a monocular scale of 1/1.02 and
    5 cm GNSS noise: (slam dict, GNSS times, GNSS positions)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    yaw = np.cumsum(rng.normal(0.02, 0.02, n))
    heading = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n)], -1)
    pos = np.cumsum(0.5 * heading, axis=0)
    quat = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    m = int(n * 1.05)
    gt = np.linspace(t[0], t[-1], m)
    gp = np.stack([np.interp(gt, t, pos[:, k]) for k in range(3)], -1)
    gp = gp * 1.02 + rng.normal(size=(m, 3)) * 0.05
    return {"timestamps": t, "positions": pos, "quaternions": quat}, gt, gp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="one device for every block of the mesh (e.g. cpu, cuda:0)")
    ap.add_argument("--mesh-size", type=int, default=None, help="devices (or blocks) of the mesh")
    ap.add_argument("--lengths", type=int, nargs="+", default=[240, 260, 250, 900, 870])
    args = ap.parse_args(argv)

    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh as pmesh

    seqs = [synthetic_sequence(n, seed=i) for i, n in enumerate(args.lengths)]
    if args.device is None:
        mesh = pmesh.make_mesh(n_devices=args.mesh_size)
    else:
        mesh = pmesh.make_mesh(devices=[args.device] * (args.mesh_size or 1))
    print(f"mesh: {mesh.size} x {sorted({str(d) for d in mesh.devices})}")
    buckets = pbatch.bucket_by_length([s for s, _, _ in seqs], [t for _, t, _ in seqs], [p for _, _, p in seqs],
                                      max_waste=2.0)
    print(f"buckets: {[idx.tolist() for idx, _ in buckets]}")
    for i, out in enumerate(pmesh.fuse_buckets(buckets, mesh=mesh, estimate_offsets=True)):
        print(f"seq {i}: poses={out.corrected_pos.shape[0]} scale={float(out.sim3.scale):.4f} ok={bool(out.ok)}")


if __name__ == "__main__":
    main()
