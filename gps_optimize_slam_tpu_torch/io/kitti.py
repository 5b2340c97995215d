"""KITTI odometry pose files → TUM trajectories (port of
``gps_optimize_slam_tpu.io.kitti``; NumPy, on the host).

Replaces the reference's kitti2tum.py without the ``evo`` dependency: a
KITTI pose file has 12 columns a row, the row-major 3×4 [R|t] camera pose,
and a separate one-column timestamp file."""

from __future__ import annotations

from typing import Dict

import numpy as np

from gps_optimize_slam_tpu_torch.io.native import loadtxt


def read_kitti_poses(path: str) -> np.ndarray:
    """Load a KITTI pose file → (N, 3, 4) [R|t] matrices."""
    data = loadtxt(path)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    if data.shape[1] != 12:
        raise ValueError(f"KITTI pose file must have 12 columns, got {data.shape[1]}: {path}")
    return data.reshape(-1, 3, 4)


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrices → xyzw quaternions (Shepperd, NumPy), w ≥ 0."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    qx = np.stack([1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], -1)
    qy = np.stack([m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20], -1)
    qz = np.stack([m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01], -1)
    qw = np.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], -1)
    d = np.stack([1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22, 1 + tr], -1)
    cands = np.stack([qx, qy, qz, qw], axis=1)
    choice = np.argmax(d, axis=-1)
    q = cands[np.arange(len(R)), choice]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.where(q[:, 3:4] < 0, -1.0, 1.0)
    return q


def kitti_to_trajectory(poses_path: str, timestamps_path: str) -> Dict[str, np.ndarray]:
    """KITTI poses + timestamps → TUM-style trajectory dict (the reference's
    kitti_poses_and_timestamps_to_trajectory, kitti2tum.py:11-21)."""
    poses = read_kitti_poses(poses_path)
    ts = loadtxt(timestamps_path)
    if ts.ndim != 1:
        ts = ts.reshape(-1)
    if len(ts) != len(poses):
        raise ValueError(
            "timestamp file must have one column with the same number of rows "
            f"as the pose file ({len(ts)} vs {len(poses)})"
        )
    return {
        "timestamps": ts.astype(float),
        "positions": poses[:, :, 3].astype(float),
        "quaternions": _rotmat_to_quat(poses[:, :, :3]),
    }


def kitti_to_tum_file(poses_path: str, timestamps_path: str, out_path: str) -> None:
    """What ``python kitti2tum.py poses times out`` does: write the TUM file."""
    from gps_optimize_slam_tpu_torch.io.tum import write_tum

    traj = kitti_to_trajectory(poses_path, timestamps_path)
    write_tum(out_path, traj["timestamps"], traj["positions"], traj["quaternions"])
