"""SE(3)/Sim(3) pose operations on tensors (port of
``gps_optimize_slam_tpu.ops.se3``). Trajectories are (..., N, 3) and
(..., N, 4): a leading batch axis holds one sequence a row."""

from __future__ import annotations

from typing import Tuple

import torch

from gps_optimize_slam_tpu_torch.ops import quaternion as quat

_EPS_NORM = 1e-9


def relative_pose(
    pos1: torch.Tensor, quat1: torch.Tensor, pos2: torch.Tensor, quat2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative motion pose1 → pose2 in pose1's frame:
    Δp = R(q1)⁻¹ (p2 − p1), Δq = q1⁻¹ ⊗ q2. Degenerate (near-zero-norm)
    quaternions give zero motion (reference EKFGPSSLAM.py:84-86)."""
    valid = (quat.norm(quat1) > _EPS_NORM) & (quat.norm(quat2) > _EPS_NORM)
    q1_inv = quat.conj(quat.normalize(quat1))
    delta_pos_local = quat.rotate(q1_inv, pos2 - pos1)
    delta_q = quat.mul(q1_inv, quat.normalize(quat2))
    v = valid[..., None]
    return (
        torch.where(v, delta_pos_local, torch.zeros_like(delta_pos_local)),
        torch.where(v, delta_q, quat.identity_like(delta_q)),
    )


def relative_poses_along(
    positions: torch.Tensor, quaternions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta_pos[N-1,3], delta_quat[N-1,4]): motion pose i → pose i+1 in
    pose i's frame, the EKF's motion input (reference EKFGPSSLAM.py:866),
    along the time axis -2 of (..., N, 3) and (..., N, 4)."""
    return relative_pose(
        positions[..., :-1, :], quaternions[..., :-1, :], positions[..., 1:, :], quaternions[..., 1:, :]
    )


def compose(
    pos: torch.Tensor, q: torch.Tensor, delta_pos_local: torch.Tensor, delta_q: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose a local-frame motion onto a pose (EKF predict, reference
    EKFGPSSLAM.py:702-711)."""
    new_pos = pos + quat.rotate(q, delta_pos_local)
    new_q = quat.normalize(quat.mul(q, delta_q))
    return new_pos, new_q


def transform_trajectory(
    positions: torch.Tensor,
    quaternions: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    scale,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """p' = s · p Rᵀ + t; q' = quat(R) ⊗ q (reference EKFGPSSLAM.py:461-467).
    A batch of sequences, (B, N, 3) and (B, N, 4), takes one transform a
    row: R (B, 3, 3), t (B, 3), scale (B,)."""
    if torch.is_tensor(scale):
        scale = scale[..., None, None]
    new_pos = scale * (positions @ R.transpose(-1, -2)) + t[..., None, :]
    new_quat = quat.mul(quat.from_matrix(R)[..., None, :], quaternions)
    return new_pos, new_quat
