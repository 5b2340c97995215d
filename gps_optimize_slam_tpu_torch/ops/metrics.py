"""Trajectory evaluation metrics, masked (port of
``gps_optimize_slam_tpu.ops.metrics``).

* ``nn_errors_auto``: distance from each trajectory point to its nearest
  valid interpolated-GPS candidate (the reference's metric, quirk Q6),
  through ``ops.kernels.nn_min_dist2`` on CUDA at every size (K3, or K4
  at a few query tiles against 524,288 candidates or more:
  ``kernels.nn_route``), and ``nn_errors``, the
  same by brute force;
* ``paired_errors``: timestamp-paired ATE;
* ``error_stats``: masked mean / median / RMSE / max.

Invalid entries carry +inf and are excluded from the statistics. Under a
leading batch axis (one sequence a row) every statistic is taken per row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gps_optimize_slam_tpu_torch.ops.kernels import nn_min_dist2, nn_min_dist2_plain


class ErrorStats(NamedTuple):
    mean: torch.Tensor
    median: torch.Tensor
    rmse: torch.Tensor
    max: torch.Tensor
    count: torch.Tensor


def eval_mask(slam_times: torch.Tensor, valid: torch.Tensor, skip_seconds: float = 5.0):
    """GPS-valid AND strictly later than t₀ + skip (reference
    EKFGPSSLAM.py:1021-1023), t₀ each row's first time."""
    return valid & (slam_times > slam_times[..., :1] + skip_seconds)


def nn_errors(
    traj: torch.Tensor,
    candidates: torch.Tensor,
    traj_mask: torch.Tensor,
    cand_mask: torch.Tensor,
) -> torch.Tensor:
    """Per-point distance to the nearest valid candidate by brute force
    (reference cdist→min, EKFGPSSLAM.py:1030-1031); +inf for masked points."""
    err = torch.sqrt(nn_min_dist2_plain(traj, candidates, cand_mask))
    return torch.where(traj_mask, err, float("inf"))


def nn_errors_auto(
    traj: torch.Tensor,
    candidates: torch.Tensor,
    traj_mask: torch.Tensor,
    cand_mask: torch.Tensor,
) -> torch.Tensor:
    """``nn_errors`` through ``ops.kernels.nn_min_dist2``: the pruned K3 or
    K4 kernel on CUDA tensors, the brute-force plain version on CPU ones.
    The JAX package's size cross-over (``PALLAS_NN_MIN_WORK``) was the TPU's
    and is not carried over."""
    err = torch.sqrt(nn_min_dist2(traj.contiguous(), candidates, cand_mask))
    return torch.where(traj_mask, err, float("inf"))


def paired_errors(traj: torch.Tensor, aligned_ref: torch.Tensor, mask: torch.Tensor):
    """Timestamp-paired position error ‖traj[i] − ref[i]‖ (standard ATE)."""
    ref = torch.nan_to_num(aligned_ref, nan=0.0)
    err = torch.sqrt(torch.sum((traj - ref) ** 2, dim=-1))
    return torch.where(mask, err, float("inf"))


def error_stats(errors: torch.Tensor, mask: torch.Tensor) -> ErrorStats:
    """Masked mean/median/RMSE/max over the valid entries (of each row)."""
    n = torch.sum(mask, -1)
    safe_n = torch.clamp(n, min=1)
    e = torch.where(mask, errors, 0.0)
    mean = torch.sum(e, -1) / safe_n
    rmse = torch.sqrt(torch.sum(e**2, -1) / safe_n)
    mx = torch.amax(torch.where(mask, errors, float("-inf")), -1)
    # Masked median: sort with +inf padding, average the two middle ranks.
    s = torch.sort(torch.where(mask, errors, float("inf")), dim=-1).values
    last = s.shape[-1] - 1

    def rank(k):
        return torch.gather(s, -1, torch.clamp(k, 0, last)[..., None])[..., 0]

    lo = rank(torch.div(n - 1, 2, rounding_mode="floor"))
    hi = rank(torch.div(n, 2, rounding_mode="floor"))
    return ErrorStats(mean=mean, median=(lo + hi) / 2.0, rmse=rmse, max=mx, count=n)
