"""The fusion model: Sim(3) global alignment + EKF/RTS local fusion (port of
``gps_optimize_slam_tpu.models.fusion``).

Given SLAM and GPS tensors on one device, ``fuse_core`` runs temporal
alignment, Sim3 window selection, RANSAC + Umeyama alignment, the trajectory
transform, the EKF forward pass and the outage-gated RTS smoothing: the
reference's recipe (main_process_gui, EKFGPSSLAM.py:940-1123) minus host I/O.
The alignment is computed once and reused (the reference recomputes it,
quirk Q9). ``evaluate`` gives the reference's NN metric and the paired ATE.

Both take a leading batch axis, one padded sequence a row (the JAX
package vmaps them, ``parallel/mesh.py``): every stage is then issued once
for all rows, and its kernels launch once with a grid over the rows. Every
leaf of ``FusionOutputs`` and ``Evaluation`` gains the leading B.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.ops import (
    alignment,
    kalman,
    kalman_parallel,
    metrics,
    ransac,
    se3,
)
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.utils import graphs, profiling


class FusionOutputs(NamedTuple):
    """Everything the evaluation and export layers need."""

    corrected_pos: torch.Tensor  # (N,3) EKF+RTS fused trajectory
    corrected_quat: torch.Tensor  # (N,4)
    sim3_pos: torch.Tensor  # (N,3) Sim3-aligned trajectory (EKF input)
    sim3_quat: torch.Tensor  # (N,4)
    sim3: Sim3  # global transform (R, t, scale, ok)
    sim3_inliers: torch.Tensor  # (N,) bool RANSAC inliers within the window
    aligned_gps: torch.Tensor  # (N,3) GPS interpolated to SLAM timestamps
    gps_valid: torch.Tensor  # (N,) bool
    ok: torch.Tensor  # () bool — pipeline succeeded


def resolve_platform(config: FusionConfig, device: torch.device) -> FusionConfig:
    """``platform="auto"`` → "gpu" for CUDA tensors, "cpu" otherwise."""
    if config.platform != "auto":
        return config
    return config.replace(platform="gpu" if device.type == "cuda" else "cpu")


def ekf_fuse_fn(config: FusionConfig):
    """The EKF + RTS function a resolved ``config`` takes: ``ekf_scan="auto"``
    is the parallel scans off-CPU and the sequential filter on the CPU (the
    JAX package's rule), and the sequential filter whenever transition
    blending is on."""
    use_parallel = config.ekf_scan == "parallel" or (
        config.ekf_scan == "auto"
        and config.rts_decision.default_ekf_transition_steps_on_sharp_turn == 0
        and config.platform != "cpu"
    )
    return kalman_parallel.fuse_ekf_rts_parallel if use_parallel else kalman.fuse_ekf_rts


def fuse_core(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    slam_quat: torch.Tensor,
    gps_times: torch.Tensor,
    gps_positions: torch.Tensor,
    gps_valid: torch.Tensor,
    config: FusionConfig = FusionConfig(),
    seed=0,
    slam_mask: Optional[torch.Tensor] = None,
    time_offset=0.0,
    sim3_draws: Optional[torch.Tensor] = None,
) -> FusionOutputs:
    """Full fusion of one sequence; every tensor on one device. Invalid GPS
    samples are masked by ``gps_valid`` (the outlier gate's output).

    ``slam_mask`` marks real (unpadded) SLAM poses; padded ones are forced
    GPS-invalid. ``seed`` seeds the RANSAC generator on the tensors' device;
    ``sim3_draws`` replaces its draws (see ``ops.ransac.sim3_ransac``).
    The EKF + RTS function follows ``ekf_fuse_fn``.

    A batch of B padded sequences (slam (B, N), (B, N, 3), (B, N, 4); GPS
    (B, M), (B, M, 3), (B, M); ``slam_mask`` (B, N)) is fused as one
    program: ``time_offset`` is then a float or a (B,) tensor, ``seed`` an
    int or B ints (one a row) and ``sim3_draws`` (B, trials, k).

    On a card the fusion is one captured program (``utils.graphs``) a
    config and shape, as the JAX package jits ``_fuse_core``: the seeded
    generators draw their uniforms before it, and the offset enters as a
    device tensor.
    """
    config = resolve_platform(config, slam_pos.device)
    device = slam_pos.device
    if not torch.is_tensor(time_offset):
        time_offset = torch.full((), float(time_offset), dtype=torch.float64, device=device)
    uniforms = None
    if sim3_draws is None:
        with profiling.span("fuse.uniforms"):
            uniforms = ransac.seeded_uniforms(seed, tuple(slam_pos.shape[:-2]),
                                              ransac.sim3_trials(config.sim3_ransac),
                                              config.sim3_ransac.min_samples, device)
    else:
        sim3_draws = sim3_draws.to(device)
    return graphs.run(_fuse_core, slam_times, slam_pos, slam_quat, gps_times, gps_positions, gps_valid,
                      slam_mask, time_offset.to(device), sim3_draws, uniforms, config)


def _fuse_core(slam_times, slam_pos, slam_quat, gps_times, gps_positions, gps_valid, slam_mask, time_offset,
               sim3_draws, uniforms, config: FusionConfig) -> FusionOutputs:
    """The program of :func:`fuse_core`: RANSAC takes ``sim3_draws``, or
    the draws scaled from ``uniforms``. Traced, its five stages lie between
    device marks (``utils.profiling``): alignment, Sim(3) window, RANSAC,
    transform, EKF/RTS."""
    device = slam_pos.device
    with profiling.device_span("fuse.alignment", device):
        aligned = alignment.align_gps_to_slam(
            slam_times,
            gps_times,
            gps_positions,
            gps_valid=gps_valid,
            time_offset=time_offset,
            cfg=config.time_alignment,
            assume_sorted=config.gps_sorted,
        )
        if slam_mask is not None:
            aligned = alignment.AlignedGPS(
                aligned=torch.where(slam_mask[..., None], aligned.aligned, float("nan")),
                valid=aligned.valid & slam_mask,
            )
    with profiling.device_span("fuse.sim3_window", device):
        window = alignment.sim3_window_mask(
            slam_times,
            aligned.valid,
            gap_threshold=config.time_alignment.max_gps_gap_threshold,
            max_duration=config.sim3_ransac.max_initial_duration,
            min_samples=config.sim3_ransac.min_samples,
        )
    with profiling.device_span("fuse.ransac", device):
        sim3_res = ransac.sim3_ransac(
            slam_pos,
            torch.nan_to_num(aligned.aligned, nan=0.0),
            valid=window,
            cfg=config.sim3_ransac,
            draws=sim3_draws,
            uniforms=uniforms,
        )
    sim3 = sim3_res.sim3
    with profiling.device_span("fuse.transform", device):
        sim3_pos, sim3_quat = se3.transform_trajectory(slam_pos, slam_quat, sim3.R, sim3.t, sim3.scale)

    with profiling.device_span("fuse.ekf_rts", device):
        corrected_pos, corrected_quat = ekf_fuse_fn(config)(
            slam_times,
            slam_pos,
            slam_quat,
            sim3_pos,
            sim3_quat,
            aligned.aligned,
            aligned.valid,
            config.ekf,
            config.rts_decision,
            rts_mode=config.rts_mode,
        )
    return FusionOutputs(
        corrected_pos=corrected_pos,
        corrected_quat=corrected_quat,
        sim3_pos=sim3_pos,
        sim3_quat=sim3_quat,
        sim3=sim3,
        sim3_inliers=sim3_res.inlier_mask,
        aligned_gps=aligned.aligned,
        gps_valid=aligned.valid,
        ok=sim3_res.ok,
    )


class Evaluation(NamedTuple):
    nn_slam: metrics.ErrorStats
    nn_sim3: metrics.ErrorStats
    nn_ekf: metrics.ErrorStats
    ate_sim3: metrics.ErrorStats
    ate_ekf: metrics.ErrorStats


def _evaluate_against(slam_times, slam_pos, sim3_pos, corrected_pos, aligned, valid, skip_seconds) -> Evaluation:
    """NN and paired-ATE stats of the raw SLAM / Sim3-aligned / EKF-fused
    trajectories against the track ``(aligned, valid)`` on the SLAM
    timestamps, with the post-skip gate. The three NN evaluations go through
    K3 (or K4) on CUDA. Traced, the three NN evaluations and the two ATEs
    lie between device marks (``utils.profiling``): ``eval.nn_slam``,
    ``eval.nn_sim3``, ``eval.nn_ekf`` and ``eval.ate`` (the gate's mask and
    the candidates before the first)."""
    device = slam_pos.device
    gate = metrics.eval_mask(slam_times, valid, skip_seconds)
    cands = torch.nan_to_num(aligned, nan=0.0)

    def nn(traj, name):
        with profiling.device_span(name, device):
            e = metrics.nn_errors_auto(traj, cands, gate, gate)
            return metrics.error_stats(e, gate)

    def ate(traj):
        return metrics.error_stats(metrics.paired_errors(traj, aligned, gate), gate)

    nn_slam = nn(slam_pos, "eval.nn_slam")
    nn_sim3 = nn(sim3_pos, "eval.nn_sim3")
    nn_ekf = nn(corrected_pos, "eval.nn_ekf")
    with profiling.device_span("eval.ate", device):
        ate_sim3, ate_ekf = ate(sim3_pos), ate(corrected_pos)
    return Evaluation(nn_slam=nn_slam, nn_sim3=nn_sim3, nn_ekf=nn_ekf, ate_sim3=ate_sim3, ate_ekf=ate_ekf)


def evaluate(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    outputs: FusionOutputs,
    skip_seconds: float = 5.0,
) -> Evaluation:
    """Reference-metric (NN, post-5 s — quirk Q6) and paired-ATE stats for
    raw SLAM / Sim3-aligned / EKF-fused trajectories against the aligned GPS.
    One captured program a shape on a card (``utils.graphs``)."""
    return graphs.run(_evaluate_against, slam_times, slam_pos, outputs.sim3_pos, outputs.corrected_pos,
                      outputs.aligned_gps, outputs.gps_valid, skip_seconds)


def _evaluate_vs_track(slam_times, slam_pos, sim3_pos, corrected_pos, track_times, track_positions, track_valid,
                       time_alignment, skip_seconds):
    al = alignment.align_gps_to_slam(slam_times, track_times, track_positions, gps_valid=track_valid,
                                     cfg=time_alignment)
    return _evaluate_against(slam_times, slam_pos, sim3_pos, corrected_pos, al.aligned, al.valid, skip_seconds), al


def evaluate_vs_track(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    outputs: FusionOutputs,
    track_times: torch.Tensor,
    track_positions: torch.Tensor,
    track_valid: torch.Tensor,
    cfg: FusionConfig = FusionConfig(),
    skip_seconds: float = 5.0,
):
    """Evaluation against an INDEPENDENT reference track (e.g. ground-truth
    GNSS), reference EKFGPSSLAM.py:1044-1067: the track is temporally
    aligned onto the SLAM timestamps (its spline scans go through K1) and
    the same NN/ATE statistics are computed for raw SLAM / Sim3 / EKF.
    Returns ``(Evaluation, AlignedGPS)``; the aligned track is what a plot
    overlays (EKFGPSSLAM.py:1069-1082). One captured program a shape on a
    card (``utils.graphs``)."""
    return graphs.run(_evaluate_vs_track, slam_times, slam_pos, outputs.sim3_pos, outputs.corrected_pos,
                      track_times, track_positions, track_valid, cfg.time_alignment, skip_seconds)
