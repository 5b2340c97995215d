"""Configuration dataclasses of the PyTorch port.

Field for field the same as ``gps_optimize_slam_tpu.config`` (names, types
and defaults), so ``config_from_dict(dataclasses.asdict(jax_cfg))`` rebuilds
an equal config. They mirror the six sections of the reference's CONFIG dict
(reference: EKFGPSSLAM.py:22-71). Frozen dataclasses of Python scalars and
tuples; noise tuples become tensors where they are used.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """EKF noise/transition parameters (reference: EKFGPSSLAM.py:24-30)."""

    # Initial covariance diagonal for state [x y z qx qy qz qw].
    initial_cov_diag: Tuple[float, ...] = (0.1, 0.1, 0.1, 0.01, 0.01, 0.01, 0.01)
    # Per-second process noise diagonal.
    process_noise_diag: Tuple[float, ...] = (0.1, 0.1, 0.7, 0.01, 0.01, 0.01, 0.01)
    # GPS x/y/z measurement noise (diagonal of R).
    meas_noise_diag: Tuple[float, ...] = (0.2, 0.2, 0.2)
    # Smooth-transition step count on GNSS recovery when not using RTS.
    # NOTE: the reference's fusion orchestrator forces this to 0 (hard update,
    # EKFGPSSLAM.py:845) — kept for API parity.
    transition_steps: int = 10


@dataclasses.dataclass(frozen=True)
class Sim3RansacConfig:
    """Sim(3) global-alignment RANSAC parameters (reference: EKFGPSSLAM.py:32-38)."""

    min_samples: int = 4
    residual_threshold: float = 4.0
    max_trials: int = 1000
    min_inliers_needed: int = 4
    max_initial_duration: float = 180.0
    # Adaptive early stopping (framework extension; the reference always
    # runs max_trials — EKFGPSSLAM.py:404 — while its sklearn GPS filter
    # stops at stop_probability=0.99). None = faithful fixed trial count;
    # a probability p runs trial chunks until the sklearn bound
    # ln(1−p)/ln(1−w^min_samples) is met (w = best inlier ratio so far).
    # On clean data (w≈1) one 128-trial chunk suffices — ~8× fewer trials.
    stop_probability: float | None = None
    adaptive_chunk: int = 128
    # Kept for config parity with the JAX package, where it unrolls the
    # RANSAC tail's Jacobi sweeps for XLA. The port runs eagerly and
    # ignores it.
    unroll_tail: bool | None = None


@dataclasses.dataclass(frozen=True)
class GPSFilterConfig:
    """Polynomial-RANSAC GPS outlier filter (reference: EKFGPSSLAM.py:40-49, 56-65)."""

    enabled: bool = True
    use_sliding_window: bool = True
    window_duration_seconds: float = 15.0
    window_step_factor: float = 0.5
    polynomial_degree: int = 2
    min_samples: int = 6
    residual_threshold_meters: float = 10.0
    max_trials: int = 50
    # Adaptive early stopping (framework extension, mirrors
    # Sim3RansacConfig.stop_probability): None = faithful fixed trial count
    # per window×axis; a probability p runs trial chunks until the sklearn
    # ln(1−p)/ln(1−w^k) bound is met.
    stop_probability: float | None = None
    adaptive_chunk: int = 10


@dataclasses.dataclass(frozen=True)
class TimeAlignConfig:
    """Temporal alignment parameters (reference: EKFGPSSLAM.py:51-54)."""

    max_samples_for_corr: int = 500
    max_gps_gap_threshold: float = 5.0


@dataclasses.dataclass(frozen=True)
class RTSDecisionConfig:
    """RTS-vs-transition decision on GNSS recovery (reference: EKFGPSSLAM.py:67-70)."""

    sharp_turn_yaw_rate_threshold_deg_per_sec: float = 45.0
    default_ekf_transition_steps_on_sharp_turn: int = 0


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Top-level config bundling all sections (reference CONFIG dict layout)."""

    ekf: EKFConfig = EKFConfig()
    sim3_ransac: Sim3RansacConfig = Sim3RansacConfig()
    gps_filtering_ransac: GPSFilterConfig = GPSFilterConfig()
    time_alignment: TimeAlignConfig = TimeAlignConfig()
    ground_truth_gps_filtering: GPSFilterConfig = GPSFilterConfig(
        enabled=False, residual_threshold_meters=5.0
    )
    rts_decision: RTSDecisionConfig = RTSDecisionConfig()
    # EKF scan strategy (framework extension, not in the reference CONFIG):
    # "sequential" — O(N)-depth recursion, bit-faithful to the reference;
    # "parallel"   — O(log N)-depth associative scans (requires hard updates,
    #                i.e. default_ekf_transition_steps_on_sharp_turn == 0);
    # "auto"       — parallel whenever the config permits it (default).
    ekf_scan: str = "auto"
    # RTS extent (framework extension): "outage" smooths only GNSS-outage
    # segments on recovery (reference behaviour); "full" runs the classic
    # fixed-interval smoother over the entire trajectory.
    rts_mode: str = "outage"
    # Clock-offset estimation before temporal alignment (host-side):
    # "faithful" — the reference's ramp cross-correlation, provably 0.0 on
    #              real inputs (SURVEY Q1, EKFGPSSLAM.py:301-323);
    # "off"      — skip estimation (offset 0);
    # "xcorr"    — functional speed-profile cross-correlation (extension)
    #              that actually recovers real clock offsets;
    # "xcorr_device" — the same estimator ON DEVICE (FFT circular
    #              cross-correlation, ops.alignment.estimate_time_offset_
    #              xcorr_device) — vmappable for batched/sharded sequences.
    offset_mode: str = "faithful"
    # Promise that the VALID GPS timestamps are nondecreasing (true of every
    # real GNSS stream): skips the alignment compaction sort.
    # pipeline.fuse_arrays verifies on host and sets this automatically;
    # identical outputs either way.
    gps_sorted: bool = False
    # Platform the fusion runs on. It selects the EKF scan under
    # ekf_scan="auto" (parallel off-CPU, sequential on CPU). Kernel dispatch
    # itself follows the tensors' device, not this field. "auto" resolves
    # from the input tensors' device in models.fusion.fuse_core.
    # Values: "auto" | "cpu" | "tpu" | "gpu".
    platform: str = "auto"

    def replace(self, **kwargs) -> "FusionConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = FusionConfig()


def config_from_dict(d: dict) -> FusionConfig:
    """Build a FusionConfig from a reference-style nested dict.

    Accepts the exact key layout of the reference CONFIG
    (EKFGPSSLAM.py:22-71); unknown keys raise.
    """

    def _sub(cls, key, tuple_keys=()):
        section = d.get(key)
        if section is None:
            return cls()
        kw = dict(section)
        for tk in tuple_keys:
            if tk in kw:
                kw[tk] = tuple(kw[tk])
        return cls(**kw)

    known_sections = {
        "ekf",
        "sim3_ransac",
        "gps_filtering_ransac",
        "time_alignment",
        "ground_truth_gps_filtering",
        "rts_decision",
    }
    # Framework-extension scalars accepted at the top level.
    scalars = {
        k: d[k]
        for k in ("ekf_scan", "rts_mode", "offset_mode", "gps_sorted", "platform")
        if k in d
    }
    unknown = set(d) - known_sections - set(scalars)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")

    return FusionConfig(
        ekf=_sub(
            EKFConfig,
            "ekf",
            tuple_keys=("initial_cov_diag", "process_noise_diag", "meas_noise_diag"),
        ),
        sim3_ransac=_sub(Sim3RansacConfig, "sim3_ransac"),
        gps_filtering_ransac=_sub(GPSFilterConfig, "gps_filtering_ransac"),
        time_alignment=_sub(TimeAlignConfig, "time_alignment"),
        ground_truth_gps_filtering=_sub(GPSFilterConfig, "ground_truth_gps_filtering"),
        rts_decision=_sub(RTSDecisionConfig, "rts_decision"),
        **scalars,
    )
