"""Host-side orchestration: files → fusion on the device → evaluation →
export (port of ``gps_optimize_slam_tpu.pipeline``).

Load → project (float64, CPU) → RANSAC outlier gate → ``fuse_core`` →
``evaluate`` → TUM export in the working frame and WGS84, as the reference's
main_process_gui (EKFGPSSLAM.py:940-1123) without its GUI.
``fuse_files_chunked`` runs the same recipe out of core
(``models.fusion_chunked``) for trajectories larger than device memory.

``frame="utm"`` reproduces the reference's UTM working frame (golden
parity); ``frame="enu"`` uses a local East/North/Up frame whose small
coordinates keep float32 usable on the card. ``device`` and ``dtype`` pick
where and in which precision the fusion runs: the card unless the caller
passes another device (``device="cpu"``), and an error when there is no
card. The projection always runs in float64 on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig, GPSFilterConfig
from gps_optimize_slam_tpu_torch.io import gps as gps_io
from gps_optimize_slam_tpu_torch.io import tum as tum_io
from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
from gps_optimize_slam_tpu_torch.ops import alignment, geodesy, ransac
from gps_optimize_slam_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class GPSData:
    """Projected + outlier-gated GNSS track (host arrays)."""

    timestamps: np.ndarray  # (M,) all loaded fixes
    positions: np.ndarray  # (M,3) projected (UTM or ENU), float64
    valid: np.ndarray  # (M,) bool — range-valid AND RANSAC inlier
    frame: str
    utm_zone: int
    utm_south: bool
    enu_origin: Optional[np.ndarray] = None  # (lon, lat, alt) when frame=enu


@dataclasses.dataclass
class FusionResult:
    slam: Dict[str, np.ndarray]
    gps: GPSData
    outputs: fusion.FusionOutputs
    evaluation: fusion.Evaluation
    config: FusionConfig
    # Estimated clock offset (s) added to GPS timestamps before alignment.
    time_offset: float = 0.0

    @property
    def corrected_pos(self) -> np.ndarray:
        return self.outputs.corrected_pos.cpu().numpy()

    @property
    def corrected_quat(self) -> np.ndarray:
        return self.outputs.corrected_quat.cpu().numpy()

    @property
    def sim3_scale(self) -> float:
        return float(self.outputs.sim3.scale)

    def summary(self) -> str:
        lines = [
            f"poses: {len(self.slam['timestamps'])}, "
            f"gps fixes kept: {int(self.gps.valid.sum())}/{len(self.gps.valid)}, "
            f"frame: {self.gps.frame} (zone {self.gps.utm_zone}"
            f"{'S' if self.gps.utm_south else 'N'})",
            f"sim3: scale={self.sim3_scale:.6f} ok={bool(self.outputs.ok)} "
            f"inliers={int(self.outputs.sim3_inliers.sum())}",
        ]
        return "\n".join(lines + _evaluation_lines(self.evaluation))


def _evaluation_lines(ev: fusion.Evaluation):
    return [
        f"{name}: mean={float(st.mean):.3f}m median={float(st.median):.3f}m "
        f"rmse={float(st.rmse):.3f}m max={float(st.max):.3f}m n={int(st.count)}"
        for name, st in [
            ("raw SLAM  (NN)", ev.nn_slam),
            ("Sim3      (NN)", ev.nn_sim3),
            ("EKF fused (NN)", ev.nn_ekf),
            ("Sim3     (ATE)", ev.ate_sim3),
            ("EKF      (ATE)", ev.ate_ekf),
        ]
    ]


def load_and_project_gps(
    path: str,
    filter_cfg: GPSFilterConfig,
    frame: str = "utm",
    lon_first: bool = False,
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> GPSData:
    """Load GNSS fixes, project to the working frame, gate outliers
    (reference load_gps_data, EKFGPSSLAM.py:249-289, with the filter
    returning a mask). The projection runs in float64 on the CPU: ECEF/UTM
    intermediates are ~6.4e6 m, and float32 would lose ~0.5 m. The gate runs
    on ``device`` in ``dtype``."""
    device = resolve_device(device)
    raw = gps_io.read_gps_fixes(path, lon_first=lon_first)
    valid = raw["valid"]
    if valid.sum() == 0:
        raise ValueError(f"no valid GPS fixes in {path}")
    if frame not in ("utm", "enu"):
        raise ValueError(f"unknown frame {frame!r} (use 'utm' or 'enu')")
    zone, south = geodesy.utm_zone_from_lonlat(raw["lons"][valid], raw["lats"][valid])
    lons, lats, alts = (torch.from_numpy(raw[k]).double() for k in ("lons", "lats", "alts"))
    enu_origin = None
    if frame == "utm":
        x, y = geodesy.utm_forward(lons, lats, zone, south)
        positions64 = torch.stack([x, y, alts], dim=-1).numpy()
    else:
        first = int(np.argmax(valid))
        enu_origin = np.array([raw["lons"][first], raw["lats"][first], raw["alts"][first]])
        positions64 = geodesy.wgs84_to_enu(lons, lats, alts, *enu_origin.tolist()).numpy()

    times = torch.as_tensor(raw["timestamps"], dtype=dtype, device=device)
    positions = torch.as_tensor(positions64, dtype=dtype, device=device)
    window_starts = None
    if filter_cfg.enabled and filter_cfg.use_sliding_window:
        starts = ransac.reference_window_starts(raw["timestamps"][valid], filter_cfg)
        if len(starts):
            window_starts = torch.as_tensor(starts, dtype=dtype, device=device)
    keep = ransac.gps_poly_ransac_mask(
        times,
        positions,
        valid=torch.as_tensor(valid, device=device),
        window_starts=window_starts,
        cfg=filter_cfg,
        seed=seed,
    )
    return GPSData(
        timestamps=raw["timestamps"],
        positions=positions64,
        valid=keep.cpu().numpy(),
        frame=frame,
        utm_zone=zone,
        utm_south=south,
        enu_origin=enu_origin,
    )


def estimate_offset(slam: Dict[str, np.ndarray], gps: GPSData, config: FusionConfig) -> float:
    """Clock offset to add to GPS timestamps, per ``config.offset_mode``
    ("faithful" or "off"; the cross-correlation modes are not ported yet).
    The reference's estimator is provably 0.0 for ≥2-sample inputs
    (SURVEY Q1), so it is evaluated on the ungated timestamps."""
    if config.offset_mode == "off":
        return 0.0
    if config.offset_mode == "faithful":
        return alignment.estimate_time_offset(
            slam["timestamps"], gps.timestamps, config.time_alignment.max_samples_for_corr
        )
    raise NotImplementedError(f"offset_mode {config.offset_mode!r} is not ported yet")


def fuse_arrays(
    slam: Dict[str, np.ndarray],
    gps: GPSData,
    config: FusionConfig = FusionConfig(),
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
    sim3_draws: Optional[torch.Tensor] = None,
) -> FusionResult:
    """Fusion + evaluation of loaded arrays on ``device`` in ``dtype``.
    Raises RuntimeError when the Sim3 alignment failed; reading that flag is
    the one host sync before the result returns."""
    device = resolve_device(device)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    slam_times = dev(slam["timestamps"])
    slam_pos = dev(slam["positions"])
    slam_quat = dev(slam["quaternions"])
    # A sorted FULL time axis is enough for any gated subset (skips the
    # alignment's compaction sort; identical outputs).
    if not config.gps_sorted:
        ts_all = np.asarray(gps.timestamps)
        if ts_all.size == 0 or np.all(np.diff(ts_all) >= 0):
            config = config.replace(gps_sorted=True)
    offset = estimate_offset(slam, gps, config)
    outputs = fusion.fuse_core(
        slam_times,
        slam_pos,
        slam_quat,
        dev(gps.timestamps),
        dev(gps.positions),
        dev(gps.valid, torch.bool),
        config,
        seed=seed,
        time_offset=offset,
        sim3_draws=sim3_draws,
    )
    ev = fusion.evaluate(slam_times, slam_pos, outputs)
    if not bool(outputs.ok):
        raise RuntimeError(
            "Sim3 global alignment failed (not enough temporally aligned "
            "points or RANSAC consensus too small)"
        )
    return FusionResult(
        slam=slam, gps=gps, outputs=outputs, evaluation=ev, config=config,
        time_offset=float(offset),
    )


def fuse_files(
    slam_path: str,
    gps_path: str,
    config: FusionConfig = FusionConfig(),
    frame: str = "utm",
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> FusionResult:
    """End-to-end: TUM SLAM file + GNSS fix file → fused trajectory."""
    slam = tum_io.read_tum(slam_path)
    gps = load_and_project_gps(
        gps_path, config.gps_filtering_ransac, frame=frame, seed=seed, dtype=dtype, device=device
    )
    return fuse_arrays(slam, gps, config=config, seed=seed, dtype=dtype, device=device)


@dataclasses.dataclass
class ChunkedPipelineResult:
    """Out-of-core fusion of one file pair (the pipeline front of
    ``models.fusion_chunked``): host arrays, O(chunk) device residency.
    ``export_result`` takes it as it takes a ``FusionResult``."""

    slam: Dict[str, np.ndarray]
    gps: GPSData
    result: fusion_chunked.ChunkedFusionResult
    evaluation: Optional[fusion.Evaluation]
    config: FusionConfig
    time_offset: float = 0.0

    @property
    def corrected_pos(self) -> np.ndarray:
        return np.asarray(self.result.corrected_pos)

    @property
    def corrected_quat(self) -> np.ndarray:
        return np.asarray(self.result.corrected_quat)

    @property
    def sim3_scale(self) -> float:
        return float(self.result.sim3.scale)

    def summary(self) -> str:
        r = self.result
        lines = [
            f"poses: {len(self.slam['timestamps'])} (chunked/out-of-core), "
            f"gps fixes kept: {int(self.gps.valid.sum())}/{len(self.gps.valid)}, "
            f"frame: {self.gps.frame}",
            f"sim3: scale={self.sim3_scale:.6f} ok={r.ok} inliers={r.num_inliers}",
        ]
        if self.evaluation is not None:
            lines += _evaluation_lines(self.evaluation)
        return "\n".join(lines)


def fuse_files_chunked(
    slam_path: str,
    gps_path: str,
    config: FusionConfig = FusionConfig(),
    frame: str = "utm",
    seed: int = 0,
    chunk_size: int = 262144,
    halo: int = 64,
    dtype: torch.dtype = torch.float64,
    evaluate: bool = True,
    gt_path: Optional[str] = None,
    robust: bool = False,
    device=None,
) -> ChunkedPipelineResult:
    """End-to-end OUT-OF-CORE fusion, for trajectories larger than device
    memory: the recipe of ``fuse_files`` with every pose-length stage
    streaming host chunks of ``chunk_size`` poses (``models.fusion_chunked``:
    alignment, Sim3 window/RANSAC, EKF + RTS and, with ``evaluate``, the
    NN/ATE evaluation), device residency O(chunk_size). GNSS fixes are
    projected and outlier-gated in core at load time. Runs on ``device``
    (the card unless the caller names another) in ``dtype``.

    ``gt_path`` (the streamed ground-truth evaluation) raises
    NotImplementedError until a ground-truth GNSS file is in the repository;
    so does ``robust`` until ``models/robust.py`` is ported."""
    if gt_path is not None:
        raise NotImplementedError("the ground-truth GNSS evaluation is not ported yet")
    device = resolve_device(device)
    slam = tum_io.read_tum(slam_path)
    gps = load_and_project_gps(
        gps_path, config.gps_filtering_ransac, frame=frame, seed=seed, dtype=dtype, device=device
    )
    offset = estimate_offset(slam, gps, config)
    result = fusion_chunked.fuse_core_chunked(
        slam["timestamps"], slam["positions"], slam["quaternions"],
        gps.timestamps, gps.positions, gps_valid=gps.valid,
        seed=seed, config=config, time_offset=float(offset), chunk_size=chunk_size, halo=halo,
        dtype=dtype, robust=robust, device=device,
    )
    if not result.ok:
        raise RuntimeError(
            "Sim3 global alignment failed (not enough temporally aligned "
            "points or RANSAC consensus too small)"
        )
    ev = None
    if evaluate:
        ev = fusion_chunked.evaluate_chunked(
            slam["timestamps"], slam["positions"], slam["quaternions"], result,
            chunk_size=chunk_size, dtype=dtype, device=device,
        )
    return ChunkedPipelineResult(
        slam=slam, gps=gps, result=result, evaluation=ev, config=config, time_offset=float(offset)
    )


def export_result(
    result: Union[FusionResult, ChunkedPipelineResult], utm_path: str, wgs84_path: Optional[str] = None
) -> None:
    """Write the corrected trajectory in the working frame (TUM format) and
    optionally in WGS84 (reference exporter: EKFGPSSLAM.py:1086-1105)."""
    ts = result.slam["timestamps"]
    pos = result.corrected_pos.astype(np.float64)
    quat = result.corrected_quat.astype(np.float64)
    tum_io.write_tum(utm_path, ts, pos, quat, header="timestamp x y z qx qy qz qw (UTM)")
    if wgs84_path:
        if result.gps.frame != "utm":
            raise ValueError("WGS84 export requires the UTM working frame")
        lon, lat = geodesy.utm_inverse(
            torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1]),
            result.gps.utm_zone, result.gps.utm_south,
        )
        lonlatalt = np.column_stack([lon.numpy(), lat.numpy(), pos[:, 2]])
        tum_io.write_wgs84(wgs84_path, ts, lonlatalt, quat)
