"""Host-side orchestration: files → fusion on the device → evaluation →
export (port of ``gps_optimize_slam_tpu.pipeline``).

Load → project (float64, CPU) → RANSAC outlier gate → ``fuse_core`` →
``evaluate`` → TUM export in the working frame and WGS84, as the reference's
main_process_gui (EKFGPSSLAM.py:940-1123) without its GUI.
``fuse_files_chunked`` runs the same recipe out of core
(``models.fusion_chunked``) for trajectories larger than device memory;
``refine_pose_graph`` refines a fusion globally (``models.pose_graph``).

``frame="utm"`` reproduces the reference's UTM working frame (golden
parity); ``frame="enu"`` uses a local East/North/Up frame whose small
coordinates keep float32 usable on the card. ``device`` and ``dtype`` pick
where and in which precision the fusion runs: the card unless the caller
passes another device (``device="cpu"``), and an error when there is no
card. The projection always runs in float64 on the CPU.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional, Union

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig, GPSFilterConfig
from gps_optimize_slam_tpu_torch.io import gps as gps_io
from gps_optimize_slam_tpu_torch.io import tum as tum_io
from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
from gps_optimize_slam_tpu_torch.models import robust as robust_mod
from gps_optimize_slam_tpu_torch.ops import alignment, geodesy, ransac
from gps_optimize_slam_tpu_torch.utils import profiling
from gps_optimize_slam_tpu_torch.utils.device import resolve_device
from gps_optimize_slam_tpu_torch.utils.logging import get_logger, step


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
    # Optional ground-truth GNSS comparison (reference EKFGPSSLAM.py:1044-1082).
    gt: Optional[GPSData] = None
    gt_evaluation: Optional[fusion.Evaluation] = None
    gt_aligned: Optional[alignment.AlignedGPS] = None
    # χ²-gated robust fusion (models.robust), when requested: the mask of
    # GNSS measurements that survived the NIS gate. corrected_pos/quat then
    # hold the robust trajectory.
    robust_accepted: Optional[np.ndarray] = None

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
        lines += _evaluation_lines(self.evaluation)
        if self.gt_evaluation is not None:
            gv = self.gt_evaluation
            lines += [
                f"{name}: mean={float(st.mean):.3f}m rmse={float(st.rmse):.3f}m "
                f"max={float(st.max):.3f}m n={int(st.count)}"
                for name, st in [("vs GT: Sim3 (NN)", gv.nn_sim3), ("vs GT: EKF  (NN)", gv.nn_ekf)]
            ]
        return "\n".join(lines)


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
    like: Optional[GPSData] = None,
) -> GPSData:
    """Load GNSS fixes, project to the working frame, gate outliers
    (reference load_gps_data, EKFGPSSLAM.py:249-289, with the filter
    returning a mask). The projection runs in float64 on the CPU: ECEF/UTM
    intermediates are ~6.4e6 m, and float32 would lose ~0.5 m. The gate runs
    on ``device`` in ``dtype``.

    ``like``: project into the SAME frame as an already loaded track (its
    UTM zone, its ENU origin), as comparing two tracks needs, e.g. the
    primary GPS and a ground-truth GNSS."""
    device = resolve_device(device)
    raw = gps_io.read_gps_fixes(path, lon_first=lon_first)
    valid = raw["valid"]
    if valid.sum() == 0:
        raise ValueError(f"no valid GPS fixes in {path}")
    if like is not None:
        frame, zone, south = like.frame, like.utm_zone, like.utm_south
    else:
        zone, south = geodesy.utm_zone_from_lonlat(raw["lons"][valid], raw["lats"][valid])
    if frame not in ("utm", "enu"):
        raise ValueError(f"unknown frame {frame!r} (use 'utm' or 'enu')")
    lons, lats, alts = (torch.from_numpy(raw[k]).double() for k in ("lons", "lats", "alts"))
    enu_origin = None
    if frame == "utm":
        x, y = geodesy.utm_forward(lons, lats, zone, south)
        positions64 = torch.stack([x, y, alts], dim=-1).numpy()
    else:
        if like is not None and like.enu_origin is not None:
            enu_origin = np.asarray(like.enu_origin)
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


def estimate_offset(
    slam: Dict[str, np.ndarray], gps: GPSData, config: FusionConfig,
    dtype: torch.dtype = torch.float64, device=None,
) -> float:
    """Clock offset to add to GPS timestamps, per ``config.offset_mode``:
    "off"; "faithful", the reference's estimator, provably 0.0 for ≥2-sample
    inputs (SURVEY Q1), so it is evaluated on the ungated timestamps;
    "xcorr", the speed-profile cross-correlation on the host; or
    "xcorr_device", the same by FFT on ``device`` in ``dtype`` (the only
    mode that touches the device)."""
    mode = config.offset_mode
    if mode == "off":
        return 0.0
    if mode == "faithful":
        return alignment.estimate_time_offset(
            slam["timestamps"], gps.timestamps, config.time_alignment.max_samples_for_corr
        )
    if mode == "xcorr":
        return alignment.estimate_time_offset_xcorr(
            slam["timestamps"], slam["positions"], gps.timestamps[gps.valid], gps.positions[gps.valid]
        )
    if mode == "xcorr_device":
        device = resolve_device(device)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return float(alignment.estimate_time_offset_xcorr_device(
            dev(slam["timestamps"]), dev(slam["positions"]), dev(gps.timestamps), dev(gps.positions),
            gps_valid=dev(gps.valid, torch.bool),
        ))
    raise ValueError(f"unknown offset_mode {mode!r} (off|faithful|xcorr|xcorr_device)")


def fuse_arrays(
    slam: Dict[str, np.ndarray],
    gps: GPSData,
    config: FusionConfig = FusionConfig(),
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
    sim3_draws: Optional[torch.Tensor] = None,
    gt: Optional[GPSData] = None,
    robust: bool = False,
    robust_gate_chi2: Optional[float] = None,
    robust_iterations: int = 2,
    robust_gate_mode: str = "sequential",
) -> FusionResult:
    """Fusion + evaluation of loaded arrays on ``device`` in ``dtype``.
    Raises RuntimeError when the Sim3 alignment failed; reading that flag is
    the one host sync of the plain path before the result returns.

    ``gt``: optional independent ground-truth GNSS track in the same working
    frame (load it with ``load_and_project_gps(..., like=gps)``), evaluated
    like the reference's GT flow (EKFGPSSLAM.py:1044-1082).

    ``robust=True`` reruns the filter with the χ² NIS innovation gate
    (``models.robust.fuse_robust``) on top of the standard pipeline:
    measurements plausible to the polynomial pre-filter but inconsistent
    with the filter state are rejected; the corrected trajectory and its
    evaluation then reflect the gated filter. ``robust_gate_mode`` picks the
    gate ("sequential", the JAX package's default, or "parallel", the two
    scans; same fixed point)."""
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
    offset = estimate_offset(slam, gps, config, dtype=dtype, device=device)
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
    robust_accepted = None
    if robust:
        rres = robust_mod.fuse_robust(
            slam_times, slam_pos, slam_quat, outputs.sim3_pos, outputs.sim3_quat,
            outputs.aligned_gps, outputs.gps_valid,
            ekf_cfg=config.ekf, rts_cfg=config.rts_decision,
            gate_chi2=robust_mod.CHI2_3DOF_95 if robust_gate_chi2 is None else robust_gate_chi2,
            n_iterations=robust_iterations, gate_mode=robust_gate_mode,
        )
        outputs = outputs._replace(corrected_pos=rres.positions, corrected_quat=rres.quaternions)
        robust_accepted = rres.accepted.cpu().numpy()
    ev = fusion.evaluate(slam_times, slam_pos, outputs)
    if not bool(outputs.ok):
        raise RuntimeError(
            "Sim3 global alignment failed (not enough temporally aligned "
            "points or RANSAC consensus too small)"
        )
    gt_ev = gt_al = None
    if gt is not None:
        _check_gt_frame(gt, gps)
        gt_ev, gt_al = fusion.evaluate_vs_track(
            slam_times, slam_pos, outputs,
            dev(gt.timestamps), dev(gt.positions), dev(gt.valid, torch.bool), cfg=config,
        )
    return FusionResult(
        slam=slam, gps=gps, outputs=outputs, evaluation=ev, config=config,
        time_offset=float(offset), gt=gt, gt_evaluation=gt_ev, gt_aligned=gt_al,
        robust_accepted=robust_accepted,
    )


def _check_gt_frame(gt: GPSData, gps: GPSData) -> None:
    if gt.frame != gps.frame:
        raise ValueError(f"ground-truth frame {gt.frame!r} != working frame {gps.frame!r}")


def _load_tracks(slam_path, gps_path, gt_path, gt_lon_first, config, frame, seed, dtype, device):
    """The three loads both file entry points share: the SLAM trajectory,
    the primary GNSS and, with ``gt_path``, the ground-truth GNSS projected
    into the primary's frame."""
    n_steps = 4 if gt_path else 3
    step(1, n_steps, f"loading SLAM trajectory {slam_path}")
    slam = tum_io.read_tum(slam_path)
    step(2, n_steps, f"loading + projecting + gating GNSS {gps_path} ({frame})")
    gps = load_and_project_gps(
        gps_path, config.gps_filtering_ransac, frame=frame, seed=seed, dtype=dtype, device=device
    )
    gt = None
    if gt_path:
        step(3, n_steps, f"loading ground-truth GNSS {gt_path}")
        gt = load_and_project_gps(
            gt_path, config.ground_truth_gps_filtering, lon_first=gt_lon_first, seed=seed,
            dtype=dtype, device=device, like=gps,
        )
    return slam, gps, gt, n_steps


def fuse_files(
    slam_path: str,
    gps_path: str,
    config: FusionConfig = FusionConfig(),
    frame: str = "utm",
    seed: int = 0,
    dtype: torch.dtype = torch.float64,
    device=None,
    gt_path: Optional[str] = None,
    gt_lon_first: bool = True,
    robust: bool = False,
    robust_gate_chi2: Optional[float] = None,
    robust_iterations: int = 2,
) -> FusionResult:
    """End-to-end: TUM SLAM file + GNSS fix file → fused trajectory.

    ``gt_path``: optional ground-truth GNSS file, loaded lon-first by
    default (the convention of the reference's ground-truth file, SURVEY Q4)
    and projected into the SAME frame as the primary GPS. ``robust`` and its
    two knobs go to ``fuse_arrays``."""
    device = resolve_device(device)
    slam, gps, gt, n_steps = _load_tracks(
        slam_path, gps_path, gt_path, gt_lon_first, config, frame, seed, dtype, device
    )
    step(n_steps, n_steps, "device fusion (align + Sim3 RANSAC + EKF/RTS) + evaluation")
    result = fuse_arrays(
        slam, gps, config=config, seed=seed, dtype=dtype, device=device, gt=gt,
        robust=robust, robust_gate_chi2=robust_gate_chi2, robust_iterations=robust_iterations,
    )
    get_logger().info("fusion done: %s", result.summary().replace("\n", " | "))
    return result


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
    gt: Optional[GPSData] = None
    gt_evaluation: Optional[fusion.Evaluation] = None
    gt_aligned: Optional[alignment.AlignedGPS] = None  # host arrays
    device: Optional[torch.device] = None  # where the chunks ran

    @property
    def corrected_pos(self) -> np.ndarray:
        return np.asarray(self.result.corrected_pos)

    def decimated_view(self, max_points: int = 5000):
        """A view for ``viz.plot_fusion_result`` of at most ``max_points``
        poses: every pose-length array strided, the Sim3 layer recomputed
        on the strided poses (``fusion_chunked.transform_trajectory_chunked``
        on the result's device, in its dtype), so a fusion larger than
        device memory still gets the four-panel overview. The error panels
        then take the strided candidate set: an approximation, fine for a
        trend overview."""
        n = len(self.slam["timestamps"])
        s = max(1, -(-n // max_points))
        slam_d = {k: np.asarray(v)[::s] for k, v in self.slam.items()}
        r = self.result
        corrected = np.asarray(r.corrected_pos)[::s]
        dtype = torch.float32 if corrected.dtype == np.float32 else torch.float64
        sim3_pos, _ = fusion_chunked.transform_trajectory_chunked(
            slam_d["positions"], slam_d["quaternions"], r.sim3, dtype=dtype, device=self.device
        )
        outputs = types.SimpleNamespace(
            sim3_pos=sim3_pos, aligned_gps=np.asarray(r.aligned_gps)[::s], gps_valid=np.asarray(r.gps_valid)[::s]
        )
        gt_aligned = None
        if self.gt_aligned is not None:
            gt_aligned = types.SimpleNamespace(
                aligned=np.asarray(self.gt_aligned.aligned)[::s], valid=np.asarray(self.gt_aligned.valid)[::s]
            )
        return types.SimpleNamespace(slam=slam_d, gps=self.gps, outputs=outputs, corrected_pos=corrected,
                                     gt=self.gt, gt_aligned=gt_aligned, device=self.device)

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
        if r.robust_accepted is not None:
            lines.append(
                f"robust χ² gate: accepted={int(r.robust_accepted.sum())} "
                f"rejected={int((~r.robust_accepted & r.gps_valid).sum())}"
            )
        if self.evaluation is not None:
            lines += _evaluation_lines(self.evaluation)
        if self.gt_evaluation is not None:
            lines += ["vs ground-truth GNSS:"] + _evaluation_lines(self.gt_evaluation)
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
    gt_lon_first: bool = True,
    robust: bool = False,
    robust_gate_chi2: Optional[float] = None,
    robust_iterations: int = 2,
    device=None,
) -> ChunkedPipelineResult:
    """End-to-end OUT-OF-CORE fusion, for trajectories larger than device
    memory: the recipe of ``fuse_files`` with every pose-length stage
    streaming host chunks of ``chunk_size`` poses (``models.fusion_chunked``:
    alignment, Sim3 window/RANSAC, EKF + RTS and, with ``evaluate``, the
    NN/ATE evaluation), device residency O(chunk_size). GNSS fixes are
    projected and outlier-gated in core at load time. Runs on ``device``
    (the card unless the caller names another) in ``dtype``.

    ``gt_path``: optional ground-truth GNSS track (lon-first by default),
    evaluated by the streamed ``fusion_chunked.evaluate_vs_track_chunked``.
    ``robust=True``: the χ²-NIS-gated filter out of core
    (``models.robust.fuse_robust_chunked``), the semantics of
    ``fuse_arrays(robust=True, robust_gate_mode="parallel")``;
    ``result.robust_accepted`` records the surviving measurements."""
    device = resolve_device(device)
    slam, gps, gt, _ = _load_tracks(
        slam_path, gps_path, gt_path, gt_lon_first, config, frame, seed, dtype, device
    )
    offset = estimate_offset(slam, gps, config, dtype=dtype, device=device)
    result = fusion_chunked.fuse_core_chunked(
        slam["timestamps"], slam["positions"], slam["quaternions"],
        gps.timestamps, gps.positions, gps_valid=gps.valid,
        seed=seed, config=config, time_offset=float(offset), chunk_size=chunk_size, halo=halo,
        dtype=dtype, robust=robust, robust_gate_chi2=robust_gate_chi2,
        robust_iterations=robust_iterations, device=device,
    )
    if not result.ok:
        raise RuntimeError(
            "Sim3 global alignment failed (not enough temporally aligned "
            "points or RANSAC consensus too small)"
        )
    streamed = dict(chunk_size=chunk_size, dtype=dtype, device=device)
    ev = None
    if evaluate:
        ev = fusion_chunked.evaluate_chunked(
            slam["timestamps"], slam["positions"], slam["quaternions"], result, **streamed
        )
    gt_ev = gt_al = None
    if gt is not None:
        _check_gt_frame(gt, gps)
        gt_ev, gt_al = fusion_chunked.evaluate_vs_track_chunked(
            slam["timestamps"], slam["positions"], slam["quaternions"], result,
            gt.timestamps, gt.positions, track_valid=gt.valid, cfg=config, **streamed,
        )
    return ChunkedPipelineResult(
        slam=slam, gps=gps, result=result, evaluation=ev, config=config, time_offset=float(offset),
        gt=gt, gt_evaluation=gt_ev, gt_aligned=gt_al, device=device,
    )


def refine_pose_graph(
    result: FusionResult,
    iterations: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    propose_loops: bool = True,
    loop_radius: float = 5.0,
    loop_min_time_gap: float = 30.0,
    max_loops: int = 32,
    checkpoint_dir: Optional[str] = None,
    **weights,
):
    """Global pose-graph refinement of a fusion result (``models.pose_graph``),
    on the device and in the dtype of the result's tensors.

    Factors: odometry from the Sim3-transformed SLAM stream (metric scale,
    locally drift-free), GNSS unary priors from the aligned track, and, with
    ``propose_loops``, proximity-proposed loop closures over the fused
    trajectory whose relative measurements are read from the Sim3
    trajectory. The solve starts from the EKF/RTS output and runs
    Gauss-Newton + CG over per-factor Jacobian blocks, checkpointed to
    ``checkpoint_dir`` when one is given.

    Returns ``(GNResult, loop_info)``, ``loop_info`` a dict with the number
    of proposed closures and their valid pairs."""
    from gps_optimize_slam_tpu_torch.models import pose_graph
    from gps_optimize_slam_tpu_torch.ops import quaternion as quat_ops

    o = result.outputs
    times = torch.as_tensor(
        np.asarray(result.slam["timestamps"]), dtype=o.corrected_pos.dtype, device=o.corrected_pos.device
    )
    loop_kwargs = {}
    loop_info = {"n_loops": 0, "loop_ij": []}
    if propose_loops:
        with profiling.span("refine.propose"):
            loop_ij, _, _, loop_valid = pose_graph.propose_loop_closures(
                o.corrected_pos, times, o.sim3_quat, radius=loop_radius, min_time_gap=loop_min_time_gap,
                max_loops=max_loops,
            )
            # Measurements from the Sim3 trajectory (metric SLAM geometry).
            i_sel, j_sel = loop_ij[:, 0], loop_ij[:, 1]
            q_i_inv = quat_ops.conj(quat_ops.normalize(o.sim3_quat[i_sel]))
            loop_dp = quat_ops.rotate(q_i_inv, o.sim3_pos[j_sel] - o.sim3_pos[i_sel])
            loop_dq = quat_ops.mul(q_i_inv, quat_ops.normalize(o.sim3_quat[j_sel]))
            loop_kwargs = dict(loop_ij=loop_ij, loop_dp=loop_dp, loop_dq=loop_dq, loop_valid=loop_valid)
            valid = loop_valid.cpu().numpy()
            loop_info = {"n_loops": int(valid.sum()), "loop_ij": loop_ij.cpu().numpy()[valid].tolist()}

    with profiling.span("refine.build"):
        data = pose_graph.build_data_from_fusion(
            o.sim3_pos, o.sim3_quat, o.aligned_gps, o.gps_valid, **loop_kwargs, **weights
        )
        init = pose_graph.PoseGraphState(positions=o.corrected_pos, quaternions=o.corrected_quat)
    with profiling.span("refine.solve"):
        gn = pose_graph.solve_pose_graph_checkpointed(
            init, data, iterations=iterations, cg_iters=cg_iters, damping=damping, checkpoint_dir=checkpoint_dir
        )
    return gn, loop_info


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
