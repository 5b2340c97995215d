"""Out-of-core fusion: raw GNSS + SLAM streams of any length (port of
``gps_optimize_slam_tpu.models.fusion_chunked``).

The chunked counterpart of ``models.fusion.fuse_core`` (the reference's
7-step recipe, EKFGPSSLAM.py:940-1123): temporal alignment
(``ops.alignment_chunked``), Sim3 window selection + streaming
RANSAC/Umeyama, the trajectory transform, and the re-entrant associative
EKF + RTS (``ops.kalman_chunked``), every stage O(chunk) device-resident;
host inputs may be memory-mapped. ``evaluate_chunked`` streams the NN and
paired-ATE evaluation the same way: on the card each NN block of
``chunk_size`` queries and candidates goes to the kernel
``kernels.nn_route`` picks (K3 at the default chunks: K4 pays only at a few
query tiles against 524,288 candidates or more). Use this path when a
trajectory exceeds device memory; for anything that fits, ``fuse_core`` is
faster.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.models import robust as robust_mod
from gps_optimize_slam_tpu_torch.models.fusion import Evaluation
from gps_optimize_slam_tpu_torch.ops import alignment_chunked, kalman_chunked, metrics, se3
from gps_optimize_slam_tpu_torch.ops.alignment import AlignedGPS
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from gps_optimize_slam_tpu_torch.utils import streaming
from gps_optimize_slam_tpu_torch.utils.device import numpy_dtype, resolve_device


class ChunkedFusionResult(NamedTuple):
    corrected_pos: np.ndarray  # (N,3)
    corrected_quat: np.ndarray  # (N,4)
    sim3: Sim3  # tensors on the fusion's device
    aligned_gps: np.ndarray  # (N,3)
    gps_valid: np.ndarray  # (N,)
    num_inliers: int
    ok: bool
    # χ²-gated robust fusion (models.robust.fuse_robust_chunked), when
    # requested: the measurements that survived the gate (None otherwise;
    # corrected_pos/quat then hold the robust trajectory).
    robust_accepted: Optional[np.ndarray] = None


def _sim3_on(sim3: Sim3, dtype: torch.dtype, device: torch.device):
    return tuple(torch.as_tensor(x).to(dtype=dtype, device=device) for x in (sim3.R, sim3.t, sim3.scale))


def transform_trajectory_chunked(
    slam_pos,
    slam_quat,
    sim3: Sim3,
    chunk_size: int = 262144,
    dtype: torch.dtype = torch.float64,
    device=None,
    out_pos: Optional[np.ndarray] = None,
    out_quat: Optional[np.ndarray] = None,
):
    """``se3.transform_trajectory`` streamed over host chunks
    (software-pipelined); returns host (pos (N,3), quat (N,4)): ``out_pos``
    and ``out_quat`` when given (preallocated host buffers, a ``np.memmap``
    too, that must not alias the inputs)."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    n = len(slam_pos)
    out_pos = np.empty((n, 3), np_dt) if out_pos is None else out_pos
    out_quat = np.empty((n, 4), np_dt) if out_quat is None else out_quat
    R, t, s = _sim3_on(sim3, dtype, device)

    def _stage(ab):
        a, b = ab
        return tuple(torch.as_tensor(np.asarray(x[a:b], np_dt), device=device) for x in (slam_pos, slam_quat))

    def _drain(ab, pq):
        a, b = ab
        out_pos[a:b] = pq[0].cpu().numpy()
        out_quat[a:b] = pq[1].cpu().numpy()

    streaming.stream_chunks(
        ((a, min(a + chunk_size, n)) for a in range(0, n, chunk_size)),
        _stage,
        lambda ab, staged: se3.transform_trajectory(*staged, R, t, s),
        _drain,
    )
    return out_pos, out_quat


def _pad_rows(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = np.zeros((size - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _round_up8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


def nn_errors_streamed(
    traj_chunk_fn,
    n: int,
    candidates: np.ndarray,
    cand_mask: np.ndarray,
    traj_mask: np.ndarray,
    chunk_size: int = 65536,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> np.ndarray:
    """The reference NN metric (EKFGPSSLAM.py:1030-1031, quirk Q6) streamed
    over host chunks: per point, the distance to the nearest valid
    candidate, with no (N, M) matrix and no full trajectory on the device.
    ``traj_chunk_fn(a, b)`` yields trajectory rows [a, b); candidates and
    masks are host arrays. Invalid points get +inf, as in
    ``metrics.nn_errors``.

    Blocks hold ``chunk_size`` queries and candidates on the card (the JAX
    package's accelerator branch, so its K3/K4 routing sees the same block
    sizes) and at most 4,096 on the CPU, where the plain version
    materialises (block, block) distances."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    out = np.full(n, np.inf, np_dt)
    m = candidates.shape[0]
    blk = chunk_size if device.type != "cpu" else min(chunk_size, 4096)
    blk = min(blk, max(_round_up8(n), _round_up8(m)))
    cands_np = np.nan_to_num(np.asarray(candidates, np_dt), nan=0.0)
    for a in range(0, n, blk):
        b = min(a + blk, n)
        traj_blk = _pad_rows(np.asarray(traj_chunk_fn(a, b), np_dt), blk)
        tmask_blk = np.zeros(blk, bool)
        tmask_blk[: b - a] = np.asarray(traj_mask[a:b], bool)
        running = torch.full((blk,), float("inf"), dtype=dtype, device=device)
        tdev = torch.as_tensor(traj_blk, device=device)
        tmdev = torch.as_tensor(tmask_blk, device=device)

        def _cstage(cd):
            c, d = cd
            cmask_blk = np.zeros(blk, bool)
            cmask_blk[: d - c] = np.asarray(cand_mask[c:d], bool)
            if not cmask_blk.any():
                return None
            return (torch.as_tensor(_pad_rows(cands_np[c:d], blk), device=device),
                    torch.as_tensor(cmask_blk, device=device))

        def _claunch(cd, staged):
            nonlocal running
            if staged is not None:
                e = metrics.nn_errors_auto(tdev, staged[0], tmdev, staged[1])
                running = torch.minimum(running, e)

        # Candidate block c+1's host pad + transfer overlaps block c's kernel.
        streaming.stream_chunks(
            ((c, min(c + blk, m)) for c in range(0, m, blk)), _cstage, _claunch, None
        )
        out[a:b] = running[: b - a].cpu().numpy()
    return out


def _stats_host(errors: np.ndarray, mask: np.ndarray) -> metrics.ErrorStats:
    """Host mirror of ``metrics.error_stats`` (same zero-count and even/odd
    median conventions) over a full-length error array."""
    e = errors[np.asarray(mask, bool)]
    n = int(e.size)
    if n == 0:
        z = np.float64(0.0)
        return metrics.ErrorStats(mean=z, median=np.float64(np.inf), rmse=z,
                                  max=np.float64(-np.inf), count=0)
    return metrics.ErrorStats(
        mean=np.float64(e.mean()),
        median=np.float64(np.median(e)),
        rmse=np.float64(np.sqrt(np.mean(e**2))),
        max=np.float64(e.max()),
        count=n,
    )


def evaluate_chunked(
    slam_times,
    slam_pos,
    slam_quat,
    result: ChunkedFusionResult,
    chunk_size: int = 65536,
    skip_seconds: float = 5.0,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Evaluation:
    """Out-of-core counterpart of ``models.fusion.evaluate`` (reference
    evaluation block, EKFGPSSLAM.py:1013-1083): NN + paired-ATE stats of the
    raw SLAM / Sim3-aligned / EKF-fused trajectories against the aligned
    GPS, with the post-5 s gate, from host arrays with O(chunk) device
    residency. Returns ``fusion.Evaluation`` with host scalars."""
    return _evaluate_streamed(
        slam_times, slam_pos, slam_quat, result,
        np.asarray(result.aligned_gps), np.asarray(result.gps_valid, bool),
        chunk_size=chunk_size, skip_seconds=skip_seconds, dtype=dtype, device=device,
    )


def evaluate_vs_track_chunked(
    slam_times,
    slam_pos,
    slam_quat,
    result: ChunkedFusionResult,
    track_times,
    track_positions,
    track_valid=None,
    cfg: FusionConfig = FusionConfig(),
    chunk_size: int = 65536,
    skip_seconds: float = 5.0,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """Out-of-core counterpart of ``models.fusion.evaluate_vs_track``
    (reference GT evaluation, EKFGPSSLAM.py:1044-1082): the INDEPENDENT
    reference track (e.g. ground-truth GNSS) is temporally aligned onto the
    SLAM timestamps with the chunk + halo cubic aligner, then the same
    NN/ATE statistics stream over host chunks. Returns ``(Evaluation,
    AlignedGPS(host aligned (N,3), host valid (N,)))``, as the in-core
    function does with tensors."""
    device = resolve_device(device)
    aligned, valid = alignment_chunked.align_gps_to_slam_chunked(
        slam_times, track_times, track_positions, gps_valid=track_valid,
        cfg=cfg.time_alignment, chunk_size=chunk_size, dtype=dtype, device=device,
    )
    ev = _evaluate_streamed(
        slam_times, slam_pos, slam_quat, result, aligned, valid,
        chunk_size=chunk_size, skip_seconds=skip_seconds, dtype=dtype, device=device,
    )
    return ev, AlignedGPS(aligned=aligned, valid=valid)


def _evaluate_streamed(
    slam_times, slam_pos, slam_quat, result: ChunkedFusionResult, aligned: np.ndarray, valid: np.ndarray,
    chunk_size: int, skip_seconds: float, dtype: torch.dtype, device,
) -> Evaluation:
    """The streamed NN/ATE machinery both evaluations share: statistics of
    the three trajectories against the candidate track ``(aligned, valid)``
    with the post-skip gate, O(chunk) device residency. The Sim3 trajectory
    is generated chunk by chunk from the stored transform."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    n = len(slam_times)
    st = np.asarray(slam_times)
    gate = np.asarray(valid, bool) & (st > st[0] + skip_seconds)
    R, t, s = _sim3_on(result.sim3, dtype, device)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np_dt), device=device)

    def slam_chunk(a, b):
        return slam_pos[a:b]

    def sim3_chunk(a, b):
        p, _ = se3.transform_trajectory(dev(slam_pos[a:b]), dev(slam_quat[a:b]), R, t, s)
        return p.cpu().numpy()

    def ekf_chunk(a, b):
        return result.corrected_pos[a:b]

    def nn(fn):
        e = nn_errors_streamed(fn, n, aligned, gate, gate, chunk_size=chunk_size, dtype=dtype, device=device)
        return _stats_host(e, gate)

    ref_np = np.nan_to_num(aligned.astype(np_dt), nan=0.0)

    def ate(fn):
        e = np.full(n, np.inf, np_dt)

        def _stage(ab):
            a, b = ab
            return dev(fn(a, b)), dev(ref_np[a:b]), torch.as_tensor(gate[a:b], device=device)

        def _drain(ab, out_blk):
            e[ab[0] : ab[1]] = out_blk.cpu().numpy()

        streaming.stream_chunks(
            ((a, min(a + chunk_size, n)) for a in range(0, n, chunk_size)),
            _stage,
            lambda ab, staged: metrics.paired_errors(*staged),
            _drain,
        )
        return _stats_host(e, gate)

    return Evaluation(
        nn_slam=nn(slam_chunk),
        nn_sim3=nn(sim3_chunk),
        nn_ekf=nn(ekf_chunk),
        ate_sim3=ate(sim3_chunk),
        ate_ekf=ate(ekf_chunk),
    )


def fuse_core_chunked(
    slam_times,
    slam_pos,
    slam_quat,
    gps_times,
    gps_positions,
    gps_valid=None,
    seed: int = 0,
    config: FusionConfig = FusionConfig(),
    time_offset: float = 0.0,
    chunk_size: int = 262144,
    halo: int = 64,
    dtype: torch.dtype = torch.float64,
    max_ransac_points: int = 32768,
    robust: bool = False,
    robust_gate_chi2: Optional[float] = None,
    robust_iterations: int = 2,
    sim3_draws: Optional[torch.Tensor] = None,
    device=None,
    scan_fn=None,
    out_pos: Optional[np.ndarray] = None,
    out_quat: Optional[np.ndarray] = None,
    return_sim3_trajectory: bool = False,
):
    """Full fusion of one arbitrarily long sequence from raw GNSS.

    Host-resident (memory-mappable) inputs; device residency O(chunk), on
    ``device`` (the card unless the caller names another). Stages:

    1. ``alignment_chunked.align_gps_to_slam_chunked``: gap-aware cubic
       interpolation onto SLAM timestamps (chunk + halo windows).
    2. ``alignment_chunked.sim3_window_mask_host``: the reference's calc
       window (first gap-free run, ≤ max_initial_duration).
    3. ``alignment_chunked.sim3_ransac_streaming``: robust Sim(3); trials on
       ≤ ``max_ransac_points`` in-core (``seed``, or the injected
       ``sim3_draws``, as in ``pipeline.fuse_arrays``), refit streamed over
       all inliers.
    4. ``kalman_chunked.fuse_ekf_rts_chunked``: re-entrant EKF + RTS (the
       EKF's motion model is the raw SLAM relative pose, faithful to
       reference EKFGPSSLAM.py:866; Sim3 enters through the initial state).

    Returns ``ChunkedFusionResult`` (host arrays; the fused trajectory in
    ``out_pos`` and ``out_quat`` when given: preallocated (N,3) and (N,4)
    host buffers, a ``np.memmap`` too, that must not alias the inputs).
    With ``return_sim3_trajectory=True``, (result, (sim3_pos, sim3_quat)):
    the Sim3-transformed trajectory too (two more chunked passes).
    ``robust=True`` replaces
    stage 4 with the χ²-NIS-gated filter
    (``models.robust.fuse_robust_chunked``: at most ``robust_iterations``
    gate passes at the threshold ``robust_gate_chi2``, the 95th percentile
    of χ²₃ when None); the result's ``robust_accepted`` records the
    surviving measurements.

    ``scan_fn`` (``parallel.seqpar.sequence_parallel_scan(mesh)``) splits
    each chunk's filter scans over the devices of a mesh, the robust gate's
    too: host chunks meet device blocks; pick ``chunk_size = k·D − 1``
    (see ``kalman_chunked``).
    """
    device = resolve_device(device)
    aligned, valid = alignment_chunked.align_gps_to_slam_chunked(
        slam_times, gps_times, gps_positions, gps_valid=gps_valid, time_offset=time_offset,
        cfg=config.time_alignment, chunk_size=chunk_size, halo=halo, dtype=dtype, device=device,
    )
    window = alignment_chunked.sim3_window_mask_host(
        slam_times, valid,
        gap_threshold=config.time_alignment.max_gps_gap_threshold,
        max_duration=config.sim3_ransac.max_initial_duration,
        min_samples=config.sim3_ransac.min_samples,
    )
    sres = alignment_chunked.sim3_ransac_streaming(
        slam_pos, np.nan_to_num(aligned, nan=0.0), window, cfg=config.sim3_ransac,
        max_ransac_points=max_ransac_points, chunk_size=chunk_size, dtype=dtype,
        seed=seed, draws=sim3_draws, device=device,
    )
    # Initial state: the Sim3-transformed first pose (the only place the
    # transform enters the filter, reference EKFGPSSLAM.py:842-845, 866).
    np_dt = numpy_dtype(dtype)
    p0, q0 = transform_trajectory_chunked(
        np.asarray(slam_pos[:1], np_dt), np.asarray(slam_quat[:1], np_dt), sres.sim3,
        dtype=dtype, device=device,
    )
    ekf_args = dict(ekf_cfg=config.ekf, rts_cfg=config.rts_decision, rts_mode=config.rts_mode,
                    chunk_size=chunk_size, dtype=dtype, device=device, scan_fn=scan_fn,
                    out_pos=out_pos, out_quat=out_quat)
    robust_accepted = None
    if robust:
        out_pos, out_quat, robust_accepted, _ = robust_mod.fuse_robust_chunked(
            slam_times, slam_pos, slam_quat, p0[0], q0[0], aligned, valid,
            gate_chi2=robust_mod.CHI2_3DOF_95 if robust_gate_chi2 is None else robust_gate_chi2,
            n_iterations=robust_iterations, **ekf_args,
        )
    else:
        out_pos, out_quat = kalman_chunked.fuse_ekf_rts_chunked(
            slam_times, slam_pos, slam_quat, p0[0], q0[0], aligned, valid, **ekf_args
        )
    result = ChunkedFusionResult(
        corrected_pos=out_pos,
        corrected_quat=out_quat,
        sim3=sres.sim3,
        aligned_gps=aligned,
        gps_valid=valid,
        num_inliers=sres.num_inliers,
        ok=bool(sres.sim3.ok),
        robust_accepted=robust_accepted,
    )
    if return_sim3_trajectory:
        return result, transform_trajectory_chunked(slam_pos, slam_quat, sres.sim3, chunk_size=chunk_size,
                                                    dtype=dtype, device=device)
    return result
