"""Robust fusion: chi-square GNSS innovation gating + iterated smoothing
(port of ``gps_optimize_slam_tpu.models.robust``).

Extension beyond the reference, which gates GPS outliers only in
preprocessing (polynomial RANSAC). A filter-consistent gate rejects
measurements whose normalised innovation squared (NIS) νᵀS⁻¹ν exceeds a χ²₃
threshold: outliers that look plausible to a polynomial but not to the
filter state.

The measurement model is linear (H = [I₃ 0]), so the classical iterated-EKF
relinearisation is a no-op; the iteration runs at the smoother level. Each
pass (1) records the availability mask the gate leaves, then, at the fixed
point of that mask, (2) the standard fusion reruns with it. Two gates share
that fixed point:

* ``_parallel_nis``: the card's form. The quaternion chain and the position
  filter of the previous pass's decisions are two associative scans (K1, K2
  beyond 65,536 elements); every candidate's one-step-ahead NIS is then
  elementwise. Decisions fold in on the next pass.
* ``_gated_availability``: the sequential within-pass gate, the default as
  in the JAX package. Each step's accept decision enters the state the next
  step is scored against, so it is an N-step recurrence; see its docstring
  for where it runs.

``fuse_robust_chunked`` streams the parallel form over host-resident
trajectories of any length with O(chunk) device residency.

On a card, as the JAX package jits ``_fuse_robust`` and its chunk gate, the
parallel form's passes and final fusion are one captured program
(``utils.graphs``), the sequential form's final fusion is one, and the
chunked gate's chunk is one.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, FusionConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.models.fusion import ekf_fuse_fn, resolve_platform
from gps_optimize_slam_tpu_torch.ops import kalman_chunked
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.kalman import EKFParams, ekf_params
from gps_optimize_slam_tpu_torch.ops.kalman_parallel import (
    parallel_position_filter,
    parallel_quat_chain,
    prior_element,
)
from gps_optimize_slam_tpu_torch.utils import graphs, streaming
from gps_optimize_slam_tpu_torch.utils.device import numpy_dtype, resolve_device
from gps_optimize_slam_tpu_torch.utils.logging import get_logger

# 95th percentile of chi-square with 3 dof.
CHI2_3DOF_95 = 7.814727903251179


class RobustFusionResult(NamedTuple):
    positions: torch.Tensor  # (N,3)
    quaternions: torch.Tensor  # (N,4)
    accepted: torch.Tensor  # (N,) bool — measurements that survived the gate
    nis: torch.Tensor  # (N,) normalised innovation squared (0 where no meas)
    # The accept mask reached a fixed point within n_iterations. False means
    # consecutive outlier clusters may still mask each other (decisions fold
    # in one iteration late); rerun with more iterations.
    gate_converged: bool = True


def _motion_increments(slam_times, slam_pos, slam_quat, init_quat):
    """World-frame motion deltas d (N-1,3) along the dead-reckoned quaternion
    chain (one scan: K1 ``quat_chain`` on the card) and the step times dt."""
    dp, dq = se3.relative_poses_along(slam_pos, slam_quat)
    q_chain = parallel_quat_chain(init_quat, dq)
    d = quat.rotate(q_chain[:-1], dp)
    dt = torch.clamp(slam_times[1:] - slam_times[:-1], min=1e-6)
    return d, dt


def _gated_availability(
    slam_times, slam_pos, slam_quat, init_pos, init_quat, aligned_gps,
    avail_eval, avail_update, params: EKFParams, gate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequential forward pass computing the χ² gate decisions.

    The NIS gate is EVALUATED for every measurement in ``avail_eval`` (the
    original availability), while the filter state only UPDATES with
    measurements that pass the gate AND were accepted on the previous
    iteration (``avail_update``): the fixed-point iteration re-admits
    measurements a transient outlier had pushed out. Returns
    (accepted (N,), nis (N,)) on the inputs' device. Only the 3×3 position
    block matters (the covariance is block-diagonal, see
    ``ops.kalman_parallel``).

    Where it runs: the motion deltas come from the quaternion chain on the
    inputs' device (K1 on the card). The recurrence itself carries 3 + 9
    numbers and each step depends on the step before through its own accept
    decision, so no scan covers it, and a step is a handful of 3×3
    operations: it runs on the host, in NumPy in the working dtype, from one
    copy of d, dt, z and the two masks, and its two outputs go back in one
    copy each. That is the shape of the algorithm; on the card a step would
    be about ten launches of a few numbers each.
    """
    device = slam_pos.device
    d_t, dt_t = _motion_increments(slam_times, slam_pos, slam_quat, init_quat)
    d, dt = d_t.cpu().numpy(), dt_t.cpu().numpy()
    z = torch.nan_to_num(aligned_gps[1:], nan=0.0).cpu().numpy()
    av_e = avail_eval[1:].cpu().numpy()
    av_u = avail_update[1:].cpu().numpy()
    np_dt = d.dtype
    Q = params.Q_per_sec[:3, :3].cpu().numpy().astype(np_dt)
    R = params.R.cpu().numpy().astype(np_dt)
    m = init_pos.cpu().numpy().astype(np_dt)
    P = params.P0[:3, :3].cpu().numpy().astype(np_dt)
    eye = np.eye(3, dtype=np_dt)
    gate = np_dt.type(gate)

    n1 = d.shape[0]
    acc = np.zeros(n1, bool)
    nis_all = np.zeros(n1, np_dt)
    for i in range(n1):
        m_pred = m + d[i]
        P_pred = P + Q * dt[i]
        if not av_e[i]:
            # No measurement to score: nis stays 0, the state predicts on.
            m, P = m_pred, P_pred
            continue
        S = P_pred + R
        nu = z[i] - m_pred
        nis = nu @ np.linalg.solve(S, nu)
        acc[i] = nis <= gate
        nis_all[i] = nis
        if acc[i] and av_u[i]:
            K = np.linalg.solve(S.T, P_pred.T).T  # P_pred S⁻¹ (H = I)
            m = m_pred + K @ nu
            P = (eye - K) @ P_pred
        else:
            m, P = m_pred, P_pred
    accepted = torch.cat([avail_eval[:1], torch.as_tensor(acc, device=device)])
    nis_full = torch.cat([torch.zeros((1,), dtype=slam_pos.dtype, device=device),
                          torch.as_tensor(nis_all, device=device)])
    return accepted, nis_full


def _one_step_nis(m_prev, P_diag_prev, d, Qd_diag, R_diag, z, av_e, gate):
    """(accept (L,), nis (L,)) of the one-step-ahead prediction of step k
    (pose k+1) from pose k's filtered state; P stays diagonal (diagonal Q,
    R, P₀ and H = I)."""
    m_pred = m_prev + d
    S_diag = P_diag_prev + Qd_diag + R_diag[None, :]
    nu = z - m_pred
    nis = torch.sum(nu * nu / S_diag, dim=-1)
    return av_e & (nis <= gate), torch.where(av_e, nis, 0.0)


def _parallel_nis(
    slam_times, slam_pos, slam_quat, init_pos, init_quat, aligned_gps,
    avail_eval, avail_update, params: EKFParams, gate: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(log N) gate pass: filter with ``avail_update`` by the associative
    position filter, then score every candidate measurement's one-step-ahead
    NIS against the FILTERED state in parallel.

    Differs from ``_gated_availability`` only mid-iteration: that pass folds
    each gate decision into the filter state at once, this one folds
    decisions in on the NEXT iteration. Both fixed points coincide: when
    ``accepted == avail_update`` the two recursions are the same filter, and
    Q/R/P₀ are diagonal, so the full-covariance solve there equals the
    diagonal division here. Two scans (``quat_chain`` and ``filter``: K1 on
    the card, K2 beyond 65,536 elements) and elementwise work; the form the
    chunked gate streams.
    """
    dtype = slam_pos.dtype
    d, dt = _motion_increments(slam_times, slam_pos, slam_quat, init_quat)
    Q_pos_diag = torch.diagonal(params.Q_per_sec)[:3].to(dtype)
    R_diag = torch.diagonal(params.R).to(dtype)
    Qd_diag = Q_pos_diag[None, :] * dt[:, None]
    z = torch.nan_to_num(aligned_gps[1:], nan=0.0)
    m_f, P_f6 = parallel_position_filter(
        init_pos, params.P0[:3, :3], d, Qd_diag, R_diag, z, avail_update[1:]
    )
    Pf_diag = torch.stack([P_f6[0], P_f6[3], P_f6[5]], dim=-1)  # (N,3)
    accept, nis = _one_step_nis(m_f[:-1], Pf_diag[:-1], d, Qd_diag, R_diag, z, avail_eval[1:], gate)
    accepted = torch.cat([avail_eval[:1], accept])
    nis_full = torch.cat([torch.zeros((1,), dtype=nis.dtype, device=nis.device), nis])
    return accepted, nis_full


def fuse_robust(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    slam_quat: torch.Tensor,
    sim3_pos: torch.Tensor,
    sim3_quat: torch.Tensor,
    aligned_gps: torch.Tensor,
    valid_mask: torch.Tensor,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    gate_chi2: float = CHI2_3DOF_95,
    n_iterations: int = 2,
    scan: str = "auto",
    gate_mode: str = "sequential",
) -> RobustFusionResult:
    """EKF + RTS fusion with χ²-gated GNSS updates, iterated to a fixed
    point of the gate decisions; every tensor on one device.

    ``scan`` mirrors ``FusionConfig.ekf_scan`` for the final fusion, with
    the rule of ``models.fusion.ekf_fuse_fn``: "auto" is the parallel scans
    for CUDA tensors and the sequential filter on the CPU; both give the
    same trajectory.

    ``gate_mode``: "sequential" folds each gate decision into the filter
    state within the pass (an N-step recurrence, run on the host, see
    ``_gated_availability``); "parallel" scores all NIS values against the
    associative filter of the PREVIOUS pass's decisions (two scans: the
    card's form, and the semantics ``fuse_robust_chunked`` streams). The
    fixed points coincide; mid-iteration decisions can differ only for
    measurements whose acceptance flips within one pass.

    The gate iterates until a pass leaves the accept mask unchanged, at most
    ``n_iterations`` passes. The parallel gate and the final fusion are one
    captured program on a card (``_fuse_robust_parallel``), the JAX
    package's ``while_loop`` with no host read: a capture runs all
    ``n_iterations`` passes, a pass after the mask stopped changing keeping
    the mask and NIS it found (a selection on the device's "changed" flag).
    Run eagerly (on the CPU, a key's first call, ``graphs.eager()``) it
    stops at the first pass that changes nothing, with one host read a
    pass; both give the same result. The sequential gate is a host
    recurrence and stops there too; its final fusion is a program of its
    own. When the cap cuts the iteration short the result carries
    ``gate_converged=False`` and a warning is logged (one host read of the
    flag after the fusion): heavily contaminated data, where consecutive
    outlier clusters mask each other, can need more than the default two
    passes. ``n_iterations=0`` gates nothing and counts as not converged.
    """
    if gate_mode not in ("sequential", "parallel"):
        raise ValueError(f"unknown gate_mode {gate_mode!r} (sequential|parallel)")
    args = (slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps)
    if gate_mode == "parallel":
        pos, q, accepted, nis, changed = graphs.run(
            _fuse_robust_parallel, *args, valid_mask, ekf_cfg, rts_cfg, gate_chi2, n_iterations, scan)
        changed = bool(changed)
    else:
        accepted, nis, changed = _sequential_gate(*args, valid_mask, ekf_cfg, gate_chi2, n_iterations)
        pos, q = graphs.run(_final_fusion, *args, accepted, ekf_cfg, rts_cfg, scan)
    if changed:
        get_logger().warning(
            "robust gate accept mask did not reach a fixed point within "
            "n_iterations=%d; rerun with a larger n_iterations (result "
            "carries gate_converged=False).",
            n_iterations,
        )
    return RobustFusionResult(
        positions=pos, quaternions=q, accepted=accepted, nis=nis, gate_converged=not changed
    )


def _sequential_gate(slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, valid_mask,
                     ekf_cfg: EKFConfig, gate_chi2: float, n_iterations: int):
    """The sequential gate's fixed-point iteration: (accepted, nis, whether
    the last pass changed the mask), one host read a pass."""
    dtype, device = slam_pos.dtype, slam_pos.device
    params = ekf_params(ekf_cfg, dtype=dtype, device=device)
    avail = valid_mask & ~torch.any(torch.isnan(aligned_gps), dim=-1)
    accepted = avail
    nis = torch.zeros(avail.shape, dtype=dtype, device=device)
    changed = True
    for _ in range(n_iterations):
        new_accepted, nis = _gated_availability(
            slam_times, slam_pos, slam_quat, sim3_pos[0], sim3_quat[0],
            aligned_gps, avail, accepted, params, gate_chi2,
        )
        changed = bool(torch.any(new_accepted != accepted))
        accepted = new_accepted
        if not changed:
            break
    return accepted, nis, changed


def _fuse_robust_parallel(slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, valid_mask,
                          ekf_cfg: EKFConfig, rts_cfg: RTSDecisionConfig, gate_chi2: float, n_iterations: int,
                          scan: str):
    """The program of ``fuse_robust(gate_mode="parallel")``: the JAX
    package's ``_fuse_robust`` with its ``while_loop`` run as
    ``n_iterations`` passes masked by the device's "changed" flag (a pass
    once the mask stopped changing keeps the mask and NIS it found: the
    loop's exit), then the final fusion. Outside a capture the loop also
    stops at that exit (``graphs.capturing()``, as RANSAC's adaptive stop
    does), reading the flag on the host. Returns (positions, quaternions,
    accepted, nis, changed), ``changed`` a device bool."""
    dtype, device = slam_pos.dtype, slam_pos.device
    params = ekf_params(ekf_cfg, dtype=dtype, device=device)
    avail = valid_mask & ~torch.any(torch.isnan(aligned_gps), dim=-1)
    accepted = avail
    nis = torch.zeros(avail.shape, dtype=dtype, device=device)
    changed = torch.ones((), dtype=torch.bool, device=device)
    for _ in range(n_iterations):
        new_accepted, new_nis = _parallel_nis(
            slam_times, slam_pos, slam_quat, sim3_pos[0], sim3_quat[0],
            aligned_gps, avail, accepted, params, gate_chi2,
        )
        moved = torch.any(new_accepted != accepted)
        accepted = torch.where(changed, new_accepted, accepted)
        nis = torch.where(changed, new_nis, nis)
        changed = changed & moved
        if not graphs.capturing() and not bool(changed):
            break
    pos, q = _final_fusion(slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, accepted,
                           ekf_cfg, rts_cfg, scan)
    return pos, q, accepted, nis, changed


def _final_fusion(slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned_gps, accepted,
                  ekf_cfg: EKFConfig, rts_cfg: RTSDecisionConfig, scan: str):
    """The EKF + RTS fusion with the gated measurements (the function of
    ``models.fusion.ekf_fuse_fn`` for ``scan`` on the tensors' device)."""
    config = resolve_platform(FusionConfig(ekf_scan=scan, rts_decision=rts_cfg), slam_pos.device)
    return ekf_fuse_fn(config)(
        slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat,
        torch.where(accepted[:, None], aligned_gps, float("nan")),
        accepted, ekf_cfg, rts_cfg,
    )


# ---------------------------------------------------------------------------
# Out-of-core (chunked) robust fusion: fuse_robust(gate_mode="parallel") for
# trajectories larger than device memory.
#
# A gate pass streams fixed-size chunks through the device exactly like the
# forward pass of ops.kalman_chunked (the same chunk body and carries) and
# scores each candidate measurement's one-step-ahead NIS against the filtered
# state, in parallel within the chunk. The final trajectory then runs through
# kalman_chunked.fuse_ekf_rts_chunked with the gated availability.
# ---------------------------------------------------------------------------


def _gate_chunk(times, pos, quats, z, av_e, av_u, gate, q_carry, elem_carry, Q_pos_diag, R_diag, scan_fn=None):
    """One chunk of a gate pass (L + 1 poses, L candidate steps): (accept
    (L,), nis (L,), new q_carry, new elem_carry). Row 0 of the forward
    chunk is the carried filtered state at the chunk's first pose, so rows
    0..L-1 are the one-step-back states of steps 0..L-1. The chunked
    gate's program (``kalman_chunked.run_chunk``)."""
    qf, m_f, P_f6, d, Qd_diag, elem_carry = kalman_chunked.forward_chunk(
        times, pos, quats, z, av_u, q_carry, elem_carry, Q_pos_diag, R_diag, scan_fn
    )
    accept, nis = _one_step_nis(
        m_f[:-1], torch.stack([P_f6[:-1, 0], P_f6[:-1, 3], P_f6[:-1, 5]], dim=-1), d, Qd_diag, R_diag,
        torch.nan_to_num(z, nan=0.0), av_e, gate
    )
    return accept, nis, qf[-1], elem_carry


def gated_availability_chunked(
    slam_times,
    slam_pos,
    slam_quat,
    init_pos,
    init_quat,
    aligned_gps,
    avail_eval,
    avail_update,
    ekf_cfg: EKFConfig = EKFConfig(),
    gate_chi2: float = CHI2_3DOF_95,
    chunk_size: int = 262144,
    dtype: torch.dtype = torch.float64,
    device=None,
    scan_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One χ² gate pass over a host-resident trajectory of any length
    (``scan_fn``: see ``kalman_chunked.fuse_ekf_rts_chunked``).

    NumPy (or memory-mapped) inputs, O(chunk_size) device residency on
    ``device`` (the card unless the caller names another); staged, padded
    and software-pipelined like ``kalman_chunked.fuse_ekf_rts_chunked``.
    Semantics of ``_parallel_nis`` (decisions fold in on the next
    iteration); at the gate's fixed point this equals the sequential in-core
    gate. Each chunk's two scans run over chunk_size + 1 elements: K2 on the
    card at the default chunk. Returns host (accepted (N,), nis (N,))."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    n = len(slam_times)
    accepted = np.empty(n, bool)
    nis_all = np.zeros(n, np_dt)
    accepted[0] = bool(avail_eval[0])

    def dev(a):
        return streaming.to_device((np.asarray(a, np_dt),), device)[0]

    params = ekf_params(ekf_cfg, dtype=dtype, device=device)
    Q_pos_diag = torch.diagonal(params.Q_per_sec)[:3]
    R_diag = torch.diagonal(params.R)
    q_carry = dev(init_quat)
    elem_carry = prior_element(dev(init_pos), dev(ekf_cfg.initial_cov_diag)[:3])
    L = int(chunk_size)

    def _stage(ab):
        return kalman_chunked.stage_forward_chunk(
            ab, L, np_dt, device, slam_times, slam_pos, slam_quat, aligned_gps, avail_eval, avail_update
        )

    def _launch(ab, staged):
        nonlocal q_carry, elem_carry
        acc, nis, q_carry, elem_carry = kalman_chunked.run_chunk(
            _gate_chunk, *staged, gate_chi2, q_carry, elem_carry, Q_pos_diag, R_diag, scan_fn=scan_fn
        )
        lb = ab[1] - ab[0]
        return streaming.fetch((acc[:lb], nis[:lb]))

    def _drain(ab, fetched):
        a, b = ab
        accepted[a + 1 : b + 1], nis_all[a + 1 : b + 1] = fetched.numpy()

    streaming.stream_chunks(kalman_chunked.forward_chunk_bounds(n, L), _stage, _launch, _drain)
    return accepted, nis_all


def fuse_robust_chunked(
    slam_times,
    slam_pos,
    slam_quat,
    sim3_pos0,
    sim3_quat0,
    aligned_gps,
    valid_mask,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
    gate_chi2: float = CHI2_3DOF_95,
    n_iterations: int = 2,
    chunk_size: int = 262144,
    dtype: torch.dtype = torch.float64,
    device=None,
    scan_fn=None,
    out_pos=None,
    out_quat=None,
):
    """χ²-gated EKF + RTS over a host-resident trajectory of any length:
    ``fuse_robust(gate_mode="parallel")`` out of core, every chunk's scans
    by ``scan_fn`` (None: ``ops.scan.associative_scan``).

    The gate iterates to a fixed point of the accept mask, at most
    ``n_iterations`` passes of ``gated_availability_chunked``, and logs a
    warning when the cap cuts it short; then one
    ``kalman_chunked.fuse_ekf_rts_chunked`` with the gated availability.
    Returns host arrays (pos (N,3), quat (N,4), accepted (N,), nis (N,));
    ``out_pos``/``out_quat`` may be preallocated buffers, memmaps too (see
    ``kalman_chunked.fuse_ekf_rts_chunked`` for the aliasing rule)."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    avail = np.asarray(valid_mask, bool) & ~np.isnan(np.asarray(aligned_gps)).any(-1)
    accepted = avail.copy()
    nis = np.zeros(len(slam_times), np_dt)
    converged = True
    for _ in range(n_iterations):
        prev = accepted
        accepted, nis = gated_availability_chunked(
            slam_times, slam_pos, slam_quat, sim3_pos0, sim3_quat0, aligned_gps, avail, accepted,
            ekf_cfg=ekf_cfg, gate_chi2=gate_chi2, chunk_size=chunk_size, dtype=dtype, device=device,
            scan_fn=scan_fn,
        )
        converged = bool(np.array_equal(accepted, prev))
        if converged:
            break
    if not converged:
        get_logger().warning(
            "chunked robust gate accept mask did not reach a fixed point "
            "within n_iterations=%d; rerun with a larger n_iterations.",
            n_iterations,
        )
    gated_gps = np.where(accepted[:, None], np.asarray(aligned_gps), np.nan).astype(np_dt)
    pos, quatn = kalman_chunked.fuse_ekf_rts_chunked(
        slam_times, slam_pos, slam_quat, sim3_pos0, sim3_quat0, gated_gps, accepted,
        ekf_cfg=ekf_cfg, rts_cfg=rts_cfg, rts_mode=rts_mode, chunk_size=chunk_size,
        dtype=dtype, device=device, scan_fn=scan_fn, out_pos=out_pos, out_quat=out_quat,
    )
    return pos, quatn, accepted, nis
