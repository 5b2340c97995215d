"""Sequential EKF + RTS trajectory fusion (port of
``gps_optimize_slam_tpu.ops.kalman``).

The reference's hot path (ExtendedKalmanFilter EKFGPSSLAM.py:679-772,
rts_smoother_segment :777-803, sharp-turn detector :808-826, orchestrator
:831-935) in three parts:

1. ``precompute_controls``: every control decision (outages, recoveries,
   sharp turns, RTS membership) depends only on the GPS validity mask and
   the raw SLAM stream, so it is computed up front with two scans of pose
   indices (running maxima forward, minima backward; ``ops.scan``, K1/K2
   on a card), per block of the pose axis if need be
   (``controls_over_blocks``);
2. a forward pass (predict / masked update / transition blending);
3. one backward pass applying every per-outage RTS segment (segments are
   disjoint, so one reverse pass with resets at segment ends equals the
   reference's per-segment smoothing, quirk Q8 included).

State ``[x y z qx qy qz qw]``, the quaternion filtered as a raw 4-vector and
renormalised, F = I for the covariance (Q7), H = [I₃ 0], Joseph-form update.
The two passes are Python loops over small tensors: this is the CPU path
(``ekf_scan="auto"`` on CPU) and the only path with transition blending;
``ops.kalman_parallel`` is the log-depth path for accelerators. Under a
leading batch axis (one sequence a row) ``precompute_controls`` runs on all
rows at once and ``fuse_ekf_rts``, a host recurrence already, loops over
the rows.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.scan import associative_scan


class EKFParams(NamedTuple):
    P0: torch.Tensor  # (7,7) initial covariance
    Q_per_sec: torch.Tensor  # (7,7) process noise per second
    R: torch.Tensor  # (3,3) measurement noise


def device_vector(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A config tuple as a vector made on ``device`` by fills, with no copy
    from the host: inside a captured graph a host copy would replay the
    bytes of a host buffer long freed, or wait on the device and fail."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])


def ekf_params(cfg: EKFConfig, *, device, dtype=torch.float64) -> EKFParams:
    def diag(v):
        return torch.diag(device_vector(v, dtype, device))

    return EKFParams(
        P0=diag(cfg.initial_cov_diag),
        Q_per_sec=diag(cfg.process_noise_diag),
        R=diag(cfg.meas_noise_diag),
    )


class FusionControls(NamedTuple):
    """Per-step control signals, all derived before the filter runs."""

    avail: torch.Tensor  # (N,) bool — usable GPS measurement at step i
    is_recovery: torch.Tensor  # (N,) bool — GNSS recovered at step i
    eff_transition_steps: torch.Tensor  # (N,) int — EKF blending steps
    rts_member: torch.Tensor  # (N,) bool — inside an RTS-smoothed span
    rts_end: torch.Tensor  # (N,) bool — recovery point ending an RTS span
    sharp_turn: torch.Tensor  # (N,) bool — outage ending here was sharp


def _sym(M: torch.Tensor) -> torch.Tensor:
    return (M + M.transpose(-1, -2)) / 2.0


class ControlsBlock(NamedTuple):
    """One block of the pose axis for :func:`controls_over_blocks`: its
    poses, the global index of its first, and, for every block but the
    first, the raw inputs of the pose just before it (each with a pose axis
    of length 1)."""

    times: torch.Tensor  # (..., L)
    quats: torch.Tensor  # (..., L, 4)
    gps: torch.Tensor  # (..., L, 3) aligned GNSS, NaN where missing
    valid: torch.Tensor  # (..., L) bool
    start: int = 0
    prev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = None  # times, quats, gps, valid


# (op, [per-block (L, ..., n_k) leaves, each on its block's device], reverse)
# -> the inclusive scan of ``op`` across the blocks, a block each on its
# device (``ops.scan.associative_scan``'s contract over a list of blocks;
# ``parallel.seqpar`` splits it over a mesh).
BlockScanFn = Callable[[str, List[torch.Tensor], bool], List[torch.Tensor]]


# run(fn, *args) -> fn(*args): how a stage of a blocked filter runs on one
# block (the default calls it; ``parallel.seqpar`` runs it as a captured
# program on the block's device, ``utils.graphs.run``).
StageFn = Callable[..., Any]


def call_stage(fn: Callable, *args):
    """The default :data:`StageFn`: the call itself."""
    return fn(*args)


def one_block_scan(op: str, blocks: List[torch.Tensor], reverse: bool = False) -> List[torch.Tensor]:
    """The :data:`BlockScanFn` of a single block: ``associative_scan``."""
    if len(blocks) != 1:
        raise ValueError("several blocks need a scan across them (parallel.seqpar.block_scan)")
    return [associative_scan(op, blocks[0], reverse)]


def _available(valid: torch.Tensor, gps: torch.Tensor) -> torch.Tensor:
    return valid & ~torch.any(torch.isnan(gps), dim=-1)


class _Marks(NamedTuple):
    gidx: torch.Tensor  # (L,) global pose indices, float64
    avail: torch.Tensor
    avail_prev: torch.Tensor
    # (3, ..., L) float64: the index of each available pose, of each pose
    # that ends a high-yaw-rate pair inside an outage, of each degenerate
    # quaternion inside an outage; -1 elsewhere.
    last: torch.Tensor


def _marks(b: ControlsBlock, thresh: float) -> _Marks:
    """What a block computes alone, from its poses and the pose before it."""
    n = b.times.shape[-1]
    gidx = (b.start + torch.arange(n, device=b.times.device)).to(torch.float64)
    avail = _available(b.valid, b.gps)
    if b.prev is None:
        # The first block: avail_prev[0] = avail[0], and no pair ends at pose 0.
        avail_prev = torch.cat([avail[..., :1], avail[..., :-1]], -1)
        t_ext, q_ext, a_ext = b.times, b.quats, avail
    else:
        pt, pq, pg, pv = b.prev
        a0 = _available(pv, pg)
        avail_prev = torch.cat([a0, avail[..., :-1]], -1)
        t_ext, q_ext, a_ext = torch.cat([pt, b.times], -1), torch.cat([pq, b.quats], -2), torch.cat([a0, avail], -1)
    yaws = quat.yaw(q_ext)
    dyaw = quat.wrap_angle(yaws[..., 1:] - yaws[..., :-1])
    dts = t_ext[..., 1:] - t_ext[..., :-1]
    rate = torch.where(
        dts > 0, torch.abs(dyaw / torch.where(dts > 0, dts, torch.ones_like(dts))), 0.0
    )
    pair_in_run = (~a_ext[..., :-1]) & (~a_ext[..., 1:])
    high = pair_in_run & (rate > thresh)  # the pair ending at each pose (from the second on)
    if b.prev is None:
        high = torch.cat([torch.zeros_like(avail[..., :1]), high], -1)
    bad_quat = (quat.norm(b.quats) < 1e-15) & ~avail
    last = torch.stack([torch.where(m, gidx, -1.0) for m in (avail, high, bad_quat)])
    return _Marks(gidx, avail, avail_prev, last)


def controls_over_blocks(
    blocks: Sequence[ControlsBlock],
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    block_scan: BlockScanFn = one_block_scan,
    run: StageFn = call_stage,
) -> List[FusionControls]:
    """:func:`precompute_controls` of a trajectory split into contiguous
    blocks, each on its own device, every field equal to the whole
    trajectory's on every pose. Outages cross block edges through a
    one-pose halo (``ControlsBlock.prev``) and two scans over the blocks
    (``block_scan``; K1/K2 on a card), of pose indices as float64 (exact
    below 2^53):

    * forward, ``max3`` of the indices of the available poses, of the poses
      ending a high-yaw-rate pair in an outage and of the degenerate
      quaternions in an outage: the outage [s, i−1] before a recovery i
      starts after the last available pose, and is sharp iff the last of
      the others before i lies inside it (the whole-trajectory form's
      counts, as indices);
    * backward, ``min3`` of the indices of the available poses and of the
      recoveries that perform RTS: an outage pose is smoothed iff the first
      of each after it is the same pose, its recovery.

    The work of a block between the scans runs in three stages, each
    through ``run``; the running maxima at the pose before a block (the
    previous block's last) cross to its device between them."""
    thresh = torch.deg2rad(  # a host tensor: no wait on a device
        torch.tensor(rts_cfg.sharp_turn_yaw_rate_threshold_deg_per_sec, dtype=blocks[0].times.dtype)
    ).item()
    marks = [run(_marks, b, thresh) for b in blocks]
    last = block_scan("max3", [m.last for m in marks], False)
    steps = rts_cfg.default_ekf_transition_steps_on_sharp_turn
    fwd = [run(_forward, m, last[k], None if k == 0 else last[k - 1][..., -1:].to(last[k].device), steps)
           for k, m in enumerate(marks)]
    nexts = block_scan("min3", [f.firsts for f in fwd], True)
    return [run(_block_controls, m, f, nxt) for m, f, nxt in zip(marks, fwd, nexts)]


class _Forward(NamedTuple):
    is_recovery: torch.Tensor
    sharp: torch.Tensor
    perform_rts: torch.Tensor
    eff_steps: torch.Tensor
    # (3, ..., L) float64: the index of each available pose and, twice, of
    # each recovery that performs RTS; +inf elsewhere (the min3 scan's leaves).
    firsts: torch.Tensor


def _forward(m: _Marks, last: torch.Tensor, first: Optional[torch.Tensor], steps: int) -> _Forward:
    """A block's recoveries and sharp outages, from the running maxima
    ``last`` and those at the pose before the block, ``first`` (None: the
    first block, -1)."""
    if first is None:
        first = torch.full_like(last[..., :1], -1.0)
    before = torch.cat([first, last[..., :-1]], -1)
    prev_run_start = before[0] + 1
    is_recovery = m.avail & ~m.avail_prev & (m.gidx != 0)
    analyse = is_recovery & (m.gidx - prev_run_start >= 2)
    # The outage [s, i-1] before a recovery i holds a high-rate pair iff
    # one ends in [s+1, i-1], a degenerate quaternion iff one lies in [s, i-1].
    sharp = analyse & ((before[1] >= prev_run_start + 1) | (before[2] >= prev_run_start))
    perform_rts = is_recovery & ~sharp
    inf = float("inf")
    avail_at, rts_at = torch.where(m.avail, m.gidx, inf), torch.where(perform_rts, m.gidx, inf)
    return _Forward(is_recovery, sharp, perform_rts, torch.where(sharp, steps, 0),
                    torch.stack([avail_at, rts_at, rts_at]))


def _block_controls(m: _Marks, f: _Forward, nxt: torch.Tensor) -> FusionControls:
    """A block's controls from the running minima ``nxt``."""
    # RTS membership: the outage run [s..i−1] of a perform_rts recovery
    # i, plus i itself; a trailing run (no recovery) stays unsmoothed.
    member_invalid = (~m.avail) & (nxt[0] == nxt[1]) & (nxt[0] < float("inf"))
    return FusionControls(
        avail=m.avail,
        is_recovery=f.is_recovery,
        eff_transition_steps=f.eff_steps,
        rts_member=member_invalid | f.perform_rts,
        rts_end=f.perform_rts,
        sharp_turn=f.sharp,
    )


def precompute_controls(
    slam_times: torch.Tensor,
    slam_quats: torch.Tensor,
    aligned_gps: torch.Tensor,
    valid_mask: torch.Tensor,
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
) -> FusionControls:
    """Outage bookkeeping and recovery-time sharp-turn analysis (reference
    EKFGPSSLAM.py:861-899): recovery at i ⟺ avail[i] ∧ ¬avail[i−1]; an
    outage [s, i−1] of length ≥2 is sharp when any within-run yaw rate
    exceeds the threshold or any quaternion is degenerate; sharp ⇒ no RTS
    and the configured transition steps, else RTS + hard update. The
    one-block case of :func:`controls_over_blocks`."""
    (out,) = controls_over_blocks([ControlsBlock(slam_times, slam_quats, aligned_gps, valid_mask)], rts_cfg)
    return out


class EKFHistory(NamedTuple):
    filt_state: torch.Tensor  # (N,7)
    filt_cov: torch.Tensor  # (N,7,7)
    pred_state: torch.Tensor  # (N,7)
    pred_cov: torch.Tensor  # (N,7,7)


def ekf_forward(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    slam_quat: torch.Tensor,
    init_pos: torch.Tensor,
    init_quat: torch.Tensor,
    aligned_gps: torch.Tensor,
    controls: FusionControls,
    params: EKFParams,
    avail_prev0=None,
) -> EKFHistory:
    """Forward EKF pass (reference process_step loop, EKFGPSSLAM.py:736-772
    and :864-904). Motion from the original SLAM stream (relative poses),
    measurements from the aligned GPS; index 0 is the initial state."""
    n = slam_times.shape[0]
    dtype, device = slam_pos.dtype, slam_pos.device
    state = torch.cat([init_pos, quat.normalize(init_quat)])
    cov = params.P0.to(dtype)
    dp, dq = se3.relative_poses_along(slam_pos, slam_quat)
    dt = torch.clamp(slam_times[1:] - slam_times[:-1], min=1e-6)
    gps_meas = torch.nan_to_num(aligned_gps[1:], nan=0.0)
    avail = controls.avail[1:].tolist()
    ets = controls.eff_transition_steps[1:].tolist()
    I7 = torch.eye(7, dtype=dtype, device=device)
    R = params.R.to(dtype)
    Q = params.Q_per_sec.to(dtype)

    # The reference seeds gnss_available_prev from the RAW validity mask
    # (EKFGPSSLAM.py:848), before the NaN check; callers pass it through.
    avail_prev = bool(controls.avail[0] if avail_prev0 is None else avail_prev0)
    weight = 0.0
    hist = ([state], [cov], [state], [cov])
    for i in range(n - 1):
        # predict (EKFGPSSLAM.py:702-715)
        pred_pos, pred_q = se3.compose(state[:3], state[3:], dp[i], dq[i])
        pred_state = torch.cat([pred_pos, pred_q])
        pred_cov = _sym(cov + Q * torch.clamp(torch.abs(dt[i]), min=1e-6))
        a_i, e_i = avail[i], ets[i]
        if a_i:
            # update (EKFGPSSLAM.py:717-732), H = [I₃ 0]
            innovation = gps_meas[i] - pred_state[:3]
            S = _sym(pred_cov[:3, :3] + R)
            K = pred_cov[:, :3] @ torch.linalg.inv(S)
            upd_state = pred_state + K @ innovation
            upd_state = torch.cat([upd_state[:3], quat.normalize(upd_state[3:])])
            IKH = I7.clone()
            IKH[:, :3] -= K
            upd_cov = _sym(IKH @ pred_cov @ IKH.T + K @ R @ K.T)
        # GNSS weight ramp (EKFGPSSLAM.py:741-758)
        weight_delta = 1.0 / max(float(e_i), 1.0) if e_i > 0 else 1.0
        if not a_i:
            new_weight = 0.0
        elif (a_i and not avail_prev) or e_i == 0:
            new_weight = 1.0 if e_i == 0 else weight_delta
        else:
            new_weight = min(1.0, weight + weight_delta) if weight < 1.0 else weight
        # fuse (EKFGPSSLAM.py:760-768)
        if a_i and new_weight < 1.0 and e_i > 0:
            w = new_weight
            smooth_pos = (1.0 - w) * pred_state[:3] + w * upd_state[:3]
            state = torch.cat([smooth_pos, quat.nlerp(pred_state[3:], upd_state[3:], w)])
            cov = upd_cov
        elif a_i:
            state, cov = upd_state, upd_cov
        else:
            state, cov = pred_state, pred_cov
        weight, avail_prev = new_weight, a_i
        for h, v in zip(hist, (state, cov, pred_state, pred_cov)):
            h.append(v)
    return EKFHistory(*(torch.stack(h) for h in hist))


def rts_backward(history: EKFHistory, controls: FusionControls) -> torch.Tensor:
    """Every outage-segment RTS smoothing in one reverse pass (reference
    rts_smoother_segment, EKFGPSSLAM.py:777-803, splice :906-928): the carry
    resets to the filtered state at each segment end, interior members apply
    A_k = P_f[k]·P_p[k+1]⁻¹, non-members pass the filtered state through.
    Returns the (N,7) smoothed/filtered states."""
    f_s, f_c, p_s, p_c = history
    n = f_s.shape[0]
    member = controls.rts_member.tolist()
    end = controls.rts_end.tolist()
    x_sm, P_sm = f_s[-1], f_c[-1]
    out = [x_sm]
    for k in range(n - 2, -1, -1):
        x_next = f_s[k + 1] if end[k + 1] else x_sm
        P_next = f_c[k + 1] if end[k + 1] else P_sm
        if member[k] and not end[k]:
            A = f_c[k] @ torch.linalg.inv(p_c[k + 1])
            x_int = f_s[k] + A @ (x_next - p_s[k + 1])
            x_sm = torch.cat([x_int[:3], quat.normalize(x_int[3:])])
            P_sm = _sym(f_c[k] + A @ (P_next - p_c[k + 1]) @ A.T)
        else:
            x_sm, P_sm = f_s[k], f_c[k]
        out.append(x_sm)
    return torch.stack(out[::-1])


def full_smoother_controls(controls: FusionControls, start: int = 0, n: Optional[int] = None) -> FusionControls:
    """Full fixed-interval smoothing: one RTS segment over the whole
    trajectory, anchored at the last pose (extension, SURVEY §7 step 9).
    For a block of a longer trajectory: ``start``, the global index of its
    first pose, and ``n``, the trajectory's length (None: the block's
    end)."""
    length = controls.avail.shape[-1]
    n = start + length if n is None else n
    idx = start + torch.arange(length, device=controls.avail.device)
    return controls._replace(rts_member=torch.ones_like(controls.avail),
                             rts_end=(idx == n - 1).expand_as(controls.avail))


def fuse_ekf_rts(
    slam_times: torch.Tensor,
    slam_pos: torch.Tensor,
    slam_quat: torch.Tensor,
    sim3_pos: torch.Tensor,
    sim3_quat: torch.Tensor,
    aligned_gps: torch.Tensor,
    valid_mask: torch.Tensor,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EKF + RTS fusion (reference apply_ekf_correction,
    EKFGPSSLAM.py:831-935). ``rts_mode``: "outage" (reference behaviour) or
    "full" (fixed-interval smoothing over the whole trajectory). Returns
    (positions (N,3), quaternions (N,4)); a batch of sequences (B, N, ...)
    is fused a row at a time."""
    if slam_pos.ndim == 3:
        rows = [fuse_ekf_rts(*(x[r] for x in (slam_times, slam_pos, slam_quat, sim3_pos, sim3_quat,
                                              aligned_gps, valid_mask)), ekf_cfg, rts_cfg, rts_mode)
                for r in range(slam_pos.shape[0])]
        return torch.stack([p for p, _ in rows]), torch.stack([q for _, q in rows])
    controls = precompute_controls(slam_times, slam_quat, aligned_gps, valid_mask, rts_cfg)
    if rts_mode == "full":
        controls = full_smoother_controls(controls)
    params = ekf_params(ekf_cfg, dtype=slam_pos.dtype, device=slam_pos.device)
    hist = ekf_forward(
        slam_times, slam_pos, slam_quat, sim3_pos[0], sim3_quat[0], aligned_gps,
        controls, params, avail_prev0=valid_mask[0],
    )
    smoothed = rts_backward(hist, controls)
    out = torch.where(controls.rts_member[:, None], smoothed, hist.filt_state)
    return out[:, :3], out[:, 3:]
