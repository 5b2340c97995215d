"""Out-of-core EKF + RTS fusion: the associative scans re-entrant over
host-streamed chunks (port of ``gps_optimize_slam_tpu.ops.kalman_chunked``).

Both passes of the temporally parallel filter (``ops.kalman_parallel``) are
associative scans, so they re-enter exactly:

* forward: the composite PREFIX element of everything before a chunk is a
  single 27-component filtering element (A 3×3, b 3, C sym 6, η 3, J sym 6);
  prepend it, scan the chunk, keep the last composite as the next carry.
  The quaternion chain carries one quaternion the same way.
* backward (RTS): the composite SUFFIX element after a chunk is one
  12-component smoothing element (M 3×3, c 3); append it, reverse-scan.

The carries stay device tensors. In the port's structure-of-arrays layout a
filtering element already is the packed 27-vector of the JAX package's
``_pack_fwd`` (A, b, C, η, J), so packing is the identity here. Each chunk's
scans run over chunk_size + 1 elements and go through ``ops.scan``: K1 on
the card up to 65,536 elements, K2 (the tiled scan) beyond, which is every
chunk of the default 262,144 poses.

The host loop streams chunk inputs (NumPy arrays or memmaps) with
``torch.as_tensor(..., device=device)`` and writes outputs into host NumPy
arrays: device residency is O(chunk), host residency O(N). Control signals (outage runs, recovery analysis, RTS membership) are
recomputed in NumPy (``controls_numpy``). Matches
``kalman_parallel.fuse_ekf_rts_parallel`` (same element algebra, same
combine order); hard updates only (transition steps ≡ 0).

A ``scan_fn`` (``parallel.seqpar.sequence_parallel_scan(mesh)``) splits
each chunk's scans over the devices of a mesh: host chunks meet device
blocks. Each scan runs over chunk_size + 1 elements (the carry first), so
``chunk_size = k·D − 1`` lines the blocks up on a D-device mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.kalman import ekf_params
from gps_optimize_slam_tpu_torch.ops.kalman_parallel import (
    ScanFn,
    filter_step_elements,
    parallel_quat_chain,
    prior_element,
)
from gps_optimize_slam_tpu_torch.ops.scan import _minv, _mmul, _mvec, associative_scan, sym_expand
from gps_optimize_slam_tpu_torch.utils import streaming
from gps_optimize_slam_tpu_torch.utils.device import numpy_dtype, resolve_device


def controls_numpy(
    slam_times: np.ndarray,
    slam_quats: np.ndarray,
    aligned_gps: np.ndarray,
    valid_mask: np.ndarray,
    rts_cfg: RTSDecisionConfig,
    rts_mode: str = "outage",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(avail, rts_member, rts_end) as host bool arrays: the semantics of
    ``kalman.precompute_controls`` (reference outage bookkeeping,
    EKFGPSSLAM.py:861-899) as vectorised NumPy prefix ops, suitable for
    memory-mapped inputs."""
    n = len(slam_times)
    avail = np.asarray(valid_mask) & ~np.isnan(np.asarray(aligned_gps)).any(-1)
    idx = np.arange(n)
    avail_prev = np.concatenate([avail[:1], avail[:-1]])
    is_recovery = avail & ~avail_prev
    is_recovery[0] = False

    last_avail = np.maximum.accumulate(np.where(avail, idx, -1))
    run_start = last_avail + 1
    run_len_at = idx - last_avail

    q = np.asarray(slam_quats, np.float64)
    # Yaw from quaternion (zyx convention, matching ops.quaternion.yaw).
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    yaws = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    dyaw = np.mod(yaws[1:] - yaws[:-1] + np.pi, 2.0 * np.pi) - np.pi
    dts = np.asarray(slam_times)[1:] - np.asarray(slam_times)[:-1]
    rate = np.where(dts > 0, np.abs(dyaw / np.where(dts > 0, dts, 1.0)), 0.0)
    thresh = np.deg2rad(rts_cfg.sharp_turn_yaw_rate_threshold_deg_per_sec)
    pair_in_run = (~avail[:-1]) & (~avail[1:])
    high = pair_in_run & (rate > thresh)
    cum_high = np.concatenate([[0], np.cumsum(high.astype(np.int64))])
    bad_quat = (np.linalg.norm(q, axis=-1) < 1e-15) & ~avail
    cum_bad = np.concatenate([[0], np.cumsum(bad_quat.astype(np.int64))])

    prev_run_start = np.concatenate([[0], run_start[:-1]])
    prev_run_len = np.concatenate([[0], run_len_at[:-1]])
    analyse = is_recovery & (prev_run_len >= 2)
    s_clip = np.clip(prev_run_start, 0, n - 1)
    any_high = (cum_high[np.clip(idx - 1, 0, n - 1)] - cum_high[s_clip]) > 0
    any_bad = (cum_bad[idx] - cum_bad[s_clip]) > 0
    sharp = analyse & (any_high | any_bad)
    perform_rts = is_recovery & ~sharp

    run_last = (~avail) & np.concatenate([avail[1:], [False]])
    e_rev = np.maximum.accumulate(np.where(run_last, (n - 1) - idx, -1)[::-1])[::-1]
    found = e_rev >= 0
    run_end = (n - 1) - np.where(found, e_rev, 0)
    member_invalid = (~avail) & found & perform_rts[np.clip(run_end + 1, 0, n - 1)]
    rts_member = member_invalid | perform_rts
    rts_end = perform_rts

    if rts_mode == "full":
        rts_member = np.ones(n, bool)
        rts_end = np.zeros(n, bool)
        rts_end[n - 1] = True
    return avail, rts_member, rts_end


def forward_chunk(times, pos, quats, z, avail, q_carry, elem_carry, Q_pos_diag, R_diag,
                  scan_fn: Optional[ScanFn] = None):
    """One forward chunk over L steps (L + 1 poses, the overlap pose first),
    its two scans by ``scan_fn`` (None: ``associative_scan``).

    Row 0 of every (L + 1)-row output is the carried state at the chunk's
    first pose, rows 1..L the chunk's own poses: the fusion keeps rows 1..L,
    the robust gate (``models.robust``) predicts step k from row k. Returns
    (q_f (L+1,4), m_f (L+1,3), P_f6 (L+1,6), d (L,3), Qd (L,3),
    new_elem_carry (27,)); the next quaternion carry is ``q_f[-1]``."""
    dp, dq = se3.relative_poses_along(pos, quats)
    qf = parallel_quat_chain(q_carry, dq, scan_fn)  # (L+1, 4)
    d = quat.rotate(qf[:-1], dp)
    dt = torch.clamp(times[1:] - times[:-1], min=1e-6)
    Qd_diag = Q_pos_diag[None, :] * dt[:, None]
    steps = filter_step_elements(avail, d, Qd_diag, torch.nan_to_num(z, nan=0.0), R_diag)
    out = (scan_fn or associative_scan)("filter", torch.cat([elem_carry[:, None], steps], dim=1))
    return qf, out[9:12].T, out[12:18].T, d, Qd_diag, out[:, -1].contiguous()


def forward_chunk_bounds(n: int, chunk_size: int):
    """The (first pose, last pose) pairs of the forward chunks over steps
    0..n-2 (step k joins poses k and k+1)."""
    return ((a, min(a + chunk_size, n - 1)) for a in range(0, n - 1, chunk_size))


def stage_forward_chunk(ab, chunk_size, np_dt, device, slam_times, slam_pos, slam_quat, aligned_gps, *masks):
    """Host prep + transfer of one forward chunk: poses a..b, the
    measurements and the per-step ``masks`` of poses a+1..b. The last chunk
    is padded to the fixed chunk shape with repeats (zero motion, masks
    False: inert steps whose outputs are discarded; the carries are unused
    after the final chunk)."""
    a, b = ab
    sl_t = np.asarray(slam_times[a : b + 1], np_dt)
    sl_p = np.asarray(slam_pos[a : b + 1], np_dt)
    sl_q = np.asarray(slam_quat[a : b + 1], np_dt)
    z = np.asarray(aligned_gps[a + 1 : b + 1], np_dt)
    masks = [np.asarray(m[a + 1 : b + 1], bool) for m in masks]
    padp = chunk_size - (b - a)
    if padp > 0:
        sl_t = np.concatenate([sl_t, sl_t[-1] + 1e-3 * np.arange(1, padp + 1)])
        sl_p = np.concatenate([sl_p, np.repeat(sl_p[-1:], padp, 0)])
        sl_q = np.concatenate([sl_q, np.repeat(sl_q[-1:], padp, 0)])
        z = np.concatenate([z, np.zeros((padp, 3), np_dt)])
        masks = [np.concatenate([m, np.zeros(padp, bool)]) for m in masks]
    return tuple(torch.as_tensor(x, device=device) for x in (sl_t, sl_p, sl_q, z, *masks))


def _backward_chunk(m_f, P_f6, d, Qd_diag, interior, carry_M, carry_c, scan_fn: Optional[ScanFn] = None):
    """One backward (RTS) chunk over L steps, its suffix scan by ``scan_fn``
    (None: ``associative_scan``). ``m_f``/``P_f6`` are the filtered stats at
    the LEFT pose of each step, ``interior`` marks RTS-interior steps.
    Returns (m_s (L,3), new_carry_M (9,), new_carry_c (3,))."""
    zero = torch.zeros_like(Qd_diag[:, 0])
    Qd_m = [Qd_diag[:, 0], zero, zero, zero, Qd_diag[:, 1], zero, zero, zero, Qd_diag[:, 2]]
    Pf_m = sym_expand(P_f6.unbind(1))
    E = _mmul(Pf_m, _minv([p + q for p, q in zip(Pf_m, Qd_m)]))
    E = [torch.where(interior, e, zero) for e in E]
    mf = list(m_f.unbind(1))
    m_p_next = [m + dd for m, dd in zip(mf, d.unbind(1))]
    c_full = [x - y for x, y in zip(mf, _mvec(E, m_p_next))]
    c = [torch.where(interior, cf, x) for cf, x in zip(c_full, mf)]
    tail = torch.cat([carry_M, carry_c])
    out = (scan_fn or associative_scan)("rts", torch.cat([torch.stack(E + c), tail[:, None]], dim=1), reverse=True)
    return out[9:12, :-1].T, out[:9, 0].contiguous(), out[9:12, 0].contiguous()


def fuse_ekf_rts_chunked(
    slam_times: np.ndarray,
    slam_pos: np.ndarray,
    slam_quat: np.ndarray,
    sim3_pos0: np.ndarray,
    sim3_quat0: np.ndarray,
    aligned_gps: np.ndarray,
    valid_mask: np.ndarray,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
    chunk_size: int = 262144,
    dtype: torch.dtype = torch.float64,
    device=None,
    scan_fn: Optional[ScanFn] = None,
    out_pos: Optional[np.ndarray] = None,
    out_quat: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """EKF + RTS over a host-resident (possibly memory-mapped) trajectory of
    any length, streaming fixed-size chunks through ``device`` (the card
    unless the caller names another; see ``utils.device.resolve_device``).
    ``scan_fn`` (``parallel.seqpar.sequence_parallel_scan(mesh)``) runs each
    chunk's three scans; pick ``chunk_size = k·D − 1`` for a D-device mesh.

    All inputs are NumPy arrays (or memmaps); device memory use is
    O(chunk_size). Chunk transfers are software-pipelined
    (``utils.streaming``): chunk i+1's inputs are staged before chunk i's
    outputs are read back. Equivalent to
    ``kalman_parallel.fuse_ekf_rts_parallel``; returns host (pos (N,3),
    quat (N,4)): ``out_pos`` and ``out_quat`` when given, preallocated
    (N,3) and (N,4) host buffers (a ``np.memmap`` too) that must not alias
    the inputs (chunk i+1's inputs are read before chunk i's outputs are
    written).
    """
    if rts_cfg.default_ekf_transition_steps_on_sharp_turn != 0:
        raise ValueError("chunked scan requires hard updates (transition steps == 0)")
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    n = len(slam_times)
    avail, member, end = controls_numpy(slam_times, slam_quat, aligned_gps, valid_mask, rts_cfg, rts_mode)

    out_pos = np.empty((n, 3), np_dt) if out_pos is None else out_pos
    out_quat = np.empty((n, 4), np_dt) if out_quat is None else out_quat
    m_f_all = np.empty((n, 3), np_dt)
    P_f6_all = np.empty((n, 6), np_dt)
    d_all = np.empty((max(n - 1, 0), 3), np_dt)
    Qd_all = np.empty((max(n - 1, 0), 3), np_dt)

    def dev(a):
        return torch.as_tensor(a, device=device)

    params = ekf_params(ekf_cfg, dtype=dtype, device=device)
    Q_pos_diag = torch.diagonal(params.Q_per_sec)[:3]
    R_diag = torch.diagonal(params.R)
    P0_diag = np.asarray(ekf_cfg.initial_cov_diag, np_dt)[:3]
    q0 = np.asarray(sim3_quat0, np_dt)
    m0 = np.asarray(sim3_pos0, np_dt)
    q_carry = dev(q0)
    elem_carry = prior_element(dev(m0), dev(P0_diag))

    # Pose 0 outputs.
    out_pos[0] = m0
    out_quat[0] = q0 / max(np.linalg.norm(q0), 1e-30)
    m_f_all[0] = m0
    P_f6_all[0] = [P0_diag[0], 0.0, 0.0, P0_diag[1], 0.0, P0_diag[2]]

    # --- forward chunks over steps k = 0..n-2 (step k joins poses k, k+1) ---
    L = int(chunk_size)

    def _fwd_stage(ab):
        return stage_forward_chunk(ab, L, np_dt, device, slam_times, slam_pos, slam_quat, aligned_gps, avail)

    def _fwd_launch(ab, staged):
        nonlocal q_carry, elem_carry
        qf, m_f, P_f6, d, Qd, elem_carry = forward_chunk(*staged, q_carry, elem_carry, Q_pos_diag, R_diag, scan_fn)
        q_carry = qf[-1]
        return qf[1:], m_f[1:], P_f6[1:], d, Qd

    def _fwd_drain(ab, launched):
        a, b = ab
        lb = b - a
        qf, m_f, P_f6, d, Qd = (x[:lb].cpu().numpy() for x in launched)
        out_quat[a + 1 : b + 1] = qf
        m_f_all[a + 1 : b + 1] = m_f
        P_f6_all[a + 1 : b + 1] = P_f6
        d_all[a:b] = d
        Qd_all[a:b] = Qd

    streaming.stream_chunks(forward_chunk_bounds(n, L), _fwd_stage, _fwd_launch, _fwd_drain)

    # --- backward chunks (suffix scan) ---
    interior_steps = member[:-1] & ~end[:-1] if n > 1 else np.zeros(0, bool)
    m_s_all = np.empty((n, 3), np_dt)
    m_s_all[n - 1] = m_f_all[n - 1]
    # Anchor carry: (M = 0, c = m_f[n-1]).
    carry_M = dev(np.zeros(9, np_dt))
    carry_c = dev(np.asarray(m_f_all[n - 1], np_dt))

    def _bwd_stage(ab):
        a, b = ab
        lb = b - a
        m_f = m_f_all[a:b]
        P_f6 = P_f6_all[a:b]
        d = d_all[a:b]
        Qd = Qd_all[a:b]
        it = interior_steps[a:b]
        if lb < L:
            padp = L - lb
            # Left-pad with inert steps (interior False, m_f = 0): non-interior
            # elements are (M = 0, c = m_f) resets, so the pad rows give pad
            # outputs that are discarded.
            m_f = np.concatenate([np.zeros((padp, 3), np_dt), m_f])
            P_f6 = np.concatenate([np.tile(np.asarray([1.0, 0, 0, 1.0, 0, 1.0], np_dt), (padp, 1)), P_f6])
            d = np.concatenate([np.zeros((padp, 3), np_dt), d])
            Qd = np.concatenate([np.ones((padp, 3), np_dt), Qd])
            it = np.concatenate([np.zeros(padp, bool), it])
        return tuple(dev(np.ascontiguousarray(x)) for x in (m_f, P_f6, d, Qd, it))

    def _bwd_launch(ab, staged):
        nonlocal carry_M, carry_c
        m_s, carry_M, carry_c = _backward_chunk(*staged, carry_M, carry_c, scan_fn)
        return m_s

    def _bwd_drain(ab, m_s):
        a, b = ab
        lb = b - a
        m_s_all[a:b] = m_s[L - lb :].cpu().numpy()

    streaming.stream_chunks(
        ((max(b - L, 0), b) for b in range(n - 1, 0, -L)), _bwd_stage, _bwd_launch, _bwd_drain
    )

    out_pos[:] = np.where(member[:, None], m_s_all, m_f_all)
    return out_pos, out_quat
