"""Temporally parallel EKF fusion by associative scans (port of
``gps_optimize_slam_tpu.ops.kalman_parallel``).

The same filter as ``ops.kalman`` in O(log N) depth (Särkkä &
García-Fernández, IEEE TAC 2021), using the problem's structure:

* the 7×7 covariance stays block-diagonal (diagonal P₀ and Q, H = [I₃ 0]),
  so updates never touch the quaternion, and the fused quaternion chain is
  dead-reckoning, q_k = normalize(q₀ ⊗ δq₁ ⊗ … ⊗ δq_k): a product scan;
* given the quaternions, the position filter is an affine Kalman filter
  (F = I, H = I₃) whose five-tuple elements (A, b, C, η, J) combine
  associatively;
* the RTS backward pass is an affine suffix scan with resets at segment
  boundaries (the quaternion block is a no-op).

All three scans, and the controls' two, go through K1/K2
(``ops.scan.associative_scan``): the kernels on CUDA, the plain ladder on
CPU. A ``scan_fn`` of the same contract replaces it in all five
(``parallel.seqpar.sequence_parallel_scan`` splits the pose axis into
blocks on the devices of a mesh); ``fuse_ekf_rts_blocks`` takes the pose
axis already split, each block on its device, and runs every stage there. Leaves are structure-of-arrays: a
3×3 matrix is nine (N,) tensors, a symmetric one six. Under a leading batch axis (one
sequence a row) every leaf is (B, N) and each scan one launch over all
rows, the leaves (27, B, N), (12, B, N) and (4, B, N).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.kalman import (
    BlockScanFn,
    ControlsBlock,
    controls_over_blocks,
    full_smoother_controls,
    one_block_scan,
)
from gps_optimize_slam_tpu_torch.ops.scan import (
    _minv,
    _mmul,
    _mvec,
    associative_scan,
    sym_expand,
)


# A scan of ``ops.scan.associative_scan``'s contract: (op, (L, n) or
# (L, B, n) leaves, reverse=False) -> the inclusive scan, the accumulated
# composite the first combine argument in both directions.
ScanFn = Callable[..., torch.Tensor]


def parallel_quat_chain(init_quat: torch.Tensor, dq: torch.Tensor,
                        scan_fn: Optional[ScanFn] = None) -> torch.Tensor:
    """q_k = normalize(q₀ ⊗ δq₁ ⊗ … ⊗ δq_k) for all k, in log depth:
    init_quat (..., 4), dq (..., N-1, 4) → (..., N, 4). ``scan_fn`` (None:
    ``associative_scan``) runs the product scan."""
    scan_fn = scan_fn or associative_scan
    qs = torch.cat([quat.normalize(init_quat)[..., None, :], dq], -2)
    return torch.movedim(scan_fn("quat_chain", torch.movedim(qs, -1, 0).contiguous()), 0, -1).contiguous()


def filter_step_elements(
    avail: torch.Tensor,  # (L,) bool
    d: torch.Tensor,  # (L,3) world-frame motion deltas
    Qd_diag: torch.Tensor,  # (L,3) per-step process noise diagonal
    z: torch.Tensor,  # (L,3) measurements (arbitrary where invalid)
    R_diag: torch.Tensor,  # (3,) measurement noise diagonal
) -> torch.Tensor:
    """The (27, L) per-step filtering elements (A[9], b[3], C[6], eta[3],
    J[6]) of the affine KF x←x+d, H=I (``kalman_chunked._filter_step_elements``
    of the JAX package). Diagonal Q and R make every element's matrices
    diagonal; only the combine mixes components."""
    S = Qd_diag + R_diag
    K = Qd_diag / S
    IK = 1.0 - K
    av = avail[..., None]
    ikd = torch.where(av, IK, 1.0)
    b = torch.where(av, IK * d + K * z, d)
    Cd = torch.where(av, IK * Qd_diag, Qd_diag)
    eta = torch.where(av, (z - d) / S, 0.0)
    Jd = torch.where(av, 1.0 / S, 0.0)

    zeros = torch.zeros_like(d[..., 0])
    A = [ikd[..., 0], zeros, zeros, zeros, ikd[..., 1], zeros, zeros, zeros, ikd[..., 2]]
    C = [Cd[..., 0], zeros, zeros, Cd[..., 1], zeros, Cd[..., 2]]
    J = [Jd[..., 0], zeros, zeros, Jd[..., 1], zeros, Jd[..., 2]]
    return torch.stack(A + list(b.unbind(-1)) + C + list(eta.unbind(-1)) + J)


def prior_element(m0: torch.Tensor, P0_diag: torch.Tensor) -> torch.Tensor:
    """The (27,) prior element (A=0, b=m₀, C=diag(P₀), η=0, J=0); (27, B)
    for B rows' means m0 (B, 3)."""
    prior = torch.zeros((27, *m0.shape[:-1]), dtype=m0.dtype, device=m0.device)
    prior[9:12] = torch.movedim(m0, -1, 0)
    prior[12], prior[15], prior[17] = P0_diag[0], P0_diag[1], P0_diag[2]
    return prior


def filter_elements(
    m0: torch.Tensor,  # (3,)
    P0: torch.Tensor,  # (3,3)
    d: torch.Tensor,  # (N-1,3) world-frame motion deltas
    Qd_diag: torch.Tensor,  # (N-1,3) per-step process noise diagonal
    R_diag: torch.Tensor,  # (3,) measurement noise diagonal
    z: torch.Tensor,  # (N-1,3) measurements (arbitrary where invalid)
    avail: torch.Tensor,  # (N-1,) bool
) -> torch.Tensor:
    """The (27, N) filtering elements with the prior (A=0, b=m₀, C=P₀)
    first; (27, B, N) under a leading batch axis."""
    prior = prior_element(m0.to(d.dtype), torch.diagonal(P0).to(d.dtype))
    steps = filter_step_elements(avail, d, Qd_diag, z, R_diag)
    return torch.cat([prior[..., None], steps], dim=-1)


def parallel_position_filter(m0, P0, d, Qd_diag, R_diag, z, avail, scan_fn: Optional[ScanFn] = None):
    """Filtered means (N,3) and covariances of the affine KF, covariances
    as the symmetric (6, N) leaves (xx, xy, xz, yy, yz, zz). ``scan_fn``
    (None: ``associative_scan``) runs the filter scan."""
    scan_fn = scan_fn or associative_scan
    out = scan_fn("filter", filter_elements(m0, P0, d, Qd_diag, R_diag, z, avail))
    return torch.movedim(out[9:12], 0, -1).contiguous(), out[12:18]


class PoseBlock(NamedTuple):
    """One contiguous block of the pose axis on its device, for
    :func:`fuse_ekf_rts_blocks`: its poses, the global index of its first,
    and its halos, each with a pose axis of length 1: the pose before it
    (None for the first block) and the pose after it (None for the last)."""

    times: torch.Tensor  # (..., L)
    pos: torch.Tensor  # (..., L, 3) SLAM positions
    quat: torch.Tensor  # (..., L, 4) SLAM quaternions
    gps: torch.Tensor  # (..., L, 3) aligned GNSS, NaN where missing
    valid: torch.Tensor  # (..., L) bool
    start: int = 0
    prev: Optional[Tuple[torch.Tensor, ...]] = None  # times, pos, quat, gps, valid
    next: Optional[Tuple[torch.Tensor, ...]] = None  # times, pos, quat


def _diag3(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The first three entries of a config diagonal on ``device``; the
    host-to-device copy does not wait for the device."""
    return torch.tensor(values[:3], dtype=dtype).to(device, non_blocking=True)


def _rts_elements(m_f, P_f6, d, Qd_diag, interior) -> torch.Tensor:
    """The (12, ..., K) RTS elements (E[9], c[3]) of K poses that each have a
    step out: m_f (..., K, 3), P_f6 (6, ..., K), the step's motion d and
    process noise Qd_diag (..., K, 3), interior (..., K): m_p[k+1] = m_f[k]
    + d_k, P_p[k+1] = P_f[k] + Qd_k; the quaternion block is a no-op."""
    m_p_next = m_f + d
    zero = torch.zeros_like(Qd_diag[..., 0])
    Qd_m = [Qd_diag[..., 0], zero, zero, zero, Qd_diag[..., 1], zero, zero, zero, Qd_diag[..., 2]]
    Pf_m = sym_expand(P_f6.unbind(0))
    E = _mmul(Pf_m, _minv([p + q for p, q in zip(Pf_m, Qd_m)]))
    E = [torch.where(interior, e, zero) for e in E]
    mf = list(m_f.unbind(-1))
    c_full = [x - y for x, y in zip(mf, _mvec(E, list(m_p_next.unbind(-1))))]
    c = [torch.where(interior, cf, x) for cf, x in zip(c_full, mf)]
    return torch.stack(E + c)


def fuse_ekf_rts_blocks(
    blocks: Sequence[PoseBlock],
    m0: torch.Tensor,
    q0: torch.Tensor,
    n: int,
    ekf_cfg: EKFConfig = EKFConfig(),
    rts_cfg: RTSDecisionConfig = RTSDecisionConfig(),
    rts_mode: str = "outage",
    block_scan: BlockScanFn = one_block_scan,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`fuse_ekf_rts_parallel` of a trajectory of ``n`` poses split
    into contiguous blocks, every stage run per block on the block's device:
    the controls (``kalman.controls_over_blocks``), the relative poses, the
    filter and RTS elements; the three scans and the controls' two go
    through ``block_scan`` (``kalman.BlockScanFn``; the default takes one
    block, ``associative_scan``).

    m₀ and q₀ (the Sim(3) first pose, (..., 3) and (..., 4), on the first
    block's device) make block 0's prior and start its quaternion chain;
    the RTS anchor at n−1 ends the last block. A block reaches its
    neighbours through its halos: the pose before it (the step into its
    first pose, and q_f there, copied from the previous block after the
    quaternion scan) and the pose after it (the step out of its last pose,
    for that pose's RTS gain). Returns the per-block (pos (..., L, 3),
    quat (..., L, 4)), each on its block's device."""
    if rts_cfg.default_ekf_transition_steps_on_sharp_turn != 0:
        raise ValueError(
            "parallel scan requires hard updates (transition steps == 0); "
            "use kalman.fuse_ekf_rts for blending configs"
        )
    first, last = 0, len(blocks) - 1
    dtype = blocks[0].pos.dtype
    controls = controls_over_blocks(
        [ControlsBlock(b.times, b.quat, b.gps, b.valid, b.start,
                       None if b.prev is None else (b.prev[0], b.prev[2], b.prev[3], b.prev[4])) for b in blocks],
        rts_cfg, block_scan,
    )
    if rts_mode == "full":
        controls = [full_smoother_controls(c, b.start, n) for c, b in zip(controls, blocks)]
    devices = [b.pos.device for b in blocks]
    q_diag = [_diag3(ekf_cfg.process_noise_diag, dtype, dev) for dev in devices]
    r_diag = [_diag3(ekf_cfg.meas_noise_diag, dtype, dev) for dev in devices]

    # Steps into each pose of a block: from the pose before it (block 0 has
    # none into its first pose).
    ext = [(b.times, b.pos, b.quat) if b.prev is None else
           (torch.cat([b.prev[0], b.times], -1), torch.cat([b.prev[1], b.pos], -2),
            torch.cat([b.prev[2], b.quat], -2)) for b in blocks]
    rel = [se3.relative_poses_along(p, q) for _, p, q in ext]
    qs = [dq if k != first else torch.cat([quat.normalize(q0)[..., None, :], dq], -2)
          for k, (_, dq) in enumerate(rel)]
    q_f = [torch.movedim(x, 0, -1).contiguous() for x in
           block_scan("quat_chain", [torch.movedim(x, -1, 0).contiguous() for x in qs], False)]
    q_from = [q[..., :-1, :] if k == first else torch.cat([q_f[k - 1][..., -1:, :].to(q.device), q[..., :-1, :]], -2)
              for k, q in enumerate(q_f)]
    d = [quat.rotate(qb, dp) for qb, (dp, _) in zip(q_from, rel)]
    Qd = [qd * torch.clamp(t[..., 1:] - t[..., :-1], min=1e-6)[..., None] for qd, (t, _, _) in zip(q_diag, ext)]
    elems = []
    for k, (b, c) in enumerate(zip(blocks, controls)):
        skip = 1 if k == first else 0  # block 0's first pose takes the prior
        z = torch.nan_to_num(b.gps[..., skip:, :], nan=0.0)
        e = filter_step_elements(c.avail[..., skip:], d[k], Qd[k], z, r_diag[k])
        if k == first:
            P0 = _diag3(ekf_cfg.initial_cov_diag, dtype, devices[k])
            e = torch.cat([prior_element(m0.to(dtype), P0)[..., None], e], dim=-1)
        elems.append(e)
    filt = block_scan("filter", elems, False)
    m_f = [torch.movedim(f[9:12], 0, -1).contiguous() for f in filt]
    P_f6 = [f[12:18] for f in filt]

    # RTS backward over the steps out of each pose: within the block, and
    # from its last pose into the next block's first (the last block ends
    # with the anchor element at n−1: M = 0, c = m_f[n−1]).
    rts = []
    for k, (b, c) in enumerate(zip(blocks, controls)):
        inner = b.times.shape[-1] - 1
        interior = c.rts_member & ~c.rts_end
        d_out, Qd_out = d[k][..., d[k].shape[-2] - inner:, :], Qd[k][..., Qd[k].shape[-2] - inner:, :]
        if k == last:
            m_last = torch.movedim(m_f[k][..., -1, :], -1, 0)
            tail = torch.cat([torch.zeros((9, *m_last.shape[1:]), dtype=dtype, device=devices[k]), m_last])
            e = _rts_elements(m_f[k][..., :-1, :], P_f6[k][..., :-1], d_out, Qd_out, interior[..., :-1])
            rts.append(torch.cat([e, tail[..., None]], dim=-1))
            continue
        nt, npos, nq = b.next
        dp_next, _ = se3.relative_pose(b.pos[..., -1:, :], b.quat[..., -1:, :], npos, nq)
        d_out = torch.cat([d_out, quat.rotate(q_f[k][..., -1:, :], dp_next)], -2)
        Qd_out = torch.cat([Qd_out, q_diag[k] * torch.clamp(nt - b.times[..., -1:], min=1e-6)[..., None]], -2)
        rts.append(_rts_elements(m_f[k], P_f6[k], d_out, Qd_out, interior))
    m_s = [torch.movedim(x[9:12], 0, -1).contiguous() for x in block_scan("rts", rts, True)]
    return [torch.where(c.rts_member[..., None], s, f) for c, s, f in zip(controls, m_s, m_f)], q_f


def fuse_ekf_rts_parallel(
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
    scan_fn: Optional[ScanFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth equivalent of ``kalman.fuse_ekf_rts`` for hard-update
    configs (rts_cfg.default_ekf_transition_steps_on_sharp_turn == 0): the
    one-block case of :func:`fuse_ekf_rts_blocks`.

    ``scan_fn`` replaces ``associative_scan`` in all three scans (quaternion
    chain, forward filter, RTS suffix): the chunked paths pass
    ``parallel.seqpar.sequence_parallel_scan``. Everything else here is
    elementwise."""
    scan_fn = scan_fn or associative_scan
    block = PoseBlock(slam_times, slam_pos, slam_quat, aligned_gps, valid_mask)
    (pos,), (q,) = fuse_ekf_rts_blocks(
        [block], sim3_pos[..., 0, :], sim3_quat[..., 0, :], slam_times.shape[-1], ekf_cfg, rts_cfg, rts_mode,
        lambda op, xs, reverse=False: [scan_fn(op, *xs, reverse)],
    )
    return pos, q
