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
    FusionControls,
    StageFn,
    call_stage,
    controls_over_blocks,
    device_vector,
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
    """The first three entries of a config diagonal, made on ``device``
    (``kalman.device_vector``)."""
    return device_vector(values[:3], dtype, device)


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
    run: StageFn = call_stage,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`fuse_ekf_rts_parallel` of a trajectory of ``n`` poses split
    into contiguous blocks, every stage run per block on the block's device:
    the controls (``kalman.controls_over_blocks``), the relative poses, the
    filter and RTS elements; the three scans and the controls' two go
    through ``block_scan`` (``kalman.BlockScanFn``; the default takes one
    block, ``associative_scan``), and the work of a block between two scans
    is one stage through ``run`` (``kalman.StageFn``).

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
    controls = controls_over_blocks(
        [ControlsBlock(b.times, b.quat, b.gps, b.valid, b.start,
                       None if b.prev is None else (b.prev[0], b.prev[2], b.prev[3], b.prev[4])) for b in blocks],
        rts_cfg, block_scan, run,
    )
    chains = [run(_chain_stage, b, c, q0 if k == 0 else None, rts_mode == "full", n)
              for k, (b, c) in enumerate(zip(blocks, controls))]
    q_scan = block_scan("quat_chain", [qs for _, _, qs in chains], False)
    # q_f at the pose before each block: the previous block's last.
    halos = [None] + [torch.movedim(q[..., -1:], 0, -1).to(b.pos.device) for q, b in zip(q_scan, blocks[1:])]
    filters = [run(_filter_stage, b, c, dp, q, halo, m0 if k == 0 else None, ekf_cfg)
               for k, (b, (c, dp, _), q, halo) in enumerate(zip(blocks, chains, q_scan, halos))]
    filt = block_scan("filter", [f.elements for f in filters], False)
    rts = [run(_rts_stage, b, c, f, e, ekf_cfg) for b, (c, _, _), f, e in zip(blocks, chains, filt, filters)]
    smoothed = block_scan("rts", [e for _, e in rts], True)
    pos = [run(_smoothed_stage, c, s, m_f) for (c, _, _), s, (m_f, _) in zip(chains, smoothed, rts)]
    return pos, [f.q_f for f in filters]


def _ext(b: PoseBlock):
    """The block's times, positions and quaternions, after the pose before
    it (block 0 has none)."""
    if b.prev is None:
        return b.times, b.pos, b.quat
    return (torch.cat([b.prev[0], b.times], -1), torch.cat([b.prev[1], b.pos], -2),
            torch.cat([b.prev[2], b.quat], -2))


def _chain_stage(b: PoseBlock, c: FusionControls, q0: Optional[torch.Tensor], full: bool, n: int):
    """The block's controls (one RTS segment over all under ``full``), the
    steps into its poses (relative positions) and the quaternion chain's
    (4, ..., L) leaves: the steps' rotations, after q₀ on block 0."""
    if full:
        c = full_smoother_controls(c, b.start, n)
    _, p, q = _ext(b)
    dp, dq = se3.relative_poses_along(p, q)
    qs = dq if q0 is None else torch.cat([quat.normalize(q0)[..., None, :], dq], -2)
    return c, dp, torch.movedim(qs, -1, 0).contiguous()


class _FilterStage(NamedTuple):
    q_f: torch.Tensor  # (..., L, 4) fused quaternions
    d: torch.Tensor  # (..., L', 3) world-frame motion of the steps into the poses
    Qd: torch.Tensor  # (..., L', 3) their process noise
    elements: torch.Tensor  # (27, ..., L) filter elements (block 0: the prior first)


def _filter_stage(b: PoseBlock, c: FusionControls, dp, q_scan, halo, m0, ekf_cfg: EKFConfig) -> _FilterStage:
    """The block's fused quaternions from its scanned chain, the world-frame
    steps into its poses (rotated by q_f at the pose each leaves: ``halo``,
    the previous block's last, for the first) and its filter elements."""
    dtype, device = b.pos.dtype, b.pos.device
    q_f = torch.movedim(q_scan, 0, -1).contiguous()
    q_from = q_f[..., :-1, :] if halo is None else torch.cat([halo, q_f[..., :-1, :]], -2)
    d = quat.rotate(q_from, dp)
    t = _ext(b)[0]
    Qd = _diag3(ekf_cfg.process_noise_diag, dtype, device) * torch.clamp(t[..., 1:] - t[..., :-1], min=1e-6)[..., None]
    skip = 1 if m0 is not None else 0  # block 0's first pose takes the prior
    z = torch.nan_to_num(b.gps[..., skip:, :], nan=0.0)
    e = filter_step_elements(c.avail[..., skip:], d, Qd, z, _diag3(ekf_cfg.meas_noise_diag, dtype, device))
    if m0 is not None:
        P0 = _diag3(ekf_cfg.initial_cov_diag, dtype, device)
        e = torch.cat([prior_element(m0.to(dtype), P0)[..., None], e], dim=-1)
    return _FilterStage(q_f, d, Qd, e)


def _rts_stage(b: PoseBlock, c: FusionControls, filt, f: _FilterStage, ekf_cfg: EKFConfig):
    """The block's filtered means and its RTS elements over the steps out of
    each pose: within the block, and from its last pose into the next
    block's first (the last block ends with the anchor element at n−1:
    M = 0, c = m_f[n−1])."""
    dtype, device = b.pos.dtype, b.pos.device
    m_f = torch.movedim(filt[9:12], 0, -1).contiguous()
    P_f6 = filt[12:18]
    inner = b.times.shape[-1] - 1
    interior = c.rts_member & ~c.rts_end
    d_out, Qd_out = f.d[..., f.d.shape[-2] - inner:, :], f.Qd[..., f.Qd.shape[-2] - inner:, :]
    if b.next is None:
        m_last = torch.movedim(m_f[..., -1, :], -1, 0)
        tail = torch.cat([torch.zeros((9, *m_last.shape[1:]), dtype=dtype, device=device), m_last])
        e = _rts_elements(m_f[..., :-1, :], P_f6[..., :-1], d_out, Qd_out, interior[..., :-1])
        return m_f, torch.cat([e, tail[..., None]], dim=-1)
    nt, npos, nq = b.next
    dp_next, _ = se3.relative_pose(b.pos[..., -1:, :], b.quat[..., -1:, :], npos, nq)
    d_out = torch.cat([d_out, quat.rotate(f.q_f[..., -1:, :], dp_next)], -2)
    q_diag = _diag3(ekf_cfg.process_noise_diag, dtype, device)
    Qd_out = torch.cat([Qd_out, q_diag * torch.clamp(nt - b.times[..., -1:], min=1e-6)[..., None]], -2)
    return m_f, _rts_elements(m_f, P_f6, d_out, Qd_out, interior)


def _smoothed_stage(c: FusionControls, smoothed, m_f):
    """The fused positions: smoothed where RTS runs, filtered elsewhere."""
    return torch.where(c.rts_member[..., None], torch.movedim(smoothed[9:12], 0, -1).contiguous(), m_f)


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
