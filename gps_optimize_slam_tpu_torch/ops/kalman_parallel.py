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

All three scans go through K1 (``ops.scan.associative_scan``): the kernel on
CUDA, the plain ladder on CPU. Leaves are structure-of-arrays: a 3×3 matrix
is nine (N,) tensors, a symmetric one six. Under a leading batch axis (one
sequence a row) every leaf is (B, N) and each scan one launch over all
rows, the leaves (27, B, N), (12, B, N) and (4, B, N).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import quaternion as quat
from gps_optimize_slam_tpu_torch.ops import se3
from gps_optimize_slam_tpu_torch.ops.kalman import (
    ekf_params,
    full_smoother_controls,
    precompute_controls,
)
from gps_optimize_slam_tpu_torch.ops.scan import (
    _minv,
    _mmul,
    _mvec,
    associative_scan,
    sym_expand,
)


def parallel_quat_chain(init_quat: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """q_k = normalize(q₀ ⊗ δq₁ ⊗ … ⊗ δq_k) for all k, in log depth:
    init_quat (..., 4), dq (..., N-1, 4) → (..., N, 4)."""
    qs = torch.cat([quat.normalize(init_quat)[..., None, :], dq], -2)
    return torch.movedim(associative_scan("quat_chain", torch.movedim(qs, -1, 0).contiguous()), 0, -1).contiguous()


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


def parallel_position_filter(m0, P0, d, Qd_diag, R_diag, z, avail):
    """Filtered means (N,3) and covariances of the affine KF, covariances
    as the symmetric (6, N) leaves (xx, xy, xz, yy, yz, zz)."""
    out = associative_scan("filter", filter_elements(m0, P0, d, Qd_diag, R_diag, z, avail))
    return torch.movedim(out[9:12], 0, -1).contiguous(), out[12:18]


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth equivalent of ``kalman.fuse_ekf_rts`` for hard-update
    configs (rts_cfg.default_ekf_transition_steps_on_sharp_turn == 0)."""
    if rts_cfg.default_ekf_transition_steps_on_sharp_turn != 0:
        raise ValueError(
            "parallel scan requires hard updates (transition steps == 0); "
            "use kalman.fuse_ekf_rts for blending configs"
        )
    dtype, device = slam_pos.dtype, slam_pos.device
    controls = precompute_controls(slam_times, slam_quat, aligned_gps, valid_mask, rts_cfg)
    if rts_mode == "full":
        controls = full_smoother_controls(controls)
    params = ekf_params(ekf_cfg, dtype=dtype, device=device)

    dp, dq = se3.relative_poses_along(slam_pos, slam_quat)
    q_f = parallel_quat_chain(sim3_quat[..., 0, :], dq)
    d = quat.rotate(q_f[..., :-1, :], dp)
    dt = torch.clamp(slam_times[..., 1:] - slam_times[..., :-1], min=1e-6)
    Qd_diag = torch.diag(params.Q_per_sec)[:3] * dt[..., None]
    z = torch.nan_to_num(aligned_gps[..., 1:, :], nan=0.0)
    m_f, P_f6 = parallel_position_filter(
        sim3_pos[..., 0, :], params.P0[:3, :3], d, Qd_diag, torch.diag(params.R),
        z, controls.avail[..., 1:],
    )

    # RTS backward: m_p[k+1] = m_f[k] + d_k, P_p[k+1] = P_f[k] + Qd_k; the
    # quaternion block is a no-op (q_s ≡ q_f).
    member, end = controls.rts_member, controls.rts_end
    interior = member[..., :-1] & ~end[..., :-1]
    m_p_next = m_f[..., :-1, :] + d
    zero = torch.zeros_like(dt)
    Qd_m = [Qd_diag[..., 0], zero, zero, zero, Qd_diag[..., 1], zero, zero, zero, Qd_diag[..., 2]]
    Pf_m = [c[..., :-1] for c in sym_expand(P_f6.unbind(0))]
    E = _mmul(Pf_m, _minv([p + q for p, q in zip(Pf_m, Qd_m)]))
    E = [torch.where(interior, e, zero) for e in E]
    mf = list(m_f[..., :-1, :].unbind(-1))
    c_full = [x - y for x, y in zip(mf, _mvec(E, list(m_p_next.unbind(-1))))]
    c = [torch.where(interior, cf, x) for cf, x in zip(c_full, mf)]
    # Anchor element at N-1: (M = 0, c = m_f[N-1]).
    m_last = torch.movedim(m_f[..., -1, :], -1, 0)
    tail = torch.cat([torch.zeros((9, *m_last.shape[1:]), dtype=dtype, device=device), m_last])
    elems = torch.cat([torch.stack(E + c), tail[..., None]], dim=-1)
    m_s = torch.movedim(associative_scan("rts", elems, reverse=True)[9:12], 0, -1).contiguous()
    return torch.where(member[..., None], m_s, m_f), q_f
