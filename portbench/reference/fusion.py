"""Plain reference of the fusion a request runs: GNSS time alignment, the
Sim(3) window and fit, the trajectory transform, the EKF with its RTS
smoothing over GNSS outages. NumPy, SciPy
and plain PyTorch on the CPU; it imports nothing of the program under test.

It follows the semantics of the system's reference recipe (the original
``EKFGPSSLAM.py`` flow, as the configuration's file states them), computed
another way than the program computes them:

* alignment: the valid fixes sorted by time, duplicates dropped, split at
  gaps longer than ``max_gps_gap_threshold``; a not-a-knot cubic spline
  through each run of four fixes or more (its moments from one banded
  solve), a straight line through runs of two or three; a SLAM time is
  valid inside a run's span;
* the Sim(3) window: the first gap-free run of valid poses (the gap's left
  pose left out), cut to ``max_initial_duration`` seconds, with the
  recipe's fallbacks;
* the fit: Umeyama's closed form (a 3×3 SVD) over the window, the inliers
  those within ``residual_threshold`` of it, and the fit again over them.
  RANSAC's draws pick the consensus set; where every window pose lies well
  inside the threshold, as on this benchmark's streams, any draw that fits
  four good poses gives that set, so the consensus is the draws' fixed
  point and needs no draws;
* the EKF: the state's covariance starts diagonal and the motion model
  adds diagonal noise without a Jacobian, so it stays diagonal: each
  position axis is a scalar Kalman filter, and the orientation is the
  chain of SLAM relative rotations from the first Sim(3) orientation,
  which no GNSS update moves. The variances are one Möbius recurrence a
  axis and the positions one affine recurrence, both taken as prefix
  products by doubling;
* RTS, over each outage from its first pose to the recovery, unless the
  outage turns faster than the yaw-rate threshold: each outage pose moves
  by the product of the smoother gains down to the recovery times the
  recovery's correction (the orientations do not move).

``dtype`` is the precision every step computes in (float64, or float32
for the control).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.linalg import solve_banded


class Fused(NamedTuple):
    aligned: np.ndarray  # (N, 3), NaN where not valid
    valid: np.ndarray  # (N,) bool
    window: np.ndarray  # (N,) bool
    inliers: np.ndarray  # (N,) bool
    scale: float
    R: np.ndarray  # (3, 3)
    t: np.ndarray  # (3,)
    sim3_pos: np.ndarray  # (N, 3)
    sim3_quat: np.ndarray  # (N, 4)
    pos: np.ndarray  # (N, 3) EKF + RTS
    quat: np.ndarray  # (N, 4)


# ---------------------------------------------------------------------------
# Time alignment
# ---------------------------------------------------------------------------


def _notaknot_moments(t: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives at the knots of the not-a-knot cubic spline
    through (t, y), y (n, 3), n >= 4: one banded solve in t's dtype. Row 0
    and row n-1 ask the third derivative to be continuous at the second and
    the last but one knot; the rows between are the spline's continuity of
    slope. ``ab[2 + i - j, j]`` holds the matrix's entry (i, j)."""
    n = len(t)
    h = np.diff(t)
    slope = np.diff(y, axis=0) / h[:, None]
    ab = np.zeros((5, n), dtype=t.dtype)
    rhs = np.zeros((n, 3), dtype=t.dtype)
    ab[2, 0], ab[1, 1], ab[0, 2] = h[1], -(h[0] + h[1]), h[0]
    i = np.arange(1, n - 1)
    ab[3, i - 1] = h[i - 1]
    ab[2, i] = 2 * (h[i - 1] + h[i])
    ab[1, i + 1] = h[i]
    rhs[1:-1] = 6 * (slope[1:] - slope[:-1])
    ab[4, n - 3], ab[3, n - 2], ab[2, n - 1] = h[n - 2], -(h[n - 3] + h[n - 2]), h[n - 3]
    return solve_banded((2, 2), ab, rhs)


def align(slam_t, gps_t, gps_p, gps_valid, gap_s: float, dtype=np.float64):
    """GNSS positions on the SLAM timestamps: ``(aligned (N, 3) with NaN
    where not valid, valid (N,))``."""
    slam_t = np.asarray(slam_t, dtype)
    keep = np.asarray(gps_valid, bool)
    t = np.asarray(gps_t, dtype)[keep]
    p = np.asarray(gps_p, dtype)[keep]
    order = np.argsort(t, kind="stable")
    t, p = t[order], p[order]
    fresh = np.concatenate([[True], t[1:] != t[:-1]]) if len(t) else np.zeros(0, bool)
    t, p = t[fresh], p[fresh]
    n_pose = len(slam_t)
    aligned = np.full((n_pose, 3), np.nan, dtype)
    valid = np.zeros(n_pose, bool)
    if len(t) == 0:
        return aligned, valid
    breaks = np.flatnonzero(np.diff(t) > gap_s) + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [len(t)]]) - 1
    for s, e in zip(starts, ends):
        ts, ps = t[s : e + 1], p[s : e + 1]
        if len(ts) < 2 or not np.all(np.diff(ts) > 1e-9):
            continue
        inside = (slam_t >= ts[0]) & (slam_t <= ts[-1])
        q = slam_t[inside]
        j = np.clip(np.searchsorted(ts, q, side="right") - 1, 0, len(ts) - 2)
        t0, t1 = ts[j], ts[j + 1]
        y0, y1 = ps[j], ps[j + 1]
        h = (t1 - t0)[:, None]
        u = (q - t0)[:, None]
        v = (t1 - q)[:, None]
        if len(ts) >= 4:
            m = _notaknot_moments(ts, ps)
            m0, m1 = m[j], m[j + 1]
            val = (m0 * v**3 / (6 * h) + m1 * u**3 / (6 * h) + (y0 / h - m0 * h / 6) * v
                   + (y1 / h - m1 * h / 6) * u)
        else:
            val = y0 + (y1 - y0) * (u / h)
        aligned[inside] = val
        valid[inside] = True
    return aligned, valid


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def sim3_window(slam_t, valid, gap_s: float, max_duration: float, min_samples: int) -> np.ndarray:
    """The poses of the Sim(3) fit: the first gap-free run of valid poses
    (the gap's left pose left out), cut to ``max_duration`` seconds; all
    valid poses where that run has fewer than ``min_samples``, the whole run
    where the cut one has."""
    idx = np.flatnonzero(valid)
    tv = np.asarray(slam_t)[idx]
    gaps = np.flatnonzero(np.diff(tv) > gap_s)
    run_len = gaps[0] if len(gaps) else len(idx)  # the gap pair's left pose is left out
    run = np.zeros(len(valid), bool)
    run[idx[:run_len]] = True
    timed = run & (np.asarray(slam_t) <= (tv[0] if len(tv) else 0) + max_duration)
    if run.sum() < min_samples:
        return np.asarray(valid, bool).copy()
    if timed.sum() < min_samples:
        return run
    return timed


def umeyama(src, dst, mask, dtype):
    """(scale, R, t): dst ≈ scale · R src + t over the masked rows, in
    ``dtype`` (Umeyama 1991, with the reflection fixed)."""
    s = torch.as_tensor(np.asarray(src)[mask], dtype=dtype)
    d = torch.as_tensor(np.asarray(dst)[mask], dtype=dtype)
    mu_s, mu_d = s.mean(0), d.mean(0)
    sc, dc = s - mu_s, d - mu_d
    cov = dc.T @ sc / len(s)
    U, S, Vh = torch.linalg.svd(cov)
    D = torch.ones(3, dtype=dtype)
    if torch.det(U) * torch.det(Vh) < 0:
        D[2] = -1
    R = U @ torch.diag(D) @ Vh
    var = (sc * sc).sum(1).mean()
    scale = (S * D).sum() / var
    t = mu_d - scale * (R @ mu_s)
    return float(scale), R.numpy(), t.numpy()


def residuals(src, dst, scale, R, t):
    return np.linalg.norm(scale * np.asarray(src) @ R.T + t - np.asarray(dst), axis=1)


# ---------------------------------------------------------------------------
# Quaternions (xyzw, Hamilton)
# ---------------------------------------------------------------------------


def qmul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qnormalize(q):
    return q / q.norm(dim=-1, keepdim=True)


def qmatrix(q):
    x, y, z, w = qnormalize(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)], -2)


def matrix_quat(R: torch.Tensor) -> torch.Tensor:
    """A rotation matrix's unit quaternion with w >= 0 (Shepperd's method)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    cands = torch.stack([tr, R[0, 0], R[1, 1], R[2, 2]])
    k = int(torch.argmax(cands))
    if k == 0:
        s = torch.sqrt(1 + tr) * 2
        q = torch.stack([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s, s / 4])
    else:
        i, j, m = (k - 1), k % 3, (k + 1) % 3
        s = torch.sqrt(1 + R[i, i] - R[j, j] - R[m, m]) * 2
        q = torch.zeros(4, dtype=R.dtype)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[m] = (R[m, i] + R[i, m]) / s
        q[3] = (R[m, j] - R[j, m]) / s
    return q if q[3] >= 0 else -q


# ---------------------------------------------------------------------------
# Prefix products by doubling
# ---------------------------------------------------------------------------


def affine_prefix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_i = a_i x_{i-1} + b_i along axis 0, with a_0 = 0 (so x_0 = b_0):
    every x_i, composing the maps by doubling."""
    a, b = a.clone(), b.clone()
    off = 1
    while off < len(a):
        b[off:] = a[off:] * b[:-off] + b[off:]
        a[off:] = a[off:] * a[:-off]
        off *= 2
    return b


def mobius_prefix(m: torch.Tensor) -> torch.Tensor:
    """Prefix products M_i ⋯ M_0 of 2×2 matrices (N, ..., 2, 2) along
    axis 0 by doubling, each product scaled by its largest entry."""
    m = m.clone()
    off = 1
    while off < len(m):
        p = m[off:] @ m[:-off]
        m[off:] = p / p.abs().amax((-1, -2), keepdim=True)
        off *= 2
    return m


# ---------------------------------------------------------------------------
# EKF + RTS
# ---------------------------------------------------------------------------


def yaw(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def ekf_rts(slam_t, slam_pos, slam_quat, sim3_pos, sim3_quat, aligned, valid, ekf: dict, rts: dict, dtype):
    """Positions (N, 3) and orientations (N, 4) of the EKF with RTS over
    outages, in ``dtype``."""
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    t, p, sq = T(slam_t), T(slam_pos), qnormalize(T(slam_quat))
    avail = np.asarray(valid, bool) & np.isfinite(np.asarray(aligned)).all(1)
    n = len(t)
    q0 = qnormalize(T(sim3_quat[0]))
    lead = qmul(q0, qconj(sq[0]))
    quat = qnormalize(qmul(lead.expand(n, 4), sq))
    d = torch.zeros((n, 3), dtype=dtype)
    d[1:] = (p[1:] - p[:-1]) @ qmatrix(lead).T
    dt = torch.zeros(n, dtype=dtype)
    dt[1:] = torch.clamp(t[1:] - t[:-1], min=1e-6)
    q_noise, r_noise = T(ekf["process_noise_diag"][:3]), T(ekf["meas_noise_diag"])
    c = dt[:, None] * q_noise  # (N, 3) added variance a step
    av = torch.as_tensor(avail)[:, None].expand(n, 3)
    # Variances: P_i = U_i(P_{i-1} + c_i), U the update's Möbius map where
    # a fix is available; pose 0 is the constant map to P_0.
    m = torch.zeros((n, 3, 2, 2), dtype=dtype)
    r = r_noise.expand(n, 3)
    m[..., 0, 0] = torch.where(av, r, 1.0)
    m[..., 0, 1] = torch.where(av, r * c, c)
    m[..., 1, 0] = torch.where(av, 1.0, 0.0)
    m[..., 1, 1] = torch.where(av, c + r, 1.0)
    m[0] = 0
    m[0, :, 0, 1] = T(ekf["initial_cov_diag"][:3])
    m[0, :, 1, 1] = 1
    pm = mobius_prefix(m)
    P = pm[..., 0, 1] / pm[..., 1, 1]
    P_pred = torch.zeros_like(P)
    P_pred[1:] = P[:-1] + c[1:]
    K = torch.where(av, P_pred / (P_pred + r), 0.0)
    K[0] = 0
    z = torch.where(av, torch.nan_to_num(T(aligned)), 0.0)
    a = 1 - K
    b = a * d + K * z
    a[0] = 0
    b[0] = T(sim3_pos[0])
    x = affine_prefix(a, b)
    x_pred = torch.zeros_like(x)
    x_pred[1:] = x[:-1] + d[1:]

    # RTS over each outage [s, r): from its first pose to the recovery r.
    out = x.clone()
    thr = np.deg2rad(rts["sharp_turn_yaw_rate_threshold_deg_per_sec"])
    heading = yaw(np.asarray(slam_quat, np.float64))
    tt = np.asarray(slam_t, np.float64)
    starts = np.flatnonzero(~avail & np.concatenate([[True], avail[:-1]]))
    for s in starts:
        after = np.flatnonzero(avail[s + 1 :])
        if not len(after):
            continue  # a trailing outage is never smoothed
        r_ = s + 1 + int(after[0])
        if r_ - s >= 2:
            k = np.arange(s + 1, r_)
            dtk = tt[k] - tt[k - 1]
            fwd = dtk > 0
            dy = np.arctan2(np.sin(heading[k] - heading[k - 1]), np.cos(heading[k] - heading[k - 1]))
            if fwd.any() and np.max(np.abs(dy[fwd]) / dtk[fwd]) > thr:
                continue
        A = P[s:r_] / P_pred[s + 1 : r_ + 1]  # gains of poses s..r-1
        G = torch.flip(torch.cumprod(torch.flip(A, (0,)), 0), (0,))
        out[s:r_] = x[s:r_] + G * (x[r_] - x_pred[r_])
    return out.numpy(), quat.numpy()


# ---------------------------------------------------------------------------
# One drive
# ---------------------------------------------------------------------------


def fuse(slam: dict, gps_t, gps_p, cfg: dict, dtype=torch.float64) -> Fused:
    """The fusion of one drive (unpadded), every step in ``dtype``."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    ta, sr = cfg["time_alignment"], cfg["sim3_ransac"]
    st = np.asarray(slam["timestamps"], np_dt)
    sp = np.asarray(slam["positions"], np_dt)
    sq = np.asarray(slam["quaternions"], np_dt)
    aligned, valid = align(st, gps_t, gps_p, np.ones(len(gps_t), bool), ta["max_gps_gap_threshold"], np_dt)
    window = sim3_window(st, valid, ta["max_gps_gap_threshold"], sr["max_initial_duration"], sr["min_samples"])
    dst = np.nan_to_num(aligned)
    scale, R, t = umeyama(sp, dst, window, dtype)
    inliers = window & (residuals(sp, dst, scale, R, t) < sr["residual_threshold"])
    scale, R, t = umeyama(sp, dst, inliers, dtype)
    Rt = torch.as_tensor(R)
    sim3_pos = (scale * (torch.as_tensor(sp) @ Rt.T) + torch.as_tensor(t)).numpy()
    sim3_quat = qmul(matrix_quat(Rt).expand(len(sq), 4), torch.as_tensor(sq)).numpy()
    pos, quat = ekf_rts(st, sp, sq, sim3_pos, sim3_quat, aligned, valid, cfg["ekf"], cfg["rts_decision"], dtype)
    return Fused(aligned, valid, window, inliers, scale, R, t, sim3_pos, sim3_quat, pos, quat)

