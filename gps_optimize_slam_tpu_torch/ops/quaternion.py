"""Quaternion algebra on tensors (port of ``gps_optimize_slam_tpu.ops.quaternion``).

Convention: quaternions are stored ``[qx, qy, qz, qw]`` (scalar-last), as
scipy's Rotation, which the reference uses (EKFGPSSLAM.py:4). Rotations act
on column vectors: ``rotate(q, v) = R(q) v``. All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS_NORM = 1e-9


def identity_like(q: torch.Tensor) -> torch.Tensor:
    """Identity quaternion broadcast to q's shape (built on q's device: an
    assignment of a Python number to one element would copy it from the
    host and wait)."""
    return torch.cat([torch.zeros_like(q[..., :3]), torch.ones_like(q[..., 3:])], -1)


def norm(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(q * q, dim=-1))


def normalize(q: torch.Tensor, eps: float = _EPS_NORM) -> torch.Tensor:
    """``q/|q|`` if ``|q| > eps`` else the identity (reference
    normalize_quaternion, EKFGPSSLAM.py:697-700)."""
    n = norm(q)[..., None]
    safe = torch.where(n > eps, n, torch.ones_like(n))
    return torch.where(n > eps, q / safe, identity_like(q))


def mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 in xyzw layout: R(q1 q2) = R(q1) R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions). Built on the device, with
    no host-to-device copy that would wait on it."""
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a (possibly non-unit) quaternion: conj(q) / |q|²."""
    return conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q:
    v' = v + 2 w (u × v) + 2 u × (u × v), u = q.xyz."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → 3×3 rotation matrix (batched): (..., 4) → (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3×3 rotation matrix → unit quaternion xyzw (batched, branchless,
    Shepperd-style; non-negative w like scipy's from_matrix)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1)
    qx = torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    qy = torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], dim=-1)
    qz = torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], dim=-1)
    d = torch.stack(
        [
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
            1.0 + tr,
        ],
        dim=-1,
    )
    choice = torch.argmax(d, dim=-1)
    cands = torch.stack([qx, qy, qz, qw], dim=-2)  # (..., 4 candidates, 4)
    idx = choice[..., None, None].expand(*choice.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / norm(q)[..., None]
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)
    return q * sign


def nlerp(q1: torch.Tensor, q2: torch.Tensor, weight_q2) -> torch.Tensor:
    """Normalised linear interpolation with hemisphere flip (reference
    quaternion_nlerp, EKFGPSSLAM.py:94-105)."""
    weight_q2 = torch.as_tensor(weight_q2, dtype=q1.dtype, device=q1.device)
    w = torch.clamp(weight_q2, 0.0, 1.0)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2f = torch.where(dot < 0.0, -q2, q2)
    q = (1.0 - w) * q1 + w * q2f
    n = norm(q)[..., None]
    fallback = torch.where(weight_q2 < 0.5, q1, q2)
    safe = torch.where(n < _EPS_NORM, torch.ones_like(n), n)
    return torch.where(n < _EPS_NORM, fallback, q / safe)


def yaw(q: torch.Tensor) -> torch.Tensor:
    """First angle of scipy's ``as_euler('zyx')`` (extrinsic): the yaw of
    the reference's sharp-turn detector (EKFGPSSLAM.py:819-820)."""
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2.0 * (w * z - x * y), 1.0 - 2.0 * (y * y + z * z))


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi] via atan2 (reference EKFGPSSLAM.py:822)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def exp_map(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: rotation vector (axis·angle, rad) → unit quaternion.

    Taylor-guarded near zero including its derivatives (the double where:
    the square root never sees 0, so jvp and vjp at ω = 0 stay finite; the
    pose graph's retraction differentiates through this at exactly ω = 0)."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    # sin(θ/2)/θ with series 1/2 − θ²/48; cos(θ/2) with series 1 − θ²/8.
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(theta / 2.0) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(theta / 2.0))
    return torch.cat([omega * k, w], dim=-1)


def log_map(q: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: unit quaternion → rotation vector (rad).

    Hemisphere-canonicalised (w ≥ 0), so the result is the minimal rotation;
    guarded near the identity like ``exp_map``. The clip of w is a max then
    a min, as the JAX package's ``jnp.clip``: its derivative at w = ±1 is
    0.5 (ties split), where ``torch.clamp``'s is 1. Near the identity w is
    exactly 1.0 in float64 whenever |v| < ~1e-8, so every converged
    odometry residual of the pose graph sees that derivative."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    one = torch.ones((), dtype=q.dtype, device=q.device)
    w = torch.minimum(torch.maximum(q[..., 3:4], -one), one)
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-18
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(vn, w)
    # Near the identity w ≈ 1: log(q) ≈ 2v/w (relative error O(|v|²)).
    w_safe = torch.where(w > 0.5, w, torch.ones_like(w))
    scale = torch.where(small, 2.0 / w_safe, theta / vn)
    return v * scale
