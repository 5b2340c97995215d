"""Small fixed-size linear algebra (port of ``gps_optimize_slam_tpu.ops.linalg3``).

``svd3x3_soa`` is the JAX package's one-sided (Hestenes) Jacobi SVD of 3×3
matrices, ported operation for operation rather than replaced by
``torch.linalg.svd``, so that the signs and the order of the singular
vectors match the reference that the tests hold the port against. Twelve
sweeps of Rutishauser rotations (τ=(β−α)/(2γ), t = sign(τ)/(|τ|+√(1+τ²)),
c=1/√(1+t²), s=t·c), columns sorted by descending norm, near-zero columns
completed by cross products. Batched over any leading shape: each component
is a tensor, so the 1000 RANSAC trials are elementwise work.
"""

from __future__ import annotations

import torch

_JACOBI_SWEEPS = 12


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of 3×3 matrices, batched."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def _rotation(alpha, beta, gamma, eps, tiny):
    """Branch-free (c, s) that orthogonalises a column pair with
    ⟨a_p,a_p⟩=α, ⟨a_q,a_q⟩=β, ⟨a_p,a_q⟩=γ; identity when |γ| ~ 0."""
    small = torch.abs(gamma) <= eps * torch.sqrt(alpha * beta) + tiny
    gamma_safe = torch.where(small, torch.ones_like(gamma), gamma)
    tau = (beta - alpha) / (2.0 * gamma_safe)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)
    s = torch.where(small, torch.zeros_like(s), s)
    return c, s


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _sel(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def svd3x3_soa(cols):
    """SVD on structure-of-arrays 3×3 matrices.

    ``cols`` is the matrix as 3 columns, each a 3-tuple of same-shape
    tensors. Returns ``(u0, u1, u2, (s0, s1, s2), v0, v1, v2)``: U and V
    columns as 3-tuples, singular values descending, H = U·diag(S)·Vᵀ.
    """
    ref = cols[0][0]
    finfo = torch.finfo(ref.dtype)
    eps, tiny = finfo.eps, finfo.tiny
    one = torch.ones_like(ref)
    zero = torch.zeros_like(ref)

    def rot_apply(cp, cq, c, s):
        new_p = tuple(c * x - s * y for x, y in zip(cp, cq))
        new_q = tuple(s * x + c * y for x, y in zip(cp, cq))
        return new_p, new_q

    a0, a1, a2 = cols
    v0, v1, v2 = (one, zero, zero), (zero, one, zero), (zero, zero, one)
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            a = [a0, a1, a2]
            v = [v0, v1, v2]
            c, s = _rotation(_dot(a[p], a[p]), _dot(a[q], a[q]), _dot(a[p], a[q]), eps, tiny)
            a[p], a[q] = rot_apply(a[p], a[q], c, s)
            v[p], v[q] = rot_apply(v[p], v[q], c, s)
            a0, a1, a2 = a
            v0, v1, v2 = v

    s0 = torch.sqrt(_dot(a0, a0))
    s1 = torch.sqrt(_dot(a1, a1))
    s2 = torch.sqrt(_dot(a2, a2))

    def cswap(sa, sb, ca, cb, va, vb):
        swap = sb > sa
        return (
            torch.where(swap, sb, sa),
            torch.where(swap, sa, sb),
            _sel(swap, cb, ca),
            _sel(swap, ca, cb),
            _sel(swap, vb, va),
            _sel(swap, va, vb),
        )

    s0, s1, a0, a1, v0, v1 = cswap(s0, s1, a0, a1, v0, v1)
    s1, s2, a1, a2, v1, v2 = cswap(s1, s2, a1, a2, v1, v2)
    s0, s1, a0, a1, v0, v1 = cswap(s0, s1, a0, a1, v0, v1)

    tol = eps * 8.0
    good0 = s0 > (s0 * tol + tiny)
    good1 = s1 > (s0 * tol + tiny)
    good2 = s2 > (s0 * tol + tiny)

    u0 = tuple(x / torch.where(good0, s0, one) for x in a0)
    u0 = _sel(good0, u0, (one, zero, zero))

    def norm3(a):
        return torch.sqrt(_dot(a, a))

    u1_raw = tuple(x / torch.where(good1, s1, one) for x in a1)
    proj = _dot(u1_raw, u0)
    u1_raw = tuple(x - proj * y for x, y in zip(u1_raw, u0))
    n1 = norm3(u1_raw)
    alt = _cross(u0, (zero, one, zero))
    alt2 = _cross(u0, (zero, zero, one))
    alt = _sel(norm3(alt) > 0.1, alt, alt2)
    alt_nn = norm3(alt)
    alt = tuple(x / alt_nn for x in alt)
    ok1 = good1 & (n1 > tol)
    n1_safe = torch.where(ok1, n1, one)
    u1 = _sel(ok1, tuple(x / n1_safe for x in u1_raw), alt)

    u2 = _cross(u0, u1)
    n2 = norm3(u2)
    u2 = tuple(x / n2 for x in u2)
    # When σ₃ is significant, match the cross product's sign to H's action
    # (A's third column); when σ₃ ~ 0 the det correction absorbs it.
    sign2 = torch.where(good2 & (_dot(u2, a2) < 0), -one, one)
    u2 = tuple(x * sign2 for x in u2)
    return u0, u1, u2, (s0, s1, s2), v0, v1, v2


def svd3x3(H: torch.Tensor):
    """SVD of 3×3 matrices, H = U @ diag(S) @ Vt, batched over leading dims."""
    cols = tuple(tuple(H[..., r, c] for r in range(3)) for c in range(3))
    u0, u1, u2, (s0, s1, s2), v0, v1, v2 = svd3x3_soa(cols)
    U = torch.stack(
        [torch.stack(u0, -1), torch.stack(u1, -1), torch.stack(u2, -1)], dim=-1
    )
    S = torch.stack([s0, s1, s2], dim=-1)
    Vt = torch.stack(
        [torch.stack(v0, -1), torch.stack(v1, -1), torch.stack(v2, -1)], dim=-2
    )
    return U, S, Vt
