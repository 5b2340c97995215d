"""Closed-form Sim(3) estimation (Umeyama), weighted and batched (port of
``gps_optimize_slam_tpu.ops.umeyama``).

Centroid → covariance → 3×3 Jacobi SVD → reflection fix → scale →
translation, with a weight/mask vector so RANSAC refits on any inlier set
with static shapes, and batched over leading dimensions (the RANSAC trials).
Reference quirk Q2 (EKFGPSSLAM.py:428-459): the scale is trace(Σ)/(n·var_src);
guards: <3 effective points → invalid, var≈0 → scale 1, scale ≤1e-6 → 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gps_optimize_slam_tpu_torch.ops.linalg3 import svd3x3_soa


class Sim3(NamedTuple):
    """A similarity transform dst ≈ s·R·src + t, plus a validity flag."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    scale: torch.Tensor  # (...)
    ok: torch.Tensor  # (...) bool


def umeyama_sim3(
    src: torch.Tensor, dst: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Sim3:
    """Weighted Umeyama fit of dst onto src; src/dst (..., n, 3), weights
    (..., n) boolean or nonnegative (None = all ones)."""
    dtype = src.dtype
    if weights is None:
        w = torch.ones(src.shape[:-1], dtype=dtype, device=src.device)
    else:
        w = weights.to(dtype)
    wsum = torch.sum(w, dim=-1)
    safe_wsum = torch.where(wsum > 0, wsum, torch.ones_like(wsum))[..., None]
    src_centroid = torch.sum(w[..., None] * src, dim=-2) / safe_wsum
    dst_centroid = torch.sum(w[..., None] * dst, dim=-2) / safe_wsum
    src_c = src - src_centroid[..., None, :]
    dst_c = dst - dst_centroid[..., None, :]
    ws = w[..., None] * src_c
    H_cols = tuple(
        tuple(torch.sum(ws[..., i] * dst_c[..., j], dim=-1) for i in range(3))
        for j in range(3)
    )
    var_src_sum = torch.sum(w * torch.sum(src_c**2, dim=-1), dim=-1)
    return umeyama_sim3_from_moments(
        wsum, src_centroid, dst_centroid, H_cols, var_src_sum
    )


def umeyama_sim3_from_moments(
    wsum: torch.Tensor,
    src_centroid: torch.Tensor,
    dst_centroid: torch.Tensor,
    H_cols,
    var_src_sum: torch.Tensor,
) -> Sim3:
    """Umeyama Sim(3) from sufficient statistics: ``wsum`` Σw, centroids,
    ``H_cols[j][i]`` = Σ w·(src−μs)ᵢ(dst−μd)ⱼ, ``var_src_sum`` Σ w·‖src−μs‖²."""
    n_eff = wsum
    safe_wsum = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    u0, u1, u2, (s0, s1, s2), v0, v1, v2 = svd3x3_soa(H_cols)

    def r_components(v2_sign):
        # R = V_fixed @ Uᵀ with the reflection sign on V's column 2.
        return tuple(
            tuple(
                v0[i] * u0[j] + v1[i] * u1[j] + v2_sign * v2[i] * u2[j]
                for j in range(3)
            )
            for i in range(3)
        )

    one = torch.ones_like(s0)
    r = r_components(one)
    det = (
        r[0][0] * (r[1][1] * r[2][2] - r[1][2] * r[2][1])
        - r[0][1] * (r[1][0] * r[2][2] - r[1][2] * r[2][0])
        + r[0][2] * (r[1][0] * r[2][1] - r[1][1] * r[2][0])
    )
    r = r_components(torch.where(det < 0, -one, one))

    var_src = var_src_sum / safe_wsum
    trace_S = s0 + s1 + s2
    raw_scale = trace_S / (n_eff * torch.where(var_src > 0, var_src, one))
    scale = torch.where(var_src < 1e-12, one, raw_scale)
    scale = torch.where(scale <= 1e-6, one, scale)

    t = torch.stack(
        [
            dst_centroid[..., i]
            - scale
            * (
                r[i][0] * src_centroid[..., 0]
                + r[i][1] * src_centroid[..., 1]
                + r[i][2] * src_centroid[..., 2]
            )
            for i in range(3)
        ],
        dim=-1,
    )
    R = torch.stack([torch.stack(row, dim=-1) for row in r], dim=-2)
    return Sim3(R=R, t=t, scale=scale, ok=n_eff >= 3)


def sim3_residuals(src: torch.Tensor, dst: torch.Tensor, sim3: Sim3) -> torch.Tensor:
    """Per-point ‖s·src·Rᵀ + t − dst‖ (reference: EKFGPSSLAM.py:409-410)."""
    pred = sim3.scale * (src @ sim3.R.T) + sim3.t
    return torch.linalg.norm(pred - dst, dim=-1)


def umeyama_sim3_batched(src: torch.Tensor, dst: torch.Tensor, weights: Optional[torch.Tensor] = None) -> Sim3:
    """The JAX package's ``vmap(umeyama_sim3, in_axes=(0, 0, None))``: src
    and dst (B, n, 3), one ``weights`` (n,) (or None) shared by every row;
    every field of the result has the leading B."""
    return umeyama_sim3(src, dst, None if weights is None else weights.expand(src.shape[:-1]))
