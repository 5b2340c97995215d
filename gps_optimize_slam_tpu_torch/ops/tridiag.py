"""Tridiagonal solver as associative scans (port of
``gps_optimize_slam_tpu.ops.tridiag``).

The Thomas algorithm's three recurrences, each an associative scan through
K1 (``ops.scan``): the pivots b'_i = b_i − a_i·c_{i−1}/b'_{i−1} as normalised
2×2 (Möbius) prefix products, the forward-eliminated right-hand side as an
affine scan, and the back substitution as a reverse affine scan. Rows with
a_i = c_i = 0 reset all three recurrences, so independent segments decouple.
"""

from __future__ import annotations

import torch

from gps_optimize_slam_tpu_torch.ops.scan import associative_scan


def tridiag_solve(
    a: torch.Tensor,  # (n,) sub-diagonal (a[0] ignored)
    b: torch.Tensor,  # (n,) diagonal
    c: torch.Tensor,  # (n,) super-diagonal (c[-1] ignored)
    d: torch.Tensor,  # (n, 3) right-hand sides
) -> torch.Tensor:
    """Solve the tridiagonal system for three right-hand sides."""
    n = b.shape[0]
    if d.shape != (n, 3):
        raise ValueError(f"tridiag_solve takes (n, 3) right-hand sides, got {tuple(d.shape)}")
    zero1 = torch.zeros((1,), dtype=b.dtype, device=b.device)
    a0 = torch.cat([zero1, a[1:]])
    cm1 = torch.cat([zero1, c[:-1]])  # c_{i-1}
    # T_i = [[b_i, -a_i·c_{i-1}], [1, 0]]; T_i · [b'_{i-1}, 1]ᵀ ∝ [b'_i, 1]ᵀ
    T = torch.stack([b, -a0 * cm1, torch.ones_like(b), torch.zeros_like(b)])
    P = associative_scan("mobius", T)
    bp = P[0] / P[2]

    bpm1 = torch.cat([torch.ones_like(zero1), bp[:-1]])
    alpha = -(a0 / bpm1)
    dp = associative_scan("affine3", torch.stack([alpha, d[:, 0], d[:, 1], d[:, 2]]))[1:]

    alpha_b = torch.cat([(-c / bp)[:-1], zero1])
    inv_bp = 1.0 / bp
    beta_b = dp * inv_bp
    x = associative_scan(
        "affine3", torch.stack([alpha_b, beta_b[0], beta_b[1], beta_b[2]]), reverse=True
    )[1:]
    return x.T
