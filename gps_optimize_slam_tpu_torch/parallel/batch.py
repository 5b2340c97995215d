"""Padded multi-sequence batching (port of
``gps_optimize_slam_tpu.parallel.batch``; NumPy only, the port's own copy).

The scale-out axis is the SEQUENCE: every (SLAM, GPS) pair is padded to a
common length and stacked, and ``parallel.mesh.fuse_batch`` fuses the stack
as one batched program, each stage issued once for all rows.

Padding invariants (why padded entries cannot perturb real outputs):
* SLAM padding repeats the final pose with strictly increasing timestamps →
  relative motion is exactly zero, the EKF dead-reckons in place;
* padded GPS entries are invalid → they are masked out of alignment, the
  Sim3 window, and the filter update;
* a padded tail is a trailing GNSS outage, which the reference semantics
  leave unsmoothed — so RTS never reaches across the boundary.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np


class SequenceBatch(NamedTuple):
    """Stacked, padded fusion inputs (leading batch axis B)."""

    slam_times: np.ndarray  # (B, N)
    slam_pos: np.ndarray  # (B, N, 3)
    slam_quat: np.ndarray  # (B, N, 4)
    slam_mask: np.ndarray  # (B, N) bool — real (unpadded) poses
    gps_times: np.ndarray  # (B, M)
    gps_pos: np.ndarray  # (B, M, 3)
    gps_valid: np.ndarray  # (B, M) bool
    n_slam: np.ndarray  # (B,)
    n_gps: np.ndarray  # (B,)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_batch(
    slams: Sequence[Dict[str, np.ndarray]],
    gps_times: Sequence[np.ndarray],
    gps_positions: Sequence[np.ndarray],
    gps_valids: Optional[Sequence[np.ndarray]] = None,
    pad_multiple: int = 8,
    pad_dt: float = 0.1,
) -> SequenceBatch:
    """Pad and stack sequences for batched fusion."""
    b = len(slams)
    if len(gps_times) != b or len(gps_positions) != b:
        raise ValueError("pad_batch needs one GPS track per SLAM sequence")
    if gps_valids is None:
        gps_valids = [np.ones(len(t), bool) for t in gps_times]

    n_max = _round_up(max(len(s["timestamps"]) for s in slams), pad_multiple)
    m_max = _round_up(max(len(t) for t in gps_times), pad_multiple)

    st = np.zeros((b, n_max))
    sp = np.zeros((b, n_max, 3))
    sq = np.zeros((b, n_max, 4))
    sq[..., 3] = 1.0
    sm = np.zeros((b, n_max), bool)
    gt = np.zeros((b, m_max))
    gp = np.zeros((b, m_max, 3))
    gv = np.zeros((b, m_max), bool)
    n_slam = np.zeros(b, np.int32)
    n_gps = np.zeros(b, np.int32)

    for i, (slam, gtim, gpos, gval) in enumerate(zip(slams, gps_times, gps_positions, gps_valids)):
        n = len(slam["timestamps"])
        st[i, :n] = slam["timestamps"]
        sp[i, :n] = slam["positions"]
        sq[i, :n] = slam["quaternions"]
        sm[i, :n] = True
        n_slam[i] = n
        if n < n_max:  # repeat last pose, extend time strictly
            st[i, n:] = slam["timestamps"][-1] + pad_dt * np.arange(1, n_max - n + 1)
            sp[i, n:] = slam["positions"][-1]
            sq[i, n:] = slam["quaternions"][-1]
        m = len(gtim)
        gt[i, :m] = gtim
        gp[i, :m] = gpos
        gv[i, :m] = gval
        n_gps[i] = m
        if m < m_max:
            gt[i, m:] = gtim[-1] + pad_dt * np.arange(1, m_max - m + 1)

    return SequenceBatch(
        slam_times=st,
        slam_pos=sp,
        slam_quat=sq,
        slam_mask=sm,
        gps_times=gt,
        gps_pos=gp,
        gps_valid=gv,
        n_slam=n_slam,
        n_gps=n_gps,
    )


def bucket_by_length(
    slams: Sequence[Dict[str, np.ndarray]],
    gps_times: Sequence[np.ndarray],
    gps_positions: Sequence[np.ndarray],
    gps_valids: Optional[Sequence[np.ndarray]] = None,
    max_waste: float = 2.0,
    pad_multiple: int = 8,
    pad_dt: float = 0.1,
):
    """Group sequences into length buckets to cap padding waste.

    Greedy bucketing over the length-sorted sequences starts a new bucket
    whenever max_len/min_len would exceed ``max_waste``, bounding per-bucket
    padding overhead while keeping the bucket count (one batched program
    each) small.

    Returns a list of ``(indices, SequenceBatch)``: ``indices`` maps bucket
    rows back to positions in the input order.
    """
    if gps_valids is None:
        gps_valids = [np.ones(len(t), bool) for t in gps_times]
    lengths = [len(s["timestamps"]) for s in slams]
    order = sorted(range(len(slams)), key=lambda i: lengths[i])

    buckets = []
    cur: list = []
    for i in order:
        if cur and lengths[i] > max_waste * lengths[cur[0]]:
            buckets.append(cur)
            cur = []
        cur.append(i)
    if cur:
        buckets.append(cur)

    out = []
    for idxs in buckets:
        batch = pad_batch(
            [slams[i] for i in idxs],
            [gps_times[i] for i in idxs],
            [gps_positions[i] for i in idxs],
            [gps_valids[i] for i in idxs],
            pad_multiple=pad_multiple,
            pad_dt=pad_dt,
        )
        out.append((np.asarray(idxs), batch))
    return out
