"""Out-of-core temporal alignment + Sim(3) estimation on raw GNSS (port of
``gps_optimize_slam_tpu.ops.alignment_chunked``).

With ``ops.kalman_chunked`` this lets raw (unaligned, gappy, duplicate-laden)
GNSS fixes and a SLAM stream of any length fuse with O(chunk) device
residency: the recipe of the in-core ``models.fusion.fuse_core``
(reference EKFGPSSLAM.py:940-1123), re-entrant over host chunks.

Why chunked alignment is exact: the per-segment not-a-knot cubic spline
(reference interp1d path, EKFGPSSLAM.py:325-387) solves a strictly
diagonally dominant tridiagonal system, so a knot's influence on the
moments decays geometrically with distance, by at most 1/(2+√3) ≈ 0.268
per knot. Evaluating a SLAM chunk against a GPS *window* that extends
``halo`` knots beyond the chunk's span reproduces the full-trajectory spline
to within 0.268^halo (≈1e-37 at the default halo = 64). The device work IS
the port's ``alignment.align_gps_to_slam`` on the window (tridiagonal
solver, ``assume_sorted``), so its scans run through K1 or K2 by size. The
one global property, the reference's "any within-segment step ≤ 1e-9 skips
the whole segment" (EKFGPSSLAM.py:364-366), is computed in a host prepass.

Sim(3) at scale: the calc window (first gap-free run ≤ 180 s, reference
EKFGPSSLAM.py:977-998) is found by a host scan of the aligned validity;
RANSAC trials run in-core (``ransac.sim3_ransac``, K5) on at most a uniform
subsample, and the final refit streams Umeyama sufficient statistics over
ALL inliers (``umeyama.umeyama_sim3_from_moments``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gps_optimize_slam_tpu_torch.config import Sim3RansacConfig, TimeAlignConfig
from gps_optimize_slam_tpu_torch.ops import alignment, ransac
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3, umeyama_sim3_from_moments
from gps_optimize_slam_tpu_torch.utils import streaming
from gps_optimize_slam_tpu_torch.utils.device import numpy_dtype, resolve_device


class CompactGPS(NamedTuple):
    """Host-side compacted GNSS stream (sorted, deduplicated, offset applied).

    ``ok`` marks samples whose segment survives the reference's global
    bad-step check; they are the only samples the device windows may use.
    """

    times: np.ndarray  # (n_eff,) sorted, strictly increasing
    positions: np.ndarray  # (n_eff, 3)
    ok: np.ndarray  # (n_eff,) bool


def compact_gps_host(
    gps_times,
    gps_positions,
    gps_valid=None,
    time_offset: float = 0.0,
    gap_threshold: float = 5.0,
    chunk: int = 1 << 20,
    dtype: torch.dtype = torch.float64,
) -> CompactGPS:
    """Streaming host prepass: drop invalid fixes, sort if needed, dedup
    (keep the first occurrence), apply the clock offset, and mark samples of
    segments containing a post-dedup step ≤ 1e-9 as unusable (the reference
    skips such segments entirely; a window cut cannot see that globally).

    Sorted inputs stream in O(chunk) working memory; an unsorted stream
    takes one host argsort (the inputs are host-resident anyway)."""
    np_dt = numpy_dtype(dtype)
    m = len(gps_times)
    if gps_valid is None:
        gps_valid = np.ones(m, bool)

    t_out = np.empty(m, np_dt)
    p_out = np.empty((m, 3), np_dt)
    n = 0
    last_t = -np.inf
    sorted_ok = True
    for a in range(0, m, chunk):
        t = np.asarray(gps_times[a : a + chunk], np_dt) + time_offset
        p = np.asarray(gps_positions[a : a + chunk], np_dt)
        v = np.asarray(gps_valid[a : a + chunk], bool) & np.isfinite(t)
        tv, pv = t[v], p[v]
        if tv.size == 0:
            continue
        if tv[0] < last_t or np.any(np.diff(tv) < 0):
            sorted_ok = False
            break
        keep = np.empty(tv.size, bool)
        keep[0] = tv[0] > last_t
        keep[1:] = tv[1:] > tv[:-1]
        k = int(keep.sum())
        t_out[n : n + k] = tv[keep]
        p_out[n : n + k] = pv[keep]
        n += k
        last_t = tv[-1]

    if not sorted_ok:
        t = np.asarray(gps_times, np_dt) + time_offset
        v = np.asarray(gps_valid, bool) & np.isfinite(t)
        tv = t[v]
        pv = np.asarray(gps_positions, np_dt)[v]
        order = np.argsort(tv, kind="stable")
        tv, pv = tv[order], pv[order]
        keep = np.empty(tv.size, bool)
        keep[:1] = True
        keep[1:] = tv[1:] > tv[:-1]
        n = int(keep.sum())
        t_out[:n] = tv[keep]
        p_out[:n] = pv[keep]

    t_c, p_c = t_out[:n], p_out[:n]
    # Global segment health: segments split at gaps > threshold; any step
    # ≤ 1e-9 inside a segment poisons the WHOLE segment.
    ok = np.ones(n, bool)
    if n >= 2:
        dt = np.diff(t_c)
        gap = dt > gap_threshold
        bad = (dt <= 1e-9) & ~gap
        if bad.any():
            seg_id = np.concatenate([[0], np.cumsum(gap)])
            bad_segs = np.unique(seg_id[:-1][bad])
            ok = ~np.isin(seg_id, bad_segs)
    return CompactGPS(times=t_c, positions=p_c, ok=ok)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def align_gps_to_slam_chunked(
    slam_times,
    gps_times,
    gps_positions,
    gps_valid=None,
    time_offset: float = 0.0,
    cfg: TimeAlignConfig = TimeAlignConfig(),
    chunk_size: int = 65536,
    halo: int = 64,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``alignment.align_gps_to_slam`` for host-resident (memory-mappable)
    arrays of any length: SLAM timestamps stream through fixed-size chunks,
    each evaluated against the GPS window covering its span plus a ``halo``
    of knots on each side (see the module docstring for why that is exact).

    Returns host ``(aligned (N,3), valid (N,))``. Device residency is
    O(chunk + window).
    """
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    n = len(slam_times)
    t_c, p_c, ok_c = compact_gps_host(
        gps_times, gps_positions, gps_valid, time_offset=time_offset,
        gap_threshold=cfg.max_gps_gap_threshold, dtype=dtype,
    )
    m = len(t_c)
    out_aligned = np.empty((n, 3), np_dt)
    out_valid = np.empty(n, bool)
    if m == 0:
        out_aligned[:] = np.nan
        out_valid[:] = False
        return out_aligned, out_valid

    nc = min(chunk_size, n)
    # One window size for all chunks: the widest chunk-span window, rounded
    # up. Chunk spans are known on the host from two searchsorteds a chunk.
    bounds = []
    w_need = 1
    for a in range(0, n, nc):
        b = min(a + nc, n)
        ta = float(np.min(np.asarray(slam_times[a:b], np_dt)))
        tb = float(np.max(np.asarray(slam_times[a:b], np_dt)))
        lo = max(int(np.searchsorted(t_c, ta, side="right")) - 1 - halo, 0)
        hi = min(int(np.searchsorted(t_c, tb, side="left")) + 1 + halo, m)
        bounds.append((a, b, lo, hi))
        w_need = max(w_need, hi - lo)
    w = min(_round_up(w_need, 256), m) if m > 256 else m

    def _stage(item):
        a, b, lo, hi = item
        hi = min(max(hi, lo + w), m)
        lo = max(hi - w, 0)
        st = np.full(nc, np.inf, np_dt)
        st[: b - a] = np.asarray(slam_times[a:b], np_dt)
        wt = np.full(w, np.inf, np_dt)
        wp = np.zeros((w, 3), np_dt)
        wo = np.zeros(w, bool)
        wt[: hi - lo] = t_c[lo:hi]
        wp[: hi - lo] = p_c[lo:hi]
        wo[: hi - lo] = ok_c[lo:hi]
        # A SLAM timestamp earlier than the window's first knot is marked
        # invalid by the alignment (slam_times >= t[0]), which is also
        # globally right since lo > 0 implies t_c[lo] <= ta.
        return tuple(torch.as_tensor(x, device=device) for x in (st, wt, wp, wo))

    def _launch(item, staged):
        st, wt, wp, wo = staged
        out = alignment.align_gps_to_slam(
            st, wt, wp, gps_valid=wo, cfg=cfg, spline_solver="tridiagonal", assume_sorted=True
        )
        return out.aligned, out.valid

    def _drain(item, out):
        a, b = item[0], item[1]
        out_aligned[a:b] = out[0][: b - a].cpu().numpy()
        out_valid[a:b] = out[1][: b - a].cpu().numpy()

    streaming.stream_chunks(bounds, _stage, _launch, _drain)
    return out_aligned, out_valid


def sim3_window_mask_host(
    slam_times,
    valid,
    gap_threshold: float,
    max_duration: float,
    min_samples: int,
) -> np.ndarray:
    """Host-NumPy mirror of ``alignment.sim3_window_mask`` (reference window
    selection EKFGPSSLAM.py:977-998) for memmap-scale masks: the first
    gap-free run of valid timestamps truncated to ``max_duration``, with the
    too-few-points fallbacks. Vectorised prefix ops, O(N) host."""
    t = np.asarray(slam_times)
    v = np.asarray(valid, bool)
    n_valid = int(v.sum())
    if n_valid == 0:
        return np.zeros(len(t), bool)
    rank = np.cumsum(v)
    t_masked = np.where(v, t, -np.inf)
    prev_t = np.concatenate([[-np.inf], np.maximum.accumulate(t_masked)[:-1]])
    gap_pair = v & (rank >= 2) & ((t - prev_t) > gap_threshold)
    first_gap_rank = int(rank[gap_pair].min()) if gap_pair.any() else np.iinfo(np.int64).max
    run_len = min(first_gap_rank - 2, n_valid)
    run_start_t = t[v].min()
    at_end = v & (rank == run_len)
    run_end_t = t[at_end].max() if at_end.any() else -np.inf
    in_first_run = v & (t <= run_end_t)
    timed = in_first_run & (t <= run_start_t + max_duration)
    if int(in_first_run.sum()) < min_samples:
        return v
    if int(timed.sum()) < min_samples:
        return in_first_run
    return timed


class StreamingSim3Result(NamedTuple):
    sim3: Sim3  # tensors on the fusion's device (R, t, scale, ok)
    num_inliers: int
    num_window: int
    subsampled: bool


def sim3_ransac_streaming(
    src,
    dst,
    window_mask,
    cfg: Sim3RansacConfig = Sim3RansacConfig(),
    max_ransac_points: int = 32768,
    chunk_size: int = 262144,
    dtype: torch.dtype = torch.float64,
    seed: int = 0,
    draws: Optional[torch.Tensor] = None,
    device=None,
) -> StreamingSim3Result:
    """Robust Sim(3) on host-resident point streams of any length.

    RANSAC consensus voting runs in-core (``ransac.sim3_ransac``: K5) on the
    window points or, above ``max_ransac_points``, on a uniform stride
    subsample; ``seed``/``draws`` go to it (``draws`` index the points it
    sees), and ``cfg.stop_probability`` stops its trials early as it does
    there. The FINAL fit then streams over every window point: the winning
    model's inliers are found chunk by chunk in the working dtype, and the
    Umeyama sufficient statistics (centroids, then the centred
    cross-covariance and variance: two passes) accumulate in float64, as
    the in-core refit fits in float64, into
    ``umeyama_sim3_from_moments``."""
    device = resolve_device(device)
    np_dt = numpy_dtype(dtype)
    idx = np.flatnonzero(np.asarray(window_mask, bool))
    n_win = idx.size
    if n_win < cfg.min_samples:
        eye = torch.eye(3, dtype=dtype, device=device)
        return StreamingSim3Result(
            sim3=Sim3(R=eye, t=torch.zeros(3, dtype=dtype, device=device),
                      scale=torch.ones((), dtype=dtype, device=device),
                      ok=torch.tensor(False, device=device)),
            num_inliers=0, num_window=n_win, subsampled=False,
        )

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    subsampled = n_win > max_ransac_points
    sub = idx[:: -(-n_win // max_ransac_points)] if subsampled else idx
    src_np, dst_np = np.asarray(src), np.asarray(dst)
    res = ransac.sim3_ransac(dev(src_np[sub]), dev(dst_np[sub]), cfg=cfg, seed=seed, draws=draws)
    if not subsampled:
        # Everything fit in-core: the in-core result IS the exact answer.
        return StreamingSim3Result(sim3=res.sim3, num_inliers=int(res.num_inliers),
                                   num_window=n_win, subsampled=False)

    R, t, s = res.sim3.R, res.sim3.t, res.sim3.scale
    thr2 = float(cfg.residual_threshold) ** 2
    f64 = torch.float64
    chunks = []
    acc = {"w": torch.zeros((), dtype=f64, device=device),
           "s": torch.zeros(3, dtype=f64, device=device),
           "d": torch.zeros(3, dtype=f64, device=device)}

    def _stage(ci):
        return dev(src_np[ci]), dev(dst_np[ci])

    def _pass1(ci, staged):
        sc, dc = staged
        w = torch.sum((s * (sc @ R.T) + t - dc) ** 2, dim=-1) < thr2
        wf = w.to(f64)
        acc["w"] = acc["w"] + torch.sum(wf)
        acc["s"] = acc["s"] + wf @ sc.to(f64)
        acc["d"] = acc["d"] + wf @ dc.to(f64)
        return w

    streaming.stream_chunks(
        (idx[a : a + chunk_size] for a in range(0, n_win, chunk_size)),
        _stage, _pass1, lambda ci, w: chunks.append((ci, w.cpu().numpy())),
    )
    wsum = acc["w"]
    mu_s = acc["s"] / torch.clamp(wsum, min=1.0)
    mu_d = acc["d"] / torch.clamp(wsum, min=1.0)
    n_inl = int(wsum)
    if n_inl < cfg.min_inliers_needed:
        return StreamingSim3Result(
            sim3=Sim3(R=R, t=t, scale=s, ok=torch.tensor(False, device=device)),
            num_inliers=n_inl, num_window=n_win, subsampled=True,
        )
    acc2 = {"H": torch.zeros((3, 3), dtype=f64, device=device),
            "v": torch.zeros((), dtype=f64, device=device)}

    def _stage2(cw):
        ci, w = cw
        return dev(src_np[ci], f64), dev(dst_np[ci], f64), dev(w, f64)

    def _pass2(cw, staged):
        sc, dc, wf = staged
        sc = sc - mu_s
        dc = dc - mu_d
        acc2["H"] = acc2["H"] + (wf[:, None] * sc).T @ dc
        acc2["v"] = acc2["v"] + torch.sum(wf * torch.sum(sc**2, dim=-1))

    streaming.stream_chunks(chunks, _stage2, _pass2, None)
    H = acc2["H"]
    H_cols = tuple(tuple(H[i, j] for i in range(3)) for j in range(3))
    refit = umeyama_sim3_from_moments(wsum, mu_s, mu_d, H_cols, acc2["v"])
    ok = bool(refit.ok) and n_inl >= cfg.min_inliers_needed
    return StreamingSim3Result(
        sim3=Sim3(R=refit.R.to(dtype), t=refit.t.to(dtype), scale=refit.scale.to(dtype),
                  ok=torch.tensor(ok, device=device)),
        num_inliers=n_inl, num_window=n_win, subsampled=True,
    )
