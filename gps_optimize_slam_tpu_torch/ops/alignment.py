"""Gap-aware temporal alignment of GPS samples onto SLAM timestamps (port of
``gps_optimize_slam_tpu.ops.alignment``).

The reference's dynamic_time_alignment (EKFGPSSLAM.py:325-387) with static
shapes: invalid and duplicate samples are masked and compacted, gap-separated
segments are labelled by three associative scans (K1: a sum, a max and a
reverse min), and every per-segment not-a-knot cubic spline is solved at once,
densely below 256 GPS samples and by the scan-based tridiagonal solver above.
Segments of 2-3 points interpolate linearly, as in the reference
(EKFGPSSLAM.py:362). Validity comes back as a boolean mask.

Semantics notes (SURVEY.md §2.5):
* Q1: the reference's estimate_time_offset correlates the z-scored resampled
  timestamp ramps, so the offset is exactly 0.0 for any ≥2-sample inputs.
* Duplicate timestamps keep the first occurrence under a stable sort.
* A segment whose post-dedup steps are not all > 1e-9 is skipped
  (EKFGPSSLAM.py:364-366).

``estimate_time_offset_xcorr`` (host) and ``estimate_time_offset_xcorr_device``
(``torch.fft`` on the tensors' device) are the functional clock-offset
estimators: cross-correlation of the two speed profiles.

The JAX package's TPU gather work-arounds (the one-hot matmul gather and the
compare-all searchsorted) are not carried over: ``torch.searchsorted`` and
plain indexing do that work here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gps_optimize_slam_tpu_torch.config import TimeAlignConfig
from gps_optimize_slam_tpu_torch.ops.scan import associative_scan
from gps_optimize_slam_tpu_torch.ops.tridiag import tridiag_solve

_INF = float("inf")
# Integers ride the float32 scans exactly only below 2**24 (see
# _segment_structure).
_F32_EXACT_INT = 1 << 24


def estimate_time_offset(slam_times, gps_times, max_samples: int = 500) -> float:
    """Cross-correlation clock-offset estimate (reference EKFGPSSLAM.py:301-323).

    Host-side NumPy, faithful to the reference — including the quirk that it
    correlates the resampled timestamp ramps themselves, which makes the
    result exactly 0.0 whenever both series have ≥2 samples (SURVEY §2.5 Q1).
    """
    import numpy as np

    slam_times = np.asarray(slam_times)
    gps_times = np.asarray(gps_times)
    if len(slam_times) < 2 or len(gps_times) < 2:
        return 0.0
    num_samples = min(max_samples, len(slam_times), len(gps_times))
    if num_samples < 2:
        return 0.0
    slam_s = np.linspace(slam_times.min(), slam_times.max(), num_samples)
    gps_s = np.linspace(gps_times.min(), gps_times.max(), num_samples)
    slam_n = slam_s - slam_s.mean()
    gps_n = gps_s - gps_s.mean()
    s_std, g_std = slam_n.std(), gps_n.std()
    if s_std < 1e-9 or g_std < 1e-9:
        return 0.0
    corr = np.correlate(slam_n / s_std, gps_n / g_std, mode="full")
    lag = int(corr.argmax()) - len(slam_n) + 1
    dt = (slam_s[-1] - slam_s[0]) / (num_samples - 1) if num_samples > 1 else 0.0
    return float(lag * dt)


def estimate_time_offset_xcorr(
    slam_times,
    slam_positions,
    gps_times,
    gps_positions,
    max_lag_seconds: float = 10.0,
    grid_dt: float = 0.05,
) -> float:
    """FUNCTIONAL clock-offset estimation (extension beyond the reference).

    The reference's estimator cross-correlates the resampled timestamp ramps
    themselves and therefore always returns 0 (SURVEY Q1). This one
    cross-correlates the two SPEED profiles (scale-free after z-scoring, so
    the monocular SLAM scale ambiguity does not matter) and returns the
    offset to ADD to the GPS timestamps so they align with SLAM time, the
    sign convention the alignment consumes. Host-side NumPy.
    """
    import numpy as np

    slam_times = np.asarray(slam_times, float)
    gps_times = np.asarray(gps_times, float)
    slam_positions = np.asarray(slam_positions, float)
    gps_positions = np.asarray(gps_positions, float)
    if len(slam_times) < 3 or len(gps_times) < 3:
        return 0.0

    def speed_series(t, p):
        dt = np.diff(t)
        ok = dt > 1e-9
        v = np.linalg.norm(np.diff(p, axis=0), axis=1) / np.where(ok, dt, 1.0)
        tm = (t[:-1] + t[1:]) / 2.0
        return tm[ok], v[ok]

    ts, vs = speed_series(slam_times, slam_positions)
    tg, vg = speed_series(gps_times, gps_positions)
    if len(ts) < 2 or len(tg) < 2:
        return 0.0

    lo = min(ts[0], tg[0]) - max_lag_seconds
    hi = max(ts[-1], tg[-1]) + max_lag_seconds
    grid = np.arange(lo, hi, grid_dt)
    a = np.interp(grid, ts, vs, left=0.0, right=0.0)
    b = np.interp(grid, tg, vg, left=0.0, right=0.0)

    def z(x):
        s = x.std()
        return (x - x.mean()) / (s if s > 1e-12 else 1.0)

    a, b = z(a), z(b)
    max_lag = int(round(max_lag_seconds / grid_dt))
    # corr[k] = Σ a[i] · b[i + k]  for k in [-max_lag, max_lag]:
    # positive k ⇒ GPS events happen LATER on the grid ⇒ subtract k·dt.
    # The same FFT circular cross-correlation as the device estimator.
    lags = np.arange(-max_lag, max_lag + 1)
    n_g = len(a)
    corr_full = np.fft.irfft(np.conj(np.fft.rfft(a)) * np.fft.rfft(b), n=n_g)
    corr = corr_full[lags % n_g]
    best = lags[int(np.argmax(corr))]
    return float(-best * grid_dt)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp(x, xp, fp)`` for nondecreasing ``xp``: piecewise linear
    inside, ``fp[0]`` left of ``xp[0]`` and ``fp[-1]`` right of ``xp[-1]``. A
    tail of ``xp`` padded with +inf is allowed when ``fp`` repeats its last
    real value there (the slope over an infinite step is 0)."""
    m = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, m - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx, df = xp[i] - x0, fp[i] - f0
    flat = torch.abs(dx) <= torch.finfo(x.dtype).eps ** 2  # the JAX package's zero-step test
    f = torch.where(flat, f0, f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def estimate_time_offset_xcorr_device(
    slam_times: torch.Tensor,
    slam_positions: torch.Tensor,
    gps_times: torch.Tensor,
    gps_positions: torch.Tensor,
    slam_mask: Optional[torch.Tensor] = None,
    gps_valid: Optional[torch.Tensor] = None,
    max_lag_seconds: float = 10.0,
    n_grid: int = 4096,
) -> torch.Tensor:
    """ON-DEVICE clock-offset estimation: FFT circular cross-correlation of
    the two z-scored speed profiles (the counterpart of
    ``estimate_time_offset_xcorr`` on the tensors' device, with no host
    read, so padded sequences of a batch can estimate their offsets there).

    The uniform resampling grid has a FIXED length ``n_grid`` spanning
    [min_t − max_lag, max_t + max_lag] (the host version's grid step is a
    fixed 0.05 s, so its lag resolution is constant while this one's scales
    with the trajectory's duration; both recover real offsets to one grid
    cell). Invalid and padded samples are masked out as the host version
    drops them. The transforms are ``torch.fft``'s. Returns the () offset to
    ADD to GPS timestamps.
    """
    dtype, device = slam_times.dtype, slam_times.device
    if slam_mask is None:
        slam_mask = torch.ones(slam_times.shape, dtype=torch.bool, device=device)
    if gps_valid is None:
        gps_valid = torch.ones(gps_times.shape, dtype=torch.bool, device=device)

    def speeds(t, p, m):
        t, p = t.to(dtype), p.to(dtype)
        dt = t[1:] - t[:-1]
        ok = (dt > 1e-9) & m[1:] & m[:-1]
        v = torch.linalg.norm(p[1:] - p[:-1], dim=-1) / torch.where(ok, dt, 1.0)
        tm = (t[1:] + t[:-1]) / 2.0
        # Valid samples compacted to the front, the tail padded with +inf so
        # ``interp`` sees a nondecreasing xp; the padding repeats the last
        # valid value, and points right of the last REAL midpoint are zeroed
        # by ``resample``.
        order = torch.sort(torch.where(ok, tm, _INF), stable=True).indices
        tm_c = torch.where(ok[order], tm[order], _INF)
        v_c = torch.where(ok[order], v[order], 0.0)
        n_ok = torch.sum(ok)
        last = torch.clamp(n_ok - 1, 0, tm.shape[0] - 1)
        v_c = torch.where(torch.arange(tm.shape[0], device=device) < n_ok, v_c, v_c[last])
        return tm_c, v_c, tm_c[0], tm_c[last], n_ok

    ts, vs, s_first, s_last, s_n = speeds(slam_times, slam_positions, slam_mask)
    tg, vg, g_first, g_last, g_n = speeds(gps_times, gps_positions, gps_valid)

    lo = torch.minimum(s_first, g_first) - max_lag_seconds
    hi = torch.maximum(s_last, g_last) + max_lag_seconds
    dt_g = torch.clamp(hi - lo, min=1e-6) / n_grid
    grid = lo + dt_g * torch.arange(n_grid, dtype=dtype, device=device)

    def resample(t_c, v_c, first_t, last_t):
        y = interp(grid, t_c, v_c)
        return torch.where((grid < first_t) | (grid > last_t), 0.0, y)

    def z(x):
        sd = torch.std(x, unbiased=False)
        return (x - torch.mean(x)) / torch.where(sd > 1e-12, sd, 1.0)

    a = z(resample(ts, vs, s_first, s_last))
    b = z(resample(tg, vg, g_first, g_last))

    # corr[k] = Σᵢ a[i]·b[i+k] (circular) = irfft(conj(rfft(a))·rfft(b)).
    corr = torch.fft.irfft(torch.conj(torch.fft.rfft(a)) * torch.fft.rfft(b), n=n_grid)
    k = torch.arange(n_grid, device=device)
    signed = torch.where(k <= n_grid // 2, k, k - n_grid)
    in_range = torch.abs(signed * dt_g) <= max_lag_seconds
    best = torch.argmax(torch.where(in_range, corr, -_INF))
    offset = -signed[best].to(dtype) * dt_g
    return torch.where((s_n >= 2) & (g_n >= 2), offset, 0.0)


class AlignedGPS(NamedTuple):
    """GPS positions interpolated onto SLAM timestamps.

    aligned: (n_slam, 3) interpolated positions (NaN where invalid).
    valid:   (n_slam,) bool — True where a GPS segment covers the timestamp.
    """

    aligned: torch.Tensor
    valid: torch.Tensor


def _full(shape, value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype or like.dtype, device=like.device)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _compact_sort(
    times: torch.Tensor,
    positions: torch.Tensor,
    valid: torch.Tensor,
    assume_sorted: bool = False,
):
    """Stable-sort by time, drop invalid + duplicate timestamps by
    compaction. Returns (t, pos, keep_count) with +inf padding at the tail.

    ``assume_sorted=True`` (the VALID timestamps are nondecreasing, as in
    every real GNSS stream; callers verify on the host) skips the sort: a
    duplicate is then a time equal to the running max of earlier valid
    times."""
    m = times.shape[0]
    key = torch.where(valid, times, _INF)
    if assume_sorted:
        t_sorted = key
        p_sorted = positions
        prev_valid_t = torch.cat(
            [
                _full((1,), -_INF, times),
                torch.cummax(torch.where(valid, times, -_INF), 0).values[:-1],
            ]
        )
        dup = valid & (times == prev_valid_t)
        keep = torch.isfinite(key) & ~dup
    else:
        order = torch.sort(key, stable=True).indices
        t_sorted = key[order]
        p_sorted = positions[order]
        dup = torch.cat([_full((1,), False, valid), t_sorted[1:] == t_sorted[:-1]])
        keep = torch.isfinite(t_sorted) & ~dup
    n_eff = torch.sum(keep)
    # Each row's destination is its rank among the kept rows (dropped rows
    # go behind, in order): a permutation, so scattering iota through it
    # gives the gather order.
    iota = torch.arange(m, device=times.device)
    ranks = torch.cumsum(keep, 0) - 1
    dest = torch.where(keep, ranks, n_eff + (iota - ranks) - 1)
    order2 = torch.empty_like(iota)
    order2[dest] = iota
    t_c = torch.where(iota < n_eff, t_sorted[order2], _INF)
    p_c = p_sorted[order2]
    return t_c, p_c, n_eff


def _segment_structure(t: torch.Tensor, n_eff, gap_threshold: float):
    """Label gap-separated segments on compacted times.

    Returns (seg_id, is_real, start_idx, end_idx, start_t, end_t, length,
    ok), every aggregate PER POINT (each point carries its segment's value).
    Segments are contiguous runs of the sorted times, so each aggregate is a
    prefix sum, a running max of start-marked values, or a reverse running
    min of end-marked values: three K1 scans (``add2``, ``max3``, ``min3``
    reversed) in the working dtype. The propagated values are integers and
    knot times, exact in float64 and, below 2**24 points, in float32. A
    float32 run of 2**24 points or more computes the integer scans in int64
    instead (``torch.cumsum``/``cummax``/``cummin``), as the JAX package's
    exact-integer branch does. ``ok`` requires len ≥ 2 and every
    within-segment step > 1e-9.
    """
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    is_real = idx < n_eff
    dt = torch.diff(t)  # inf (or NaN) at and after the padding boundary
    gap = dt > gap_threshold
    one = _full((1,), True, t, torch.bool)
    is_start = torch.cat([one, gap])
    is_end = torch.cat([gap, one])
    bad = (dt <= 1e-9) & ~gap
    t_fin = torch.where(torch.isfinite(t), t, _INF)

    if t.dtype == torch.float32 and m >= _F32_EXACT_INT:
        seg_id = torch.cumsum(is_start.long(), 0) - 1
        start_idx = torch.cummax(torch.where(is_start, idx, -1), 0).values
        end_idx = _rev_cummin(torch.where(is_end, idx, m))
        start_t = torch.cummax(torch.where(is_start, t_fin, -_INF), 0).values
        end_t = _rev_cummin(torch.where(is_end, t_fin, _INF))
        cb_excl = torch.cat([_full((1,), 0, idx), torch.cumsum(bad.long(), 0)])
        cb_start = torch.cummax(torch.where(is_start, cb_excl, -1), 0).values
        cb_end = _rev_cummin(torch.where(is_end, cb_excl, 2**62))
    else:
        idx_f = idx.to(t.dtype)
        bad_full = torch.cat([~one, bad])
        sums = associative_scan("add2", torch.stack([is_start.to(t.dtype), bad_full.to(t.dtype)]))
        seg_id = sums[0].long() - 1
        cb_excl = sums[1]
        mx = associative_scan(
            "max3",
            torch.stack(
                [
                    torch.where(is_start, idx_f, -1.0),
                    torch.where(is_start, t_fin, -_INF),
                    torch.where(is_start, cb_excl, -1.0),
                ]
            ),
        )
        mn = associative_scan(
            "min3",
            torch.stack(
                [
                    torch.where(is_end, idx_f, float(m)),
                    torch.where(is_end, t_fin, _INF),
                    torch.where(is_end, cb_excl, _INF),
                ]
            ),
            reverse=True,
        )
        start_idx, start_t, cb_start = mx[0].long(), mx[1], mx[2]
        end_idx, end_t, cb_end = mn[0].long(), mn[1], mn[2]

    seg_len = end_idx - start_idx + 1
    any_bad = (cb_end - cb_start) > 0
    seg_ok = (seg_len >= 2) & ~any_bad
    return seg_id, is_real, start_idx, end_idx, start_t, end_t, seg_len, seg_ok


def _slopes(t: torch.Tensor, y: torch.Tensor):
    """Divided-difference right-hand side r_j = slope_j − slope_{j−1}."""
    dt = torch.diff(t)
    y_s = torch.where(torch.isfinite(y), y, 0.0)
    slope = torch.diff(y_s, dim=0) / dt[:, None]
    slope = torch.where(torch.isfinite(slope), slope, 0.0)
    zero_row = torch.zeros((1, y.shape[1]), dtype=y.dtype, device=y.device)
    return torch.cat([slope, zero_row]) - torch.cat([zero_row, slope])


def _notaknot_moments(t, y, seg_id, is_real, seg_start_idx, seg_end_idx, seg_len, seg_ok):
    """Second derivatives ("moments") of every per-segment not-a-knot cubic
    spline, as one block-diagonal dense solve (identity rows, M=0, for points
    outside cubic segments)."""
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    dt = torch.diff(t)
    one = torch.ones((1,), dtype=t.dtype, device=t.device)
    h = torch.cat([dt, one])
    hm1 = torch.cat([one, dt])
    hm2 = torch.cat([torch.ones((2,), dtype=t.dtype, device=t.device), dt[:-1]])[:m]

    cubic_here = seg_ok & (seg_len >= 4) & is_real
    at_start = idx == seg_start_idx
    at_end = idx == seg_end_idx
    interior = cubic_here & ~at_start & ~at_end
    start_row = cubic_here & at_start
    end_row = cubic_here & at_end

    h_s = torch.where(torch.isfinite(h), h, 1.0)
    hm1_s = torch.where(torch.isfinite(hm1), hm1, 1.0)
    hm2_s = torch.where(torch.isfinite(hm2), hm2, 1.0)
    h0 = h_s
    h1 = torch.roll(h_s, -1)

    def pick(s, i, e, other):
        return torch.where(start_row, s, torch.where(interior, i, torch.where(end_row, e, other)))

    c0 = pick(h1, hm1_s / 6.0, hm1_s, torch.ones_like(h_s))
    c1 = pick(-(h0 + h1), (hm1_s + h_s) / 3.0, -(hm2_s + hm1_s), torch.zeros_like(h_s))
    c2 = pick(h0, h_s / 6.0, hm2_s, torch.zeros_like(h_s))
    zero = torch.zeros_like(idx)
    o0 = pick(zero, zero - 1, zero - 2, zero)
    o1 = pick(zero + 1, zero, zero - 1, zero)
    o2 = pick(zero + 2, zero + 1, zero, zero)

    A = torch.zeros((m, m), dtype=t.dtype, device=t.device)
    for o, c in ((o0, c0), (o1, c1), (o2, c2)):
        A.index_put_((idx, torch.clamp(idx + o, 0, m - 1)), c, accumulate=True)
    rhs = torch.where(interior[:, None], _slopes(t, y), 0.0)
    return torch.linalg.solve(A, rhs)


def _notaknot_moments_tridiag(t, y, seg_id, is_real, seg_start_idx, seg_end_idx, seg_len, seg_ok):
    """The same moments by a tridiagonal solve: the not-a-knot corner
    equations are eliminated into the adjacent interior rows, the interior
    system is solved by ``ops.tridiag`` (K1 scans), and the corner moments
    are recovered in closed form."""
    m = t.shape[0]
    idx = torch.arange(m, device=t.device)
    dt = torch.diff(t)
    one = torch.ones((1,), dtype=t.dtype, device=t.device)
    h = torch.cat([dt, one])
    hm1 = torch.cat([one, dt])
    h_s = torch.where(torch.isfinite(h) & (h > 0), h, 1.0)
    hm1_s = torch.where(torch.isfinite(hm1) & (hm1 > 0), hm1, 1.0)

    cubic_here = seg_ok & (seg_len >= 4) & is_real
    first_int = cubic_here & (idx == seg_start_idx + 1)
    last_int = cubic_here & (idx == seg_end_idx - 1)
    plain = cubic_here & (idx > seg_start_idx + 1) & (idx < seg_end_idx - 1)
    r = _slopes(t, y)

    interiorish = first_int | last_int | plain
    zero = torch.zeros_like(h_s)
    a = torch.where(plain | last_int, hm1_s / 6.0, zero)
    a = a - torch.where(last_int, h_s**2 / (6.0 * hm1_s), zero)
    b = torch.where(interiorish, (hm1_s + h_s) / 3.0, torch.ones_like(h_s))
    b = b + torch.where(first_int, hm1_s * (hm1_s + h_s) / (6.0 * h_s), zero)
    b = b + torch.where(last_int, h_s * (hm1_s + h_s) / (6.0 * hm1_s), zero)
    c = torch.where(plain | first_int, h_s / 6.0, zero)
    c = c - torch.where(first_int, hm1_s**2 / (6.0 * h_s), zero)
    d = torch.where(interiorish[:, None], r, 0.0)

    M = tridiag_solve(a, b, c, d)
    M = torch.where(interiorish[:, None], M, 0.0)

    # M_s = [M_{s+1}(h_s+h_{s+1}) − M_{s+2}·h_s] / h_{s+1}
    # M_e = [M_{e-1}(h_{e-2}+h_{e-1}) − M_{e-2}·h_{e-1}] / h_{e-2}
    at_start = cubic_here & (idx == seg_start_idx)
    at_end = cubic_here & (idx == seg_end_idx)
    j1 = torch.clamp(idx + 1, 0, m - 1)
    j2 = torch.clamp(idx + 2, 0, m - 1)
    h0 = h_s
    h1 = torch.where(torch.isfinite(h[j1]) & (h[j1] > 0), h[j1], 1.0)
    m_start = (M[j1] * (h0 + h1)[:, None] - M[j2] * h0[:, None]) / h1[:, None]
    k1 = torch.clamp(idx - 1, 0, m - 1)
    k2 = torch.clamp(idx - 2, 0, m - 1)
    he1 = hm1_s
    he2 = torch.where(torch.isfinite(hm1[k1]) & (hm1[k1] > 0), hm1[k1], 1.0)
    m_end = (M[k1] * (he2 + he1)[:, None] - M[k2] * he1[:, None]) / he2[:, None]
    M = torch.where(at_start[:, None], m_start, M)
    return torch.where(at_end[:, None], m_end, M)


def align_gps_to_slam(
    slam_times: torch.Tensor,
    gps_times: torch.Tensor,
    gps_positions: torch.Tensor,
    gps_valid: Optional[torch.Tensor] = None,
    time_offset: float = 0.0,
    cfg: TimeAlignConfig = TimeAlignConfig(),
    spline_solver: str = "auto",
    assume_sorted: bool = False,
) -> AlignedGPS:
    """Interpolate GPS positions onto SLAM timestamps, honouring gaps
    (reference dynamic_time_alignment, EKFGPSSLAM.py:325-387): segments split
    at gaps > cfg.max_gps_gap_threshold; not-a-knot cubic for segments of ≥4
    points, linear for 2-3; timestamps outside every segment are invalid.

    ``spline_solver``: "dense", "tridiagonal" or "auto" (tridiagonal for
    ≥256 GPS samples). ``assume_sorted``: the VALID GPS timestamps are
    nondecreasing (callers verify on the host), which skips the sort.
    """
    dtype = torch.promote_types(torch.promote_types(slam_times.dtype, gps_times.dtype), torch.float32)
    slam_times = slam_times.to(dtype)
    gps_times = gps_times.to(dtype)
    gps_positions = gps_positions.to(dtype)
    if gps_valid is None:
        gps_valid = torch.ones(gps_times.shape, dtype=torch.bool, device=gps_times.device)

    t, p, n_eff = _compact_sort(
        gps_times + time_offset, gps_positions, gps_valid, assume_sorted=assume_sorted
    )
    (
        seg_id, is_real, seg_start_idx, seg_end_idx, seg_start_t, seg_end_t, seg_len, seg_ok
    ) = _segment_structure(t, n_eff, cfg.max_gps_gap_threshold)

    if spline_solver == "auto":
        spline_solver = "tridiagonal" if gps_times.shape[0] >= 256 else "dense"
    moments_fn = (
        _notaknot_moments_tridiag if spline_solver == "tridiagonal" else _notaknot_moments
    )
    moments = moments_fn(t, p, seg_id, is_real, seg_start_idx, seg_end_idx, seg_len, seg_ok)

    m = t.shape[0]
    j = torch.searchsorted(t, slam_times, right=True) - 1
    j = torch.clamp(j, 0, m - 1)
    # A timestamp equal to a segment's last knot evaluates on the interval
    # to its LEFT (the bracketing interval crosses the gap).
    j_eval = torch.where((j == seg_end_idx[j]) & (j > seg_start_idx[j]), j - 1, j)
    j_eval = torch.clamp(j_eval, 0, max(m - 2, 0))
    j_next = torch.clamp(j_eval + 1, 0, m - 1)
    len_j = seg_len[j]
    start_t_j, end_t_j = seg_start_t[j], seg_end_t[j]
    ok_j, real_j = seg_ok[j], is_real[j]
    t0 = t[j_eval]
    t1 = t[j_next]
    y0 = torch.where(torch.isfinite(p[j_eval]), p[j_eval], 0.0)
    y1 = torch.where(torch.isfinite(p[j_next]), p[j_next], 0.0)
    m0 = moments[j_eval]
    m1 = moments[j_next]

    h = t1 - t0
    h_safe = torch.where((h > 0) & torch.isfinite(h), h, 1.0)
    u = (slam_times - t0)[:, None]
    v = (t1 - slam_times)[:, None]
    hh = h_safe[:, None]
    cubic_val = (
        m0 * v**3 / (6.0 * hh)
        + m1 * u**3 / (6.0 * hh)
        + (y0 / hh - m0 * hh / 6.0) * v
        + (y1 / hh - m1 * hh / 6.0) * u
    )
    linear_val = y0 + (y1 - y0) * (u / hh)
    aligned = torch.where((len_j >= 4)[:, None], cubic_val, linear_val)

    valid = (
        (slam_times >= t[0])
        & (slam_times >= start_t_j)
        & (slam_times <= end_t_j)
        & ok_j
        & real_j
    )
    aligned = torch.where(valid[:, None], aligned, float("nan"))
    return AlignedGPS(aligned=aligned, valid=valid)


def sim3_window_mask(
    slam_times: torch.Tensor,
    valid: torch.Tensor,
    gap_threshold: float,
    max_duration: float,
    min_samples: int,
) -> torch.Tensor:
    """SLAM indices used for the Sim3 fit (reference EKFGPSSLAM.py:977-998):
    the first gap-free run of GPS-valid timestamps, truncated to
    ``max_duration`` seconds, with the reference's fallbacks (first run
    shorter than min_samples → all valid points; truncated window shorter
    → the whole first run). ``slam_times`` must be time-ordered."""
    n_valid = torch.sum(valid)
    rank = torch.cumsum(valid.long(), 0)  # 1-based among valid points
    t_masked = torch.where(valid, slam_times, -_INF)
    prev_t = torch.cat(
        [_full((1,), -_INF, slam_times), torch.cummax(t_masked, 0).values[:-1]]
    )
    gap_pair = valid & (rank >= 2) & ((slam_times - prev_t) > gap_threshold)
    big = 2**31 - 1
    first_gap_rank = torch.min(torch.where(gap_pair, rank, big))
    # The reference slices valid_indices[:first_gap_idx] (EKFGPSSLAM.py:982-984):
    # the gap pair's LEFT point is excluded.
    run_len = torch.minimum(first_gap_rank - 2, n_valid)
    run_start_t = torch.min(torch.where(valid, slam_times, _INF))
    at_end = valid & (rank == run_len)
    run_end_t = torch.max(torch.where(at_end, slam_times, -_INF))
    in_first_run = valid & (slam_times <= run_end_t)
    timed = in_first_run & (slam_times <= run_start_t + max_duration)
    use_all = torch.sum(in_first_run) < min_samples
    use_run = (~use_all) & (torch.sum(timed) < min_samples)
    return torch.where(use_all, valid, torch.where(use_run, in_first_run, timed))
